"""Equations of state.

Counterpart of sphexa_tpu/sph/eos.py (reference: eos.hpp:13-60,
hydro_ve/eos.hpp:52-77)."""

from __future__ import annotations

import torch

R_GAS = 8.317e7


def ideal_gas_cv(mui, gamma):
    return R_GAS / mui / (gamma - 1.0)


def ideal_gas_eos(temp, rho, mui, gamma):
    """Returns (pressure, sound speed)."""
    tmp = ideal_gas_cv(mui, gamma) * temp * (gamma - 1.0)
    return rho * tmp, torch.sqrt(tmp)


def eos_ve(temp, m, kx, xm, gradh, mui, gamma):
    """VE equation of state: rho from the VE normalization, and
    prho = p / (kx m^2 gradh) for the momentum stage."""
    rho = kx * m / xm
    p, c = ideal_gas_eos(temp, rho, mui, gamma)
    prho = p / (kx * m * m * gradh)
    return rho, p, c, prho


def polytropic_eos(rho):
    """1.4 M_sun / 12.8 km neutron-star polytrope (eos.hpp:50-60)."""
    kpol = 2.246341237993810232e-10
    gammapol = 3.0
    p = kpol * torch.pow(rho, gammapol)
    return p, torch.sqrt(gammapol * p / rho)


def eos_std(temp, rho, mui, gamma):
    """std-SPH ideal-gas EOS on the precomputed density."""
    return ideal_gas_eos(temp, rho, mui, gamma)
