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
