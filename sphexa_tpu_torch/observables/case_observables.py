"""Case-specific observables (reference: main/src/observables/:
turbulence Mach RMS, KH growth rate, wind-bubble survival).

Counterpart of sphexa_tpu/observables/case_observables.py."""

from __future__ import annotations

import numpy as np
import torch

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.sph.eos import ideal_gas_cv
from sphexa_tpu_torch.state import Particles
from sphexa_tpu_torch.util.device import host


def turbulence_mach_rms(ps: Particles, cfg: SphConfig) -> float:
    """RMS Mach number (reference: observables/turbulence_mach_rms.hpp),
    c^2 = gamma (gamma-1) cv temp."""
    alive = ps.alive
    v2 = ps.vx ** 2 + ps.vy ** 2 + ps.vz ** 2
    cv = ideal_gas_cv(cfg.mui, cfg.gamma)
    c2 = cfg.gamma * (cfg.gamma - 1.0) * cv * ps.temp
    mach2 = torch.where(alive, v2 / torch.clamp_min(c2, 1e-30), 0.0)
    n = torch.clamp_min(torch.sum(alive), 1)
    return float(torch.sqrt(torch.sum(mach2) / n))


def kelvin_helmholtz_growth_rate(ps: Particles, cfg: SphConfig,
                                 ymin: float = 0.25, ymax: float = 0.75):
    """Mode-1 amplitude of the vy perturbation inside the dense band, the
    KH growth diagnostic (observables/time_energy_growth.hpp computes an
    equivalent projection). Host numpy, as in the JAX package."""
    alive = host(ps.alive)
    x = host(ps.x)[alive]
    y = host(ps.y)[alive]
    vy = host(ps.vy)[alive]
    band = (y > ymin) & (y < ymax)
    if band.sum() == 0:
        return 0.0
    si = np.sin(4 * np.pi * x[band])
    ci = np.cos(4 * np.pi * x[band])
    s = (vy[band] * si).mean()
    c = (vy[band] * ci).mean()
    return float(2.0 * np.sqrt(s * s + c * c))


def wind_bubble_survival(ps: Particles, cfg: SphConfig, rho,
                         rho_threshold: float = 6.4):
    """Fraction of the alive particles above a density threshold
    (reference: observables/wind_bubble_fraction.hpp); the caller passes
    the current density field."""
    alive = host(ps.alive)
    dense = host(rho)[alive] > rho_threshold
    return float(dense.mean())
