"""Evrard adiabatic collapse initial conditions.

Counterpart of sphexa_tpu/init/evrard.py (reference: main/src/init/
evrard_init.hpp): a cold gas sphere with rho ~ 1/r collapses under
self-gravity. The 1/r profile comes from the sqrt-contraction of a
uniform sphere cut from a cubic lattice (contractRhoProfile)."""

from __future__ import annotations

import numpy as np

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.init.grid import regular_grid
from sphexa_tpu_torch.sfc.box import Box, Boundary
from sphexa_tpu_torch.sph.eos import ideal_gas_cv
from sphexa_tpu_torch.state import make_particles, make_state
from sphexa_tpu_torch.util.device import resolve_device


def evrard_constants() -> dict:
    return dict(gravConstant=1.0, r=1.0, mTotal=1.0, gamma=5.0 / 3.0,
                u0=0.05, minDt=1e-4, mui=10.0, ng0=100, ngmax=150)


def init_evrard(side: int, cfg: SphConfig, capacity: int | None = None,
                dt0: float | None = None, device=None):
    """Returns (SimState, Box, cfg'): the sphere cut from a side^3
    lattice on [-1, 1)^3, in an open cube, with gravG = 1. The state
    lives on `device` (default: the GPU)."""
    device = resolve_device(device)
    const = evrard_constants()
    r = const["r"]

    # uniform sphere from a cube lattice, then contract radii:
    # new_r / old_r = sqrt(old_r / R), so rho ~ 1/r
    x0, y0, z0 = regular_grid(r, side)
    rad = np.sqrt(x0 ** 2 + y0 ** 2 + z0 ** 2)
    keep = (rad <= r) & (rad > 0)
    x0, y0, z0, rad = x0[keep], y0[keep], z0[keep], rad[keep]
    scale = np.sqrt(rad / r)
    x, y, z = x0 * scale, y0 * scale, z0 * scale
    n = x.size

    m_part = const["mTotal"] / n
    total_volume = 4 * np.pi / 3 * r ** 3
    c0 = 2.0 / 3.0 * n / total_volume  # local concentration = c0 / r
    r_new = np.maximum(np.sqrt(x ** 2 + y ** 2 + z ** 2), 1e-6)
    conc = c0 / r_new
    h = np.cbrt(3.0 / (4 * np.pi) * cfg.ng0 / conc) * 0.5

    cv = ideal_gas_cv(const["mui"], const["gamma"])
    temp0 = const["u0"] / cv
    dt_init = dt0 if dt0 is not None else const["minDt"]

    cfg = cfg.replace(gamma=const["gamma"], mui=const["mui"],
                      gravG=const["gravConstant"])
    ps = make_particles(capacity or n, n, device=device, x=x, y=y, z=z,
                        temp=np.full(n, temp0), h=h,
                        m=np.full(n, m_part), alpha=np.full(n, cfg.alphamin))
    box = Box.cube(-r, r, Boundary.open)
    return make_state(ps, dt0=dt_init), box, cfg
