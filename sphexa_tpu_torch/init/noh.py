"""Noh spherical implosion initial conditions.

Counterpart of sphexa_tpu/init/noh.py (reference: main/src/init/
noh_init.hpp:44-100): radial inflow v_r = -1 onto the origin in an open
box, the wall-shock benchmark with a closed-form solution
(observables/noh_solution.py)."""

from __future__ import annotations

import numpy as np

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.init.grid import regular_grid
from sphexa_tpu_torch.sfc.box import Box, Boundary
from sphexa_tpu_torch.sph.eos import ideal_gas_cv
from sphexa_tpu_torch.state import make_particles, make_state
from sphexa_tpu_torch.util.device import resolve_device


def noh_constants() -> dict:
    return dict(r0=0.0, r1=0.5, mTotal=1.0, dim=3, gamma=5.0 / 3.0,
                rho0=1.0, u0=1e-20, p0=0.0, vr0=-1.0, cs0=0.0,
                minDt=1e-4, gravConstant=0.0, ng0=100, ngmax=150, mui=10.0)


def init_noh(side: int, cfg: SphConfig, capacity: int | None = None,
             dt0: float | None = None, device=None):
    """Returns (SimState, Box, cfg') on `device` (default: the GPU)."""
    device = resolve_device(device)
    const = noh_constants()
    r = const["r1"]
    n = side ** 3
    x, y, z = regular_grid(r, side)

    total_volume = 4.0 * np.pi / 3.0 * r ** 3
    h0 = float(np.cbrt(3.0 / (4 * np.pi) * cfg.ng0 * total_volume / n) * 0.5)
    m_part = const["mTotal"] / n

    cv = ideal_gas_cv(const["mui"], const["gamma"])
    radius = np.maximum(np.sqrt(x ** 2 + y ** 2 + z ** 2), 1e-10)
    vx = const["vr0"] * x / radius
    vy = const["vr0"] * y / radius
    vz = const["vr0"] * z / radius
    dt_init = dt0 if dt0 is not None else const["minDt"]

    cfg = cfg.replace(gamma=const["gamma"], mui=const["mui"])
    ps = make_particles(
        capacity or n, n, device=device, x=x, y=y, z=z, vx=vx, vy=vy, vz=vz,
        x_m1=vx * dt_init, y_m1=vy * dt_init, z_m1=vz * dt_init,
        temp=np.full(n, const["u0"] / cv), h=np.full(n, h0),
        m=np.full(n, m_part), alpha=np.full(n, cfg.alphamin))
    box = Box.cube(-r, r, Boundary.open)
    return make_state(ps, dt0=dt_init), box, cfg
