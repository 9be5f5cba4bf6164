"""Subsonic turbulence box initial conditions.

Counterpart of sphexa_tpu/init/turbulence.py (reference: main/src/init/
turbulence_init.hpp): uniform, nearly isothermal gas (gamma 1.001) at
rest in a periodic unit box, driven by the OU stirring of
physics/turbulence.py."""

from __future__ import annotations

import numpy as np

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.init.grid import initial_h, regular_grid
from sphexa_tpu_torch.physics.turbulence import turbulence_constants
from sphexa_tpu_torch.sfc.box import Box, Boundary
from sphexa_tpu_torch.sph.eos import ideal_gas_cv
from sphexa_tpu_torch.state import make_particles, make_state
from sphexa_tpu_torch.util.device import resolve_device


def init_turbulence(side: int, cfg: SphConfig, capacity: int | None = None,
                    dt0: float | None = None, device=None):
    """Returns (SimState, Box, cfg') on `device` (default: the GPU)."""
    device = resolve_device(device)
    const = turbulence_constants()
    L = const["Lbox"]
    n = side ** 3
    x, y, z = regular_grid(L / 2, side)

    m_part = const["mTotal"] / n
    h0 = initial_h(cfg.ng0, L ** 3, n)
    cv = ideal_gas_cv(const["mui"], const["gamma"])
    temp0 = const["u0"] / cv
    dt_init = dt0 if dt0 is not None else const["minDt"]

    cfg = cfg.replace(gamma=const["gamma"], mui=const["mui"],
                      kcour=const["kcour"])
    ps = make_particles(capacity or n, n, device=device, x=x, y=y, z=z,
                        temp=np.full(n, temp0), h=np.full(n, h0),
                        m=np.full(n, m_part), alpha=np.full(n, cfg.alphamin))
    box = Box.cube(-L / 2, L / 2, Boundary.periodic)
    return make_state(ps, dt0=dt_init), box, cfg
