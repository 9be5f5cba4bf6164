"""Gresho-Chan vortex initial conditions.

Counterpart of sphexa_tpu/init/gresho_chan.py (reference: main/src/init/
gresho_chan.hpp): a rotating azimuthal velocity profile in pressure
equilibrium; tests angular-momentum conservation and AV noise."""

from __future__ import annotations

import numpy as np

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.init.grid import regular_grid
from sphexa_tpu_torch.init.lattice import h_from_density
from sphexa_tpu_torch.sfc.box import Box, Boundary
from sphexa_tpu_torch.sph.eos import ideal_gas_cv
from sphexa_tpu_torch.state import make_particles, make_state
from sphexa_tpu_torch.util.device import resolve_device


def gresho_chan_constants() -> dict:
    return dict(R1=0.2, v0=1.0, P0=5.0, gamma=5.0 / 3.0, mTotal=1.0,
                minDt=1e-7, rho=1.0, kcour=0.2, ng0=100, ngmax=150,
                gravConstant=0.0, mui=10.0)


def init_gresho_chan(side: int, cfg: SphConfig, capacity: int | None = None,
                     dt0: float | None = None, device=None):
    """Returns (SimState, Box, cfg') on `device` (default: the GPU)."""
    device = resolve_device(device)
    const = gresho_chan_constants()
    n = side ** 3
    # unit box [-0.5, 0.5]^3, rho = 1
    x, y, z = regular_grid(0.5, side)
    m_part = const["mTotal"] / n
    h0 = h_from_density(cfg.ng0, m_part, const["rho"])
    cv = ideal_gas_cv(const["mui"], const["gamma"])

    R1, v0, P0 = const["R1"], const["v0"], const["P0"]
    psi = np.sqrt(x ** 2 + y ** 2) / R1
    theta = np.arctan2(y, x)
    pi = np.where(psi <= 1.0, P0 + 4 * v0 * v0 * psi * psi / 8,
                  np.where(psi <= 2.0,
                           P0 + 4 * v0 * v0 * (psi ** 2 / 8 - psi
                                               + np.log(np.maximum(psi, 1e-10))
                                               + 1),
                           P0 + 4 * v0 * v0 * (np.log(2.0) - 0.5)))
    vi = np.where(psi <= 1.0, v0 * psi,
                  np.where(psi <= 2.0, v0 * (2.0 - psi), 0.0))
    temp = pi / ((const["gamma"] - 1.0) * const["rho"]) / cv
    vx = -vi * np.sin(theta)
    vy = vi * np.cos(theta)
    dt_init = dt0 if dt0 is not None else const["minDt"]

    cfg = cfg.replace(gamma=const["gamma"], mui=const["mui"],
                      kcour=const["kcour"])
    ps = make_particles(
        capacity or n, n, device=device, x=x, y=y, z=z, vx=vx, vy=vy,
        x_m1=vx * dt_init, y_m1=vy * dt_init,
        temp=temp, h=np.full(n, h0), m=np.full(n, m_part),
        alpha=np.full(n, cfg.alphamin))
    box = Box.cube(-0.5, 0.5, Boundary.periodic)
    return make_state(ps, dt0=dt_init), box, cfg
