"""Sedov-Taylor point explosion initial conditions.

Counterpart of sphexa_tpu/init/sedov.py (reference: main/src/init/
sedov_init.hpp:48-133, sedov_constants.hpp): a Gaussian energy spike of
width 0.1 in a periodic unit box of uniform density."""

from __future__ import annotations

import numpy as np
import torch

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.init.grid import initial_h, regular_grid
from sphexa_tpu_torch.sfc.box import Box, Boundary
from sphexa_tpu_torch.sph.eos import ideal_gas_cv
from sphexa_tpu_torch.state import make_particles, make_state
from sphexa_tpu_torch.util.device import resolve_device


def sedov_constants() -> dict:
    c = dict(dim=3, gamma=5.0 / 3.0, omega=0.0, r0=0.0, r1=0.5, mTotal=1.0,
             energyTotal=1.0, width=0.1, rho0=1.0, u0=1e-8, p0=0.0, vr0=0.0,
             cs0=0.0, minDt=1e-6, minDt_m1=1e-6, gravConstant=0.0,
             ng0=100, ngmax=150, mui=10.0)
    c["ener0"] = c["energyTotal"] / np.pi ** 1.5 / c["width"] ** 3
    return c


def init_sedov(side: int, cfg: SphConfig, capacity: int | None = None,
               dt0: float | None = None, device=None):
    """Returns (SimState, Box, cfg'). The state lives on `device`
    (default: the GPU)."""
    device = resolve_device(device)
    const = sedov_constants()
    r = const["r1"]
    n_global = side ** 3
    x, y, z = regular_grid(r, side)

    h0 = initial_h(cfg.ng0, (2 * r) ** 3, n_global)
    m_part = const["mTotal"] / n_global

    cv = ideal_gas_cv(const["mui"], const["gamma"])
    r2 = x ** 2 + y ** 2 + z ** 2
    u = const["ener0"] * np.exp(-r2 / const["width"] ** 2) + const["u0"]
    temp = u / cv

    cfg = cfg.replace(uniform_mass=True,
                      gamma=const["gamma"], mui=const["mui"],
                      ng0=int(const["ng0"]), ngmax=int(const["ngmax"]))

    cap = capacity or n_global
    ps = make_particles(
        cap, n_global, device=device, x=x, y=y, z=z, temp=temp,
        h=np.full(n_global, h0), m=np.full(n_global, m_part),
        alpha=np.full(n_global, cfg.alphamin))
    if cap > n_global:
        # padding rows: benign geometry (h=1 keeps 1/h finite)
        pad = torch.arange(cap, device=device) >= n_global
        ps = ps.replace(h=torch.where(pad, torch.ones_like(ps.h), ps.h),
                        temp=torch.where(pad, torch.full_like(ps.temp, 1e-10),
                                         ps.temp))

    box = Box.cube(-r, r, Boundary.periodic)
    return make_state(ps, dt0=dt0 if dt0 is not None else const["minDt"]), box, cfg
