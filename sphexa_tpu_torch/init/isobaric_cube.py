"""Isobaric cube initial conditions.

Counterpart of sphexa_tpu/init/isobaric_cube.py (reference: main/src/
init/isobaric_cube_init.hpp): a dense cube (rho 8) in pressure
equilibrium with its surroundings (rho 1, p 2.5) in a periodic box, a
contact-discontinuity noise test. The contrast comes from a lattice
twice as fine inside the cube; masses are uniform."""

from __future__ import annotations

import numpy as np

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.init.lattice import h_from_density
from sphexa_tpu_torch.sfc.box import Box, Boundary
from sphexa_tpu_torch.sph.eos import ideal_gas_cv
from sphexa_tpu_torch.state import make_particles, make_state
from sphexa_tpu_torch.util.device import resolve_device


def isobaric_cube_constants() -> dict:
    return dict(r=0.25, rDelta=0.25, dim=3, gamma=5.0 / 3.0, rhoExt=1.0,
                rhoInt=8.0, pIsobaric=2.5, minDt=1e-4, mui=10.0,
                gravConstant=0.0, ng0=100, ngmax=150)


def init_isobaric_cube(side: int, cfg: SphConfig, capacity: int | None = None,
                       dt0: float | None = None, device=None):
    """Returns (SimState, Box, cfg') on `device` (default: the GPU)."""
    device = resolve_device(device)
    const = isobaric_cube_constants()
    r = const["r"]                   # inner cube half-side
    L = 4 * r                        # box side (periodic, [-2r, 2r])
    rho_i, rho_e = const["rhoInt"], const["rhoExt"]

    def lattice(ns, lo, hi):
        g = lo + (np.arange(ns) + 0.5) * (hi - lo) / ns
        Z, Y, X = np.meshgrid(g, g, g, indexing="ij")
        return X.ravel(), Y.ravel(), Z.ravel()

    # exterior lattice without the inner cube; the interior spans half
    # the box with as many points a side: spacing d/2, density 8x
    xe, ye, ze = lattice(side, -2 * r, 2 * r)
    outside = np.maximum.reduce([np.abs(xe), np.abs(ye), np.abs(ze)]) > r
    xe, ye, ze = xe[outside], ye[outside], ze[outside]
    xi, yi, zi = lattice(side, -r, r)
    x = np.concatenate([xe, xi])
    y = np.concatenate([ye, yi])
    z = np.concatenate([ze, zi])
    n = x.size

    # uniform particle mass from the exterior density
    d_ext = L / side
    m_part = rho_e * d_ext ** 3
    h_i = h_from_density(cfg.ng0, m_part, rho_i)
    h_e = h_from_density(cfg.ng0, m_part, rho_e)
    inner = np.maximum.reduce([np.abs(x), np.abs(y), np.abs(z)]) <= r
    h = np.where(inner, h_i, h_e)

    cv = ideal_gas_cv(const["mui"], const["gamma"])
    u = (const["pIsobaric"] / (const["gamma"] - 1.0)
         / np.where(inner, rho_i, rho_e))
    temp = u / cv
    dt_init = dt0 if dt0 is not None else const["minDt"]

    cfg = cfg.replace(gamma=const["gamma"], mui=const["mui"])
    ps = make_particles(capacity or n, n, device=device, x=x, y=y, z=z,
                        temp=temp, h=h, m=np.full(n, m_part),
                        alpha=np.full(n, cfg.alphamin))
    box = Box.cube(-2 * r, 2 * r, Boundary.periodic)
    return make_state(ps, dt0=dt_init), box, cfg
