"""Wind-shock (blob) test initial conditions.

Counterpart of sphexa_tpu/init/wind_shock.py (reference: main/src/init/
wind_shock_init.hpp): a dense sphere (rho 10) in a supersonic wind
(rho 1, vx 2.7) inside the elongated periodic box [0,8r]x[0,2r]x[0,2r];
measures cloud survival (observables/factory.WindBubbleObs). Both
regions are glass-tiled where the box hosts whole template blocks, else
lattices."""

from __future__ import annotations

import numpy as np

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.init.lattice import h_from_density
from sphexa_tpu_torch.sfc.box import Box, Boundary
from sphexa_tpu_torch.sph.eos import ideal_gas_cv
from sphexa_tpu_torch.state import make_particles, make_state
from sphexa_tpu_torch.util.device import resolve_device


def wind_shock_constants() -> dict:
    return dict(r=0.125, rSphere=0.025, rhoInt=10.0, rhoExt=1.0,
                uExt=1.5, vxExt=2.7, vyExt=0.0, vzExt=0.0, dim=3,
                gamma=5.0 / 3.0, minDt=1e-10, kcour=0.4, mui=10.0,
                gravConstant=0.0, ng0=100, ngmax=150)


def init_wind_shock(side: int, cfg: SphConfig, capacity: int | None = None,
                    dt0: float | None = None, glass: bool = True,
                    device=None):
    """Returns (SimState, Box, cfg') on `device` (default: the GPU)."""
    device = resolve_device(device)
    const = wind_shock_constants()
    r = const["r"]
    rs = const["rSphere"]
    rho_i, rho_e = const["rhoInt"], const["rhoExt"]
    cx = (r, r, r)  # blob center

    def lattice(nx, ny, nz, lo, hi):
        gs = [lo[d] + (np.arange((nx, ny, nz)[d]) + 0.5)
              * (hi[d] - lo[d]) / (nx, ny, nz)[d] for d in range(3)]
        Z, Y, X = np.meshgrid(gs[2], gs[1], gs[0], indexing="ij")
        return X.ravel(), Y.ravel(), Z.ravel()

    d_ext = 2 * r / side
    d_int = d_ext / (rho_i / rho_e) ** (1 / 3)

    if glass:
        try:
            # the reference's glass for both regions (wind, and the
            # blob at its finer spacing)
            from sphexa_tpu_torch.init.glass import glass_cuboid
            xw, yw, zw = glass_cuboid((0, 0, 0), (8 * r, 2 * r, 2 * r),
                                      d_ext)
            xb, yb, zb = glass_cuboid(
                (cx[0] - rs, cx[1] - rs, cx[2] - rs),
                (cx[0] + rs, cx[1] + rs, cx[2] + rs), d_int, seed=7)
        except (ValueError, ImportError):
            glass = False
    if not glass:
        xw, yw, zw = lattice(4 * side, side, side, (0, 0, 0),
                             (8 * r, 2 * r, 2 * r))
        nb = max(2, int(round(2 * rs / d_int)))
        xb, yb, zb = lattice(nb, nb, nb,
                             (cx[0] - rs, cx[1] - rs, cx[2] - rs),
                             (cx[0] + rs, cx[1] + rs, cx[2] + rs))

    # wind region: full box minus the blob sphere
    rw = np.sqrt((xw - cx[0]) ** 2 + (yw - cx[1]) ** 2 + (zw - cx[2]) ** 2)
    keep = rw > rs
    xw, yw, zw = xw[keep], yw[keep], zw[keep]
    # blob: clipped to the sphere (cutSphere, grid.hpp:268)
    rb = np.sqrt((xb - cx[0]) ** 2 + (yb - cx[1]) ** 2 + (zb - cx[2]) ** 2)
    inb = rb <= rs
    xb, yb, zb = xb[inb], yb[inb], zb[inb]

    x = np.concatenate([xw, xb])
    y = np.concatenate([yw, yb])
    z = np.concatenate([zw, zb])
    n = x.size
    in_blob = np.concatenate([np.zeros(xw.size, bool),
                              np.ones(xb.size, bool)])

    if glass:
        # uniform particle mass from the realized wind-region count
        v_wind = (8 * r) * (2 * r) * (2 * r) - 4.0 / 3.0 * np.pi * rs ** 3
        m_part = rho_e * v_wind / xw.size
    else:
        m_part = rho_e * d_ext ** 3
    h_i = h_from_density(cfg.ng0, m_part, rho_i)
    h_e = h_from_density(cfg.ng0, m_part, rho_e)
    h = np.where(in_blob, h_i, h_e)

    cv = ideal_gas_cv(const["mui"], const["gamma"])
    u_ext = const["uExt"]
    # pressure equilibrium: uInt = uExt * rhoExt / rhoInt
    u = np.where(in_blob, u_ext * rho_e / rho_i, u_ext)
    temp = u / cv
    vx = np.where(in_blob, 0.0, const["vxExt"])
    dt_init = dt0 if dt0 is not None else const["minDt"]

    cfg = cfg.replace(gamma=const["gamma"], mui=const["mui"],
                      kcour=const["kcour"])
    ps = make_particles(
        capacity or n, n, device=device, x=x, y=y, z=z, vx=vx,
        x_m1=vx * dt_init, temp=temp, h=h, m=np.full(n, m_part),
        alpha=np.full(n, cfg.alphamin))
    box = Box(0.0, 8 * r, 0.0, 2 * r, 0.0, 2 * r,
              Boundary.periodic, Boundary.periodic, Boundary.periodic)
    return make_state(ps, dt0=dt_init), box, cfg
