"""Kelvin-Helmholtz shear instability initial conditions.

Counterpart of sphexa_tpu/init/kelvin_helmholtz.py (reference: main/src/
init/kelvin_helmholtz_init.hpp): a thin periodic slab [0,1]x[0,1]x
[0,0.0625] whose dense central band (rho 2) shears against the exterior
(rho 1), with a sinusoidal seed perturbation. The three y-layers are
tiled from a relaxed glass template (the inner band cbrt(2) finer) when
the box can host whole blocks; otherwise (thin z at low resolution)
lattices with a central band of double y-resolution. Particle mass is
uniform."""

from __future__ import annotations

import numpy as np

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.init.lattice import h_from_density
from sphexa_tpu_torch.sfc.box import Box, Boundary
from sphexa_tpu_torch.sph.eos import ideal_gas_cv
from sphexa_tpu_torch.state import make_particles, make_state
from sphexa_tpu_torch.util.device import resolve_device


def kelvin_helmholtz_constants() -> dict:
    return dict(rhoInt=2.0, rhoExt=1.0, vxExt=0.5, vxInt=-0.5,
                gamma=5.0 / 3.0, p=2.5, omega0=0.01, kcour=0.4,
                ng0=100, ngmax=150, minDt=1e-7, gravConstant=0.0, mui=10.0)


def _slab_lattice(nx, ny, nz, ylo, yhi, zmax):
    gx = (np.arange(nx) + 0.5) / nx
    gy = ylo + (np.arange(ny) + 0.5) * (yhi - ylo) / ny
    gz = (np.arange(nz) + 0.5) * zmax / nz
    Z, Y, X = np.meshgrid(gz, gy, gx, indexing="ij")
    return X.ravel(), Y.ravel(), Z.ravel()


def init_kelvin_helmholtz(side: int, cfg: SphConfig,
                          capacity: int | None = None,
                          dt0: float | None = None, glass: bool = True,
                          device=None):
    """side sets the exterior resolution along x. With glass=True the
    three y-layers are glass-tiled (kelvin_helmholtz_init.hpp:152-184);
    the lattice fallback doubles the band's y-resolution instead.
    Returns (SimState, Box, cfg') on `device` (default: the GPU)."""
    device = resolve_device(device)
    const = kelvin_helmholtz_constants()
    zmax = 0.0625
    nz = max(2, int(round(side * zmax)))
    rho_i, rho_e = const["rhoInt"], const["rhoExt"]
    d_ext = 1.0 / side

    if glass:
        try:
            from sphexa_tpu_torch.init.glass import glass_cuboid
            d_int = d_ext / (rho_i / rho_e) ** (1.0 / 3.0)
            x1, y1, z1 = glass_cuboid((0, 0, 0), (1, 0.25, zmax), d_ext)
            x3, y3, z3 = glass_cuboid((0, 0.75, 0), (1, 1.0, zmax), d_ext)
            x2, y2, z2 = glass_cuboid((0, 0.25, 0), (1, 0.75, zmax), d_int,
                                      seed=7)
        except (ValueError, ImportError):
            # the thin-z box cannot host glass blocks at this resolution
            glass = False
    if not glass:
        ny_ext = max(2, side // 4)
        x1, y1, z1 = _slab_lattice(side, ny_ext, nz, 0.0, 0.25, zmax)
        x3, y3, z3 = _slab_lattice(side, ny_ext, nz, 0.75, 1.0, zmax)
        x2, y2, z2 = _slab_lattice(side, 4 * ny_ext, nz, 0.25, 0.75, zmax)

    x = np.concatenate([x1, x2, x3])
    y = np.concatenate([y1, y2, y3])
    z = np.concatenate([z1, z2, z3])
    n = x.size

    if glass:
        # uniform particle mass from the realized exterior count
        m_part = rho_e * (2 * 0.25 * zmax) / (x1.size + x3.size)
    else:
        m_part = rho_e * d_ext ** 2 * (zmax / nz)
    h_i = h_from_density(cfg.ng0, m_part, rho_i)
    h_e = h_from_density(cfg.ng0, m_part, rho_e)

    inner = (y > 0.25) & (y < 0.75)
    cv = ideal_gas_cv(const["mui"], const["gamma"])
    u_i = const["p"] / ((const["gamma"] - 1.0) * rho_i)
    u_e = const["p"] / ((const["gamma"] - 1.0) * rho_e)
    temp = np.where(inner, u_i, u_e) / cv
    h = np.where(inner, h_i, h_e)

    v_dif = 0.5 * (const["vxExt"] - const["vxInt"])
    ls = 0.025
    vx_in = const["vxInt"] + v_dif * np.exp(
        np.where(y > 0.5, (y - 0.75) / ls, (0.25 - y) / ls))
    vx_out = const["vxExt"] - v_dif * np.exp(
        np.where(y > 0.5, (0.75 - y) / ls, (y - 0.25) / ls))
    vx = np.where(inner, vx_in, vx_out)
    vy = const["omega0"] * np.sin(4 * np.pi * x)
    dt_init = dt0 if dt0 is not None else const["minDt"]

    cfg = cfg.replace(gamma=const["gamma"], mui=const["mui"],
                      kcour=const["kcour"])
    ps = make_particles(
        capacity or n, n, device=device, x=x, y=y, z=z, vx=vx, vy=vy,
        x_m1=vx * dt_init, y_m1=vy * dt_init,
        temp=temp, h=h, m=np.full(n, m_part),
        alpha=np.full(n, cfg.alphamax))
    box = Box(0.0, 1.0, 0.0, 1.0, 0.0, zmax,
              Boundary.periodic, Boundary.periodic, Boundary.periodic)
    return make_state(ps, dt0=dt_init), box, cfg
