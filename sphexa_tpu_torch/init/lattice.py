"""Quasi-glass particle templates and cuboid tiling.

Counterpart of sphexa_tpu/init/lattice.py (reference: main/src/init/
grid.hpp:238 assembleCuboid): a deterministic jittered lattice as a
glass-block stand-in, the tiling of a unit-cube template over a box, and
the smoothing length of a density. Host numpy, float64.
"""

from __future__ import annotations

import numpy as np


def jittered_lattice(side: int, jitter: float = 0.2, seed: int = 42):
    """Unit-cube [0,1)^3 lattice of side^3 points with deterministic
    sub-cell jitter (a glass-block stand-in)."""
    rng = np.random.default_rng(seed)
    g = (np.arange(side) + 0.5) / side
    Z, Y, X = np.meshgrid(g, g, g, indexing="ij")
    n = side ** 3
    scale = jitter / side
    x = (X.ravel() + rng.uniform(-scale, scale, n)) % 1.0
    y = (Y.ravel() + rng.uniform(-scale, scale, n)) % 1.0
    z = (Z.ravel() + rng.uniform(-scale, scale, n)) % 1.0
    return x, y, z


def assemble_cuboid(template, multiplicity, lo, hi):
    """Tile a unit-cube template block m times per dimension into the
    box [lo, hi]^3 (reference: grid.hpp assembleCuboid)."""
    tx, ty, tz = template
    mx, my, mz = multiplicity
    xs, ys, zs = [], [], []
    for ix in range(mx):
        for iy in range(my):
            for iz in range(mz):
                xs.append((tx + ix) / mx)
                ys.append((ty + iy) / my)
                zs.append((tz + iz) / mz)
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    z = np.concatenate(zs)
    L = np.asarray(hi) - np.asarray(lo)
    return (lo[0] + x * L[0], lo[1] + y * L[1], lo[2] + z * L[2])


def h_from_density(ng0: int, m_part: float, rho: float) -> float:
    """h so a 2h sphere holds ~ng0 particles at density rho
    (reference: e.g. kelvin_helmholtz_init.hpp hInt/hExt)."""
    return 0.5 * np.cbrt(3.0 * ng0 * m_part / (4.0 * np.pi * rho))
