"""Lattice initial-condition helpers.

Counterpart of sphexa_tpu/init/grid.py (reference: main/src/init/
grid.hpp:101-132 regularGrid). Host numpy, float64."""

from __future__ import annotations

import numpy as np


def regular_grid(r: float, side: int):
    """Regular cubic lattice on [-r, r)^3, cell-centered, numpy fp64,
    in z-major order like the reference."""
    step = 2.0 * r / side
    g = -r + (np.arange(side) + 0.5) * step
    Z, Y, X = np.meshgrid(g, g, g, indexing="ij")
    return X.ravel(), Y.ravel(), Z.ravel()


def initial_h(ng0: int, total_volume: float, n_global: int) -> float:
    """h so a 2h sphere holds ~ng0 particles at uniform density
    (sedov_init.hpp:55)."""
    return float(np.cbrt(3.0 / (4 * np.pi) * ng0 * total_volume / n_global) * 0.5)
