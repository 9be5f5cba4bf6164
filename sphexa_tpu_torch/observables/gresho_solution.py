"""Gresho-Chan vortex analytic profiles and L1 comparator (reference:
main/src/analytical_solutions/compare_gresho_chan.py:58-110).

Counterpart of sphexa_tpu/observables/gresho_solution.py: the stationary
triangular vortex v_t(r) = r/R1 for r < R1, 2 - r/R1 for R1 <= r < 2 R1,
0 beyond."""

from __future__ import annotations

import numpy as np


def analytic_vt(radius, r1: float = 0.2):
    psi = np.asarray(radius) / r1
    return np.where(psi <= 1.0, psi,
                    np.where(psi <= 2.0, 2.0 - psi, 0.0))


def tangential_velocity(x, y, vx, vy):
    """2D radii and tangential speed (the reference compares |v_xy|,
    compare_gresho_chan.py:67-76)."""
    radii = np.sqrt(np.asarray(x) ** 2 + np.asarray(y) ** 2)
    vt = np.sqrt(np.asarray(vx) ** 2 + np.asarray(vy) ** 2)
    return radii, vt


def l1_error(radii, vt, r1: float = 0.2):
    """Mean absolute deviation from the analytic vortex
    (computeL1Error, compare_gresho_chan.py:79-80)."""
    return float(np.abs(np.asarray(vt) - analytic_vt(radii, r1)).mean())
