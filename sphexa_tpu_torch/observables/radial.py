"""Radial profile extraction and L1 comparison utilities
(reference: main/src/analytical_solutions/compare_solutions.py:85
computeL1Error — the physics acceptance metric).

The port's own copy of sphexa_tpu/observables/radial.py (numpy only)."""

from __future__ import annotations

import numpy as np


def radial_profile(x, y, z, values, nbins: int = 50, rmax: float | None = None):
    """Mass-less radial binning: returns (bin centers, mean value per bin,
    counts)."""
    r = np.sqrt(np.asarray(x) ** 2 + np.asarray(y) ** 2 + np.asarray(z) ** 2)
    rmax = rmax or float(r.max())
    edges = np.linspace(0.0, rmax, nbins + 1)
    idx = np.clip(np.digitize(r, edges) - 1, 0, nbins - 1)
    counts = np.bincount(idx, minlength=nbins)
    sums = np.bincount(idx, weights=np.asarray(values, np.float64),
                       minlength=nbins)
    mean = np.where(counts > 0, sums / np.maximum(counts, 1), np.nan)
    centers = 0.5 * (edges[:-1] + edges[1:])
    return centers, mean, counts


def l1_error(simulated, analytical):
    """L1 = mean |sim - ana| / mean |ana| over valid bins
    (reference: compare_solutions.py computeL1Error)."""
    sim = np.asarray(simulated, np.float64)
    ana = np.asarray(analytical, np.float64)
    ok = np.isfinite(sim) & np.isfinite(ana)
    return float(np.abs(sim[ok] - ana[ok]).mean()
                 / max(np.abs(ana[ok]).mean(), 1e-300))


def shock_radius_from_density(x, y, z, rho, nbins: int = 64,
                              rmax: float | None = None):
    """Locate the shock as the radius of peak binned density."""
    centers, mean, counts = radial_profile(x, y, z, rho, nbins, rmax)
    valid = counts > 3
    i = np.nanargmax(np.where(valid, mean, -np.inf))
    return float(centers[i]), float(mean[i])
