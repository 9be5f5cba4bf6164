"""Noh implosion closed-form solution (reference: main/src/
analytical_solutions/compare_noh.py:49-98).

Counterpart of sphexa_tpu/observables/noh_solution.py. Spherical Noh
with v0 = -1, rho0 = 1, p0 = 0:
  shock speed   u_s = (gamma-1)/2
  post-shock    rho = rho0 ((gamma+1)/(gamma-1))^3, u = 0,
                p   = (gamma-1) rho_post v0^2 / 2
  pre-shock     rho = rho0 (1 + |v0| t / r)^2, u = v0, p ~ 0
"""

from __future__ import annotations

import numpy as np


def noh_profile(r, t: float, gamma: float, rho0: float = 1.0,
                v0: float = -1.0):
    """Exact (rho, u_r, p) at radii r, time t (numpy float64)."""
    r = np.asarray(r, np.float64)
    us = 0.5 * (gamma - 1.0) * abs(v0)
    rs = us * t
    rho_post = rho0 * ((gamma + 1.0) / (gamma - 1.0)) ** 3
    p_post = 0.5 * (gamma - 1.0) * rho_post * v0 * v0

    inside = r < rs
    safe_r = np.maximum(r, 1e-12)
    rho_pre = rho0 * (1.0 + abs(v0) * t / safe_r) ** 2
    rho = np.where(inside, rho_post, rho_pre)
    u = np.where(inside, 0.0, v0)
    p = np.where(inside, p_post, 0.0)
    return rho, u, p
