"""Smoothing-kernel definitions and normalization.

Counterpart of sphexa_tpu/sph/kernels.py (reference: kernels.hpp:11-32,
sph_kernel_tables.hpp): the analytic sinc^n kernel as a polynomial in
v^2 (w_sinc, w_sinc_derivative: the gather path's pair stages), its
3D normalization, the h controller, the Courant time, the std
formulation's pair artificial viscosity, and the kernel and its
derivative in float64 on the host (the normalization, the glass
relaxation). The polynomial coefficients here are also written into the
CUDA kernels' generated header (ops/_cuda.py), so the two cannot drift
apart.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sphexa_tpu_torch.util.fp import rdiv

SUPPORT = 2.0  # kernel support in units of h


def wharmonic_np(v):
    """sinc(pi/2 * v), float64 numpy (host)."""
    v = np.asarray(v, dtype=np.float64)
    pv = (np.pi / 2.0) * v
    with np.errstate(invalid="ignore", divide="ignore"):
        w = np.where(v == 0.0, 1.0, np.sin(pv) / pv)
    return w


def wharmonic_derivative_np(v):
    """d/dv sinc(pi/2 * v), float64 numpy (host)."""
    v = np.asarray(v, dtype=np.float64)
    pv = (np.pi / 2.0) * v
    with np.errstate(invalid="ignore", divide="ignore"):
        sinc = np.where(v == 0.0, 1.0, np.sin(pv) / pv)
        d = sinc * (np.pi / 2.0) * (np.cos(pv) / np.sin(pv) - 1.0 / pv)
    return np.where(v == 0.0, 0.0, d)


def simpson(a: float, b: float, n: int, func) -> float:
    """Simpson quadrature with sorted-summand accumulation
    (sph_kernel_tables.hpp:28-56)."""
    h = (b - a) / n
    xs = a + h * np.arange(1, n)
    samples = func(xs)
    odd = np.sort(samples[0::2])
    even = np.sort(samples[1::2])
    return h / 3.0 * (func(np.array([a]))[0] + func(np.array([b]))[0]
                      + 4.0 * odd.sum() + 2.0 * even.sum())


@functools.lru_cache(maxsize=None)
def kernel_3d_k(sinc_index: float, support: float = SUPPORT) -> float:
    """3D normalization constant 1 / int_0^s 4 pi x^2 W(x) dx."""
    def vol(x):
        return 4.0 * np.pi * x * x * wharmonic_np(x) ** sinc_index
    return 1.0 / simpson(0.0, support, 2000, vol)


@functools.lru_cache(maxsize=None)
def make_tables(sinc_index: float, table_size: int = 20000):
    """W(v) = sinc(pi v/2)^n and dW/dv tabulated at table_size points on
    [0, support], as float32 numpy arrays (host)."""
    v = np.linspace(0.0, SUPPORT, table_size)
    w = wharmonic_np(v) ** sinc_index
    wd = (sinc_index * wharmonic_np(v) ** (sinc_index - 1.0)
          * wharmonic_derivative_np(v))
    return w.astype(np.float32), wd.astype(np.float32)


def table_lookup(table, v):
    """Linear interpolation in a table of make_tables, the reference's
    lt::lookup (table_lookup.hpp:14-26): zero at or past the support."""
    table = torch.as_tensor(table, device=v.device)
    num_intervals = table.shape[0] - 1
    idxf = v * (num_intervals / SUPPORT)
    idx = torch.clamp(idxf.to(torch.int32), 0, num_intervals - 1).long()
    lo, hi = table[idx], table[idx + 1]
    out = lo + (hi - lo) * (idxf - idx.to(v.dtype))
    return torch.where(idxf < num_intervals, out, torch.zeros_like(out))


def _pow_int(x, n: int):
    """x**n by binary multiplication for small integer n."""
    result = None
    base = x
    while n > 0:
        if n & 1:
            result = base if result is None else result * base
        base = base * base
        n >>= 1
    return result


# Degree-6 polynomials in v^2 for sinc(pi v/2) and (d sinc/dv)/v on
# [0, 2]: max error ~2e-9, below fp32 resolution.
_SINC_COEF = (0.9999999994767121, -0.4112335029385433, 0.05073384282987128,
              -0.002980403757215835, 0.00010206937256680724,
              -2.263662159341907e-06, 3.090834479517968e-08)
_DSINC_OVER_V_COEF = (-0.8224670332327884, 0.2029356039981833,
                      -0.017882974714120713, 0.0008171065849809642,
                      -2.2900667062091163e-05, 4.308552351132641e-07,
                      -5.184117393639658e-09)


def _poly_even(v2, coef):
    acc = coef[-1]
    for c in reversed(coef[:-1]):
        acc = acc * v2 + c
    return acc


def exp_pair(x):
    """(e^x, e^-x) for |x| <= ~0.6 via an even/odd degree-6 Taylor split,
    used by the equal-mass Atwood ramp of the momentum stage."""
    x2 = x * x
    even = 1.0 + x2 * (0.5 + x2 * (1.0 / 24.0 + x2 * (1.0 / 720.0)))
    odd = x * (1.0 + x2 * (1.0 / 6.0 + x2 * (1.0 / 120.0)))
    return even + odd, even - odd


def w_sinc(v, sinc_index: float = 6.0):
    """W(v) = sinc(pi/2 v)^n; zero outside the support."""
    n_int = int(sinc_index)
    if float(n_int) == float(sinc_index) and 1 <= n_int <= 16:
        w = _pow_int(_poly_even(v * v, _SINC_COEF), n_int)
    else:
        pv = (np.pi / 2.0) * v
        small = v <= 1e-12
        safe = torch.where(small, torch.ones_like(pv), pv)
        sinc = torch.where(small, torch.ones_like(pv), torch.sin(safe) / safe)
        w = torch.pow(torch.clamp_min(sinc, 0.0), sinc_index)
    return torch.where(v < SUPPORT, w, torch.zeros_like(w))


def w_sinc_derivative(v, sinc_index: float = 6.0):
    """dW/dv from the fitted (dsinc/dv)/v polynomial (the closed form
    cancels catastrophically in float32 at small v)."""
    v2 = v * v
    sinc = _poly_even(v2, _SINC_COEF)
    dsinc = v * _poly_even(v2, _DSINC_OVER_V_COEF)
    n_int = int(sinc_index)
    if float(n_int) == float(sinc_index) and 2 <= n_int <= 16:
        wnm1 = _pow_int(sinc, n_int - 1)
    else:
        wnm1 = torch.pow(torch.clamp_min(sinc, 0.0), sinc_index - 1.0)
    d = sinc_index * wnm1 * dsinc
    return torch.where(v < SUPPORT, d, torch.zeros_like(d))


def artificial_viscosity(alpha_i, alpha_j, c_i, c_j, w_ij):
    """Pair AV from the alpha-weighted signal velocity, beta = 2
    (kernels.hpp:71-84)."""
    beta = 2.0
    vij_signal = (alpha_i + alpha_j) / 4.0 * (c_i + c_j) - beta * w_ij
    return torch.where(w_ij < 0.0, -vij_signal * w_ij, 0.0)


def update_h(ng0: int, nc, h, h_cap: float = 0.0):
    """nc -> h controller: h * 0.5 * (1 + 1023 * ng0/nc)^(1/10)
    (kernels.hpp:27-32); h_cap > 0 bounds it from above."""
    c0 = 1023.0
    nc_safe = torch.clamp_min(nc.to(h.dtype), 1.0)
    h_new = h * 0.5 * torch.pow(1.0 + rdiv(c0 * ng0, nc_safe), 0.1)
    if h_cap > 0.0:
        h_new = torch.clamp_max(h_new, float(np.float32(h_cap)))
    return h_new


def ts_k_courant(maxvsignal, h, c, kcour: float):
    """Courant dt from the signal velocity (kernels.hpp:11-16)."""
    v = torch.where(maxvsignal > 0.0, maxvsignal, c)
    return kcour * h / v
