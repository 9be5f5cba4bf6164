"""Compensated (Kahan/Neumaier) summation for conservation-grade fp32.

Counterpart of sphexa_tpu/util/kahan.py: the same pairwise two_sum
cascade over contiguous halves, so the energies carry the same digits
as the reference (a plain torch.sum changes them).
"""

from __future__ import annotations

import torch


def _two_sum(a, b):
    s = a + b
    bp = s - a
    err = (a - (s - bp)) + (b - bp)
    return s, err


def kahan_sum(x: torch.Tensor) -> torch.Tensor:
    """Compensated sum of all elements via a pairwise two_sum cascade
    (0-dim result)."""
    s = x.reshape(-1)
    e = torch.zeros_like(s)
    while s.shape[0] > 1:
        n = s.shape[0]
        if n % 2:
            s = torch.cat([s, s.new_zeros(1)])
            e = torch.cat([e, e.new_zeros(1)])
            n += 1
        n2 = n // 2
        s, err = _two_sum(s[:n2], s[n2:])
        e = e[:n2] + e[n2:] + err
    return (s + e)[0]


def kahan_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compensated dot product sum(a * b)."""
    return kahan_sum(a * b)
