"""Float32 arithmetic that keeps the JAX package's rounding.

`s / t` with a Python scalar `s` is computed by PyTorch as
`reciprocal(t) * s`, two roundings where XLA does one. `rdiv` divides
for real, through a 0-dim CPU tensor (which PyTorch accepts beside a
tensor on any device)."""

from __future__ import annotations

import torch


def rdiv(s: float, t: torch.Tensor) -> torch.Tensor:
    """s / t, correctly rounded in t's dtype."""
    return torch.tensor(s, dtype=t.dtype) / t
