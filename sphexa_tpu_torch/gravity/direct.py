"""Direct-sum N^2 gravity (reference: ryoanji/src/ryoanji/nbody/direct.cuh).

Counterpart of sphexa_tpu/gravity/direct.py: Plummer-softened all-pairs
forces and potential, chunked over targets to bound memory ([C, N]
tiles). For small frames and as the oracle of the tree solver; the
card's main path runs the FMM (gravity/fmm.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Gravity(NamedTuple):
    ax: torch.Tensor
    ay: torch.Tensor
    az: torch.Tensor
    pot: torch.Tensor  # per-particle potential (egrav = 0.5 sum m pot)


def chunk_rows(c: int, C: int, N: int, device):
    """Target rows of chunk c, the tail clamped to N - 1 (its duplicate
    rows are cut after the loop)."""
    return torch.clamp_max(c * C + torch.arange(C, device=device), N - 1)


def inv_r_masked(r2, keep):
    """rsqrt(r2) where r2 > 0 and keep, else 0."""
    inv_r = torch.rsqrt(torch.where(r2 > 0, r2, torch.ones_like(r2)))
    return torch.where((r2 > 0) & keep, inv_r, torch.zeros_like(inv_r))


def direct_gravity(x, y, z, m, alive, G: float, eps: float = 0.0,
                   chunk: int = 2048) -> Gravity:
    N = x.shape[0]
    C = min(chunk, N)
    n_chunks = -(-N // C)
    eps2 = eps * eps
    mj = torch.where(alive, m, torch.zeros_like(m))
    cols = torch.arange(N, device=x.device)
    parts = []
    for c in range(n_chunks):
        i_idx = chunk_rows(c, C, N, x.device)
        rx = x[i_idx][:, None] - x[None, :]
        ry = y[i_idx][:, None] - y[None, :]
        rz = z[i_idx][:, None] - z[None, :]
        not_self = cols[None, :] != i_idx[:, None]
        r2 = rx * rx + ry * ry + rz * rz + eps2
        inv_r = inv_r_masked(r2, not_self)
        inv_r3 = inv_r * inv_r * inv_r
        w = mj[None, :] * inv_r3
        parts.append((-torch.sum(w * rx, 1), -torch.sum(w * ry, 1),
                      -torch.sum(w * rz, 1),
                      -torch.sum(mj[None, :] * inv_r, 1)))
    out = [torch.cat([p[i] for p in parts])[:N] * G for i in range(4)]
    return Gravity(*out)


def egrav(m, pot, alive):
    """Total gravitational energy from per-particle potentials."""
    e = m * pot
    return 0.5 * torch.sum(torch.where(alive, e, torch.zeros_like(e)))
