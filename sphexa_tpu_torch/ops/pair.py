"""Chunked pair-stage driver of the gather path.

Counterpart of sphexa_tpu/ops/pair.py: every stage is a dense batched
computation over an i-chunk [C] and its padded neighbour axis [C, K]:
gather j-fields through the neighbour index matrix, compute, mask, and
reduce over K. The JAX package maps over the chunks with lax.map; here
it is a Python loop over chunks of rows (the last one short), which
bounds the temporaries to O(C * K) as there. The chunk's rows C are the
most that keep C * K within CHUNK_ELEMS (64 MiB a float32 temporary),
not SphConfig.chunk, which bounds the neighbour search alone: each
stage launches a few hundred small kernels a chunk, and at chunks of
4096 rows the launches, not the device, bound a step. Every row's sums
are its own, so the chunking does not change which values are summed.
"""

from __future__ import annotations

from typing import Callable

import torch

from sphexa_tpu_torch.sfc.box import Box, fold


class PairChunk:
    """View of one i-chunk: i-slices, gathered j-fields, geometry."""

    def __init__(self, box: Box, x, y, z, h, idx, nc, i_idx):
        self.box = box
        self.i_idx = i_idx                  # [C] global i rows
        self.idx = idx[i_idx]               # [C, K] neighbour rows
        self.nc = nc[i_idx]                 # [C]
        K = self.idx.shape[1]
        self.mask = (torch.arange(K, device=self.idx.device)[None, :]
                     < self.nc[:, None])

        self.xi, self.yi, self.zi = x[i_idx], y[i_idx], z[i_idx]
        self.hi = h[i_idx]
        px, py, pz = box.periodic
        lx, ly, lz = box.lengths
        self.rx = fold(self.xi[:, None] - x[self.idx], lx, px)   # [C, K]
        self.ry = fold(self.yi[:, None] - y[self.idx], ly, py)
        self.rz = fold(self.zi[:, None] - z[self.idx], lz, pz)
        d2 = self.rx ** 2 + self.ry ** 2 + self.rz ** 2
        self.dist = torch.sqrt(d2)
        self.safe_dist = torch.where(self.mask & (self.dist > 0), self.dist,
                                     1.0)
        self.v1 = self.dist / self.hi[:, None]              # dist / h_i

    def gi(self, field):
        """i-slice of a per-particle field -> [C]."""
        return field[self.i_idx]

    def gj(self, field):
        """j-gather of a per-particle field -> [C, K]."""
        return field[self.idx]

    def msum(self, value):
        """Masked reduction over the neighbour axis -> [C]."""
        return torch.sum(torch.where(self.mask, value, 0.0), dim=1)


# elements of a chunk's [C, K] temporaries (64 MiB a float32 one)
CHUNK_ELEMS = 1 << 24


def run_pair_stage(stage: Callable, box: Box, x, y, z, h, idx, nc):
    """Run `stage(PairChunk) -> [C] tensor or tuple of them` over all
    particles in chunks of CHUNK_ELEMS // K rows; returns the same
    structure with [N] tensors."""
    N = x.shape[0]
    chunk = max(CHUNK_ELEMS // max(idx.shape[1], 1), 1)
    outs = [stage(PairChunk(box, x, y, z, h, idx, nc,
                            torch.arange(c0, min(c0 + chunk, N),
                                         device=x.device)))
            for c0 in range(0, N, chunk)]
    if isinstance(outs[0], torch.Tensor):
        return torch.cat(outs)
    cols = [torch.cat(c) for c in zip(*outs)]
    return type(outs[0])(*cols) if hasattr(outs[0], "_fields") \
        else tuple(cols)
