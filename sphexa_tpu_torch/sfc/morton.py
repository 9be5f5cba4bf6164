"""3D Morton (Z-order) keys of 10-bit cell coordinates.

Counterpart of sphexa_tpu/sfc/morton.py (reference: domain/include/
cstone/sfc/morton.hpp). The JAX package packs the 30-bit keys into
uint32; PyTorch lacks some shifts and bitwise operations on uint32, so
the port computes them in int64, where they carry the same values.
"""

from __future__ import annotations

import torch

MAX_LEVEL = 10  # 3 * 10 = 30 bits


def _part1by2(v):
    """Spread the low 10 bits of v so there are two zero bits between each."""
    v = v.to(torch.int64) & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _compact1by2(v):
    v = v.to(torch.int64) & 0x09249249
    v = (v | (v >> 2)) & 0x030C30C3
    v = (v | (v >> 4)) & 0x0300F00F
    v = (v | (v >> 8)) & 0x030000FF
    v = (v | (v >> 16)) & 0x000003FF
    return v


def morton_encode(ix, iy, iz):
    """Interleave 10-bit integer coords into a 30-bit Morton key, x in
    the most significant position of each 3-bit group (int64)."""
    return (_part1by2(ix) << 2) | (_part1by2(iy) << 1) | _part1by2(iz)


def morton_decode(key):
    key = key.to(torch.int64)
    return _compact1by2(key >> 2), _compact1by2(key >> 1), _compact1by2(key)
