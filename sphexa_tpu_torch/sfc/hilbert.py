"""Vectorized 3D Hilbert keys, 30 bits (level 10).

Counterpart of sphexa_tpu/sfc/hilbert.py (reference: domain/include/
cstone/sfc/hilbert.hpp:59,146 iHilbert/decodeHilbert), with Skilling's
transpose algorithm ("Programming the Hilbert curve", AIP Conf. Proc.
707, 2004, public domain), branch-free with the per-bit conditionals as
masked bit operations, so the codec vectorizes over particle tensors.

The JAX package keeps the keys in uint32. PyTorch lacks some shifts
and bitwise operations on uint32, so the port computes in int64, as
sfc/morton.py does: the keys and coordinates carry the same values.
"""

from __future__ import annotations

import torch

from sphexa_tpu_torch.sfc.morton import morton_decode, morton_encode

MAX_LEVEL = 10


def _axes_to_transpose(x, y, z, order: int = MAX_LEVEL):
    """Skilling's AxesToTranspose, vectorized: Gray-code entanglement of
    the input coordinates so that bit-interleaving yields the Hilbert key."""
    X = [torch.as_tensor(v).to(torch.int64) for v in (x, y, z)]

    # Inverse undo
    q = 1 << (order - 1)
    while q > 1:
        p = q - 1
        for i in range(3):
            hi = (X[i] & q) != 0
            # if bit set: invert low bits of X[0]; else swap low bits X[0]<->X[i]
            t = (X[0] ^ X[i]) & p
            X0_inv = X[0] ^ p
            X0_swp = X[0] ^ t
            Xi_swp = X[i] ^ t
            X[0] = torch.where(hi, X0_inv, X0_swp)
            if i != 0:
                X[i] = torch.where(hi, X[i], Xi_swp)
        q >>= 1

    # Gray encode
    X[1] = X[1] ^ X[0]
    X[2] = X[2] ^ X[1]
    t = torch.zeros_like(X[0])
    q = 1 << (order - 1)
    while q > 1:
        t = torch.where((X[2] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    X[0] = X[0] ^ t
    X[1] = X[1] ^ t
    X[2] = X[2] ^ t
    return X


def _transpose_to_axes(x, y, z, order: int = MAX_LEVEL):
    X = [torch.as_tensor(v).to(torch.int64) for v in (x, y, z)]

    # Gray decode by H ^ (H/2)
    t = X[2] >> 1
    X[2] = X[2] ^ X[1]
    X[1] = X[1] ^ X[0]
    X[0] = X[0] ^ t

    # Undo excess work
    q = 2
    while q != (2 << (order - 1)):
        p = q - 1
        for i in (2, 1, 0):
            hi = (X[i] & q) != 0
            t = (X[0] ^ X[i]) & p
            X0_inv = X[0] ^ p
            X0_swp = X[0] ^ t
            Xi_swp = X[i] ^ t
            X[0] = torch.where(hi, X0_inv, X0_swp)
            if i != 0:
                X[i] = torch.where(hi, X[i], Xi_swp)
        q <<= 1
    return X


def hilbert_encode(ix, iy, iz, order: int = MAX_LEVEL):
    """3D integer coords (10-bit each) -> 30-bit Hilbert key (int64)."""
    tx, ty, tz = _axes_to_transpose(ix, iy, iz, order)
    # In transpose format, bit b of (tx, ty, tz) are three consecutive key
    # bits: interleaving with tx most significant yields the Hilbert index.
    return morton_encode(tx, ty, tz)


def hilbert_decode(key, order: int = MAX_LEVEL):
    """30-bit Hilbert key -> 3D integer coords (10-bit each, int64)."""
    tx, ty, tz = morton_decode(torch.as_tensor(key))
    return _transpose_to_axes(tx, ty, tz, order)
