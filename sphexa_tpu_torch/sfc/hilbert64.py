"""Extended-precision 3D Hilbert keys: level 20 (60 bits) as a (hi, lo)
pair of 30-bit planes.

Counterpart of sphexa_tpu/sfc/hilbert64.py (the reference uses
KeyType=uint64 at 21 levels, sph/include/sph/types.hpp:39-46,
sfc/hilbert.hpp:59). The JAX package keeps the key as two uint32
planes ordered lexicographically, since the TPU has no 64-bit integer
lanes; the port keeps the same pair, in int64 tensors (sfc/hilbert.py):

  - Skilling's transpose transform is per-dimension bit math on
    <= 21-bit coords;
  - hi = interleave(top 10 bits), lo = interleave(bottom 10 bits): level
    20, a 2^20 cells-per-dimension grid, 2^60 key values.

Sorting uses (hi, lo) lexicographic order. hi is the level-10 key of
the coordinates' top 10 bits (the prefix property); lo is not 0 for
level-10 coordinates shifted up by 10 bits, whatever the JAX module's
docstring says, since the transform mixes the low bits.
"""

from __future__ import annotations

import torch

from sphexa_tpu_torch.sfc.hilbert import _axes_to_transpose, _transpose_to_axes
from sphexa_tpu_torch.sfc.morton import morton_decode, morton_encode

MAX_LEVEL64 = 20
_MASK10 = 0x3FF


def hilbert_encode64(ix, iy, iz, order: int = MAX_LEVEL64):
    """20-bit integer coords -> (hi, lo) Hilbert key planes (int64)."""
    assert order <= MAX_LEVEL64
    tx, ty, tz = _axes_to_transpose(ix, iy, iz, order)
    hi = morton_encode(tx >> 10, ty >> 10, tz >> 10)
    lo = morton_encode(tx & _MASK10, ty & _MASK10, tz & _MASK10)
    return hi, lo


def hilbert_decode64(hi, lo, order: int = MAX_LEVEL64):
    """(hi, lo) Hilbert key planes -> 20-bit integer coords (int64)."""
    assert order <= MAX_LEVEL64
    txh, tyh, tzh = morton_decode(torch.as_tensor(hi))
    txl, tyl, tzl = morton_decode(torch.as_tensor(lo))
    tx = (txh << 10) | txl
    ty = (tyh << 10) | tyl
    tz = (tzh << 10) | tzl
    return _transpose_to_axes(tx, ty, tz, order)


def key64_less(hi_a, lo_a, hi_b, lo_b):
    """Lexicographic (hi, lo) comparison: the uint64 '<'."""
    return (hi_a < hi_b) | ((hi_a == hi_b) & (lo_a < lo_b))


def sort_by_key64(hi, lo, *arrays):
    """Indirect stable sort by the (hi, lo) key pair: one pass over lo,
    one stable pass over hi (LSD radix over the two planes). Returns
    (perm, *arrays[perm])."""
    order1 = torch.argsort(lo, stable=True)
    order2 = torch.argsort(hi[order1], stable=True)
    perm = order1[order2]
    return (perm,) + tuple(a[perm] for a in arrays)


def keys64_from_positions(box, x, y, z, order: int = MAX_LEVEL64):
    """Positions -> (hi, lo) key planes on the global box (the
    computeSfcKeys analog, sfc/sfc.hpp:284, at 64-bit precision)."""
    from sphexa_tpu_torch.sfc.box import normalize_coords

    nx, ny, nz = normalize_coords(box, x, y, z)
    side = 1 << order
    ix = torch.clamp_max((nx * side).to(torch.int64), side - 1)
    iy = torch.clamp_max((ny * side).to(torch.int64), side - 1)
    iz = torch.clamp_max((nz * side).to(torch.int64), side - 1)
    return hilbert_encode64(ix, iy, iz, order)
