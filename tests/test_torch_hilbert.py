"""The port's Hilbert codecs (sphexa_tpu_torch/sfc/hilbert.py,
sfc/hilbert64.py) bit-equal to the JAX package's on seeded integer
coordinates and positions.

The JAX package keeps keys and coordinates in uint32, the port in int64:
every key, plane and decoded coordinate is compared as int64 values,
exactly. Covered: encode and decode at level 10 (and at lower orders),
the corners of the grid; the (hi, lo) pair at level 20 with its
decode, the level-10 embedding (hi of any coords is the level-10 key of
their top 10 bits; for level-10 coords shifted up by 10 bits, hi is
their level-10 key and lo is the same in both packages, though not 0
as the JAX module docstring says: the transform mixes the low bits),
key64_less, the stable sort_by_key64 with repeated
keys, and keys64_from_positions on an open and a periodic box.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.sfc import hilbert as jh
from sphexa_tpu.sfc import hilbert64 as jh64
from sphexa_tpu.sfc.box import Box as JBox
from sphexa_tpu.sfc.box import Boundary as JBoundary
from sphexa_tpu_torch.interop import box_from_numpy
from sphexa_tpu_torch.sfc import hilbert as th
from sphexa_tpu_torch.sfc import hilbert64 as th64
from torch_threads import one_torch_thread  # noqa: F401


def ints(a):
    return np.asarray(a).astype(np.int64)


def t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def coords(seed, n, bits):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 1 << bits, (3, n), dtype=np.int64)
    corners = np.array([[0, 0, 0], [(1 << bits) - 1] * 3,
                        [0, (1 << bits) - 1, 0], [1, 0, (1 << bits) - 1]],
                       np.int64).T
    return np.concatenate([c, corners], axis=1)


@pytest.mark.parametrize("order", [10, 7, 3])
def test_hilbert_encode_decode(order):
    c = coords(order, 4096, order)
    want = ints(jh.hilbert_encode(*(jnp.asarray(v.astype(np.uint32))
                                    for v in c), order))
    got = th.hilbert_encode(*(t(v) for v in c), order)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    jd = jh.hilbert_decode(jnp.asarray(want.astype(np.uint32)), order)
    td = th.hilbert_decode(got, order)
    for a, b, v in zip(td, jd, c):
        np.testing.assert_array_equal(a.numpy(), ints(b))
        np.testing.assert_array_equal(a.numpy(), v)


def test_every_level10_key_of_a_block():
    """All 2^15 keys of a contiguous run decode and re-encode alike."""
    keys = np.arange(1 << 20, (1 << 20) + (1 << 15), dtype=np.int64)
    jd = jh.hilbert_decode(jnp.asarray(keys.astype(np.uint32)))
    td = th.hilbert_decode(t(keys))
    for a, b in zip(td, jd):
        np.testing.assert_array_equal(a.numpy(), ints(b))
    np.testing.assert_array_equal(th.hilbert_encode(*td).numpy(), keys)


def test_hilbert64_encode_decode_and_embedding():
    c = coords(20, 4096, 20)
    jhi, jlo = jh64.hilbert_encode64(*(jnp.asarray(v.astype(np.uint32))
                                       for v in c))
    hi, lo = th64.hilbert_encode64(*(t(v) for v in c))
    np.testing.assert_array_equal(hi.numpy(), ints(jhi))
    np.testing.assert_array_equal(lo.numpy(), ints(jlo))
    for a, b, v in zip(th64.hilbert_decode64(hi, lo),
                       jh64.hilbert_decode64(jhi, jlo), c):
        np.testing.assert_array_equal(a.numpy(), ints(b))
        np.testing.assert_array_equal(a.numpy(), v)
    # hi is the level-10 key of the top 10 bits (both packages)
    np.testing.assert_array_equal(
        hi.numpy(), th.hilbert_encode(*(t(v >> 10) for v in c)).numpy())
    # level-10 coords shifted up by 10 bits: hi the level-10 key
    c10 = coords(10, 2048, 10)
    jhi, jlo = jh64.hilbert_encode64(*(jnp.asarray((v << 10)
                                                   .astype(np.uint32))
                                       for v in c10))
    hi, lo = th64.hilbert_encode64(*(t(v << 10) for v in c10))
    np.testing.assert_array_equal(hi.numpy(), ints(jhi))
    np.testing.assert_array_equal(lo.numpy(), ints(jlo))
    np.testing.assert_array_equal(
        hi.numpy(), ints(jh.hilbert_encode(*(jnp.asarray(v.astype(np.uint32))
                                             for v in c10))))


def test_key64_less_and_stable_sort():
    rng = np.random.default_rng(6)
    n = 3000
    hi = rng.integers(0, 40, n, dtype=np.int64)     # repeated keys
    lo = rng.integers(0, 40, n, dtype=np.int64)
    val = rng.standard_normal(n).astype(np.float32)
    jargs = [jnp.asarray(a.astype(np.uint32)) for a in (hi, lo)]
    jless = np.asarray(jh64.key64_less(jargs[0], jargs[1], jargs[0][::-1],
                                       jargs[1][::-1]))
    tless = th64.key64_less(t(hi), t(lo), t(hi[::-1]), t(lo[::-1]))
    np.testing.assert_array_equal(tless.numpy(), jless)
    jperm, jv = jh64.sort_by_key64(*jargs, jnp.asarray(val))
    tperm, tv = th64.sort_by_key64(t(hi), t(lo), torch.from_numpy(val))
    np.testing.assert_array_equal(tperm.numpy(), ints(jperm))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("bc", [JBoundary.open, JBoundary.periodic])
def test_keys64_from_positions(bc):
    rng = np.random.default_rng(int(bc.value) + 1)
    jb = JBox(-1.5, 0.5, -1.0, 1.0, 0.0, 3.0, bc, bc, bc)
    n = 4000
    pos = [rng.uniform(lo - 0.1, hi + 0.1, n).astype(np.float32)
           for lo, hi in ((jb.xmin, jb.xmax), (jb.ymin, jb.ymax),
                          (jb.zmin, jb.zmax))]
    pos[0][:3] = [jb.xmin, jb.xmax, np.nextafter(np.float32(jb.xmax), 0)]
    tb = box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                         jb.zmax], [bc.value] * 3)
    jhi, jlo = jh64.keys64_from_positions(jb, *(jnp.asarray(p) for p in pos))
    hi, lo = th64.keys64_from_positions(tb, *(torch.from_numpy(p)
                                              for p in pos))
    np.testing.assert_array_equal(hi.numpy(), ints(jhi))
    np.testing.assert_array_equal(lo.numpy(), ints(jlo))
    for order in (12, 5):
        jhi, jlo = jh64.keys64_from_positions(
            jb, *(jnp.asarray(p) for p in pos), order=order)
        hi, lo = th64.keys64_from_positions(
            tb, *(torch.from_numpy(p) for p in pos), order=order)
        np.testing.assert_array_equal(hi.numpy(), ints(jhi))
        np.testing.assert_array_equal(lo.numpy(), ints(jlo))
