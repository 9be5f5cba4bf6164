"""The last public functions of the JAX package that had no counterpart
in the port, under the same names and modules, against the JAX
functions on seeded inputs:

  util/kahan.kahan_dot, sfc/box.apply_pbc, distance_pbc,
  extend_to_coords, sph/kernels.make_tables, table_lookup,
  domain/slab.slab_bounds, ops/cellmajor.refresh_ghosts.

Each does the same float32 (or float64 host) operations in both
packages, so each is held bit for bit but distance_pbc; the box of
extend_to_coords and the slab width are Python floats, compared
exactly. distance_pbc is held at rtol 2.4e-7 (two float32 ulp): XLA's
CPU compiler rounds the sum of squares differently (measured: 1 ulp on
0.8% of the distances), while apply_pbc under it is bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.domain import slab as jslab
from sphexa_tpu.ops import cellmajor as jcm
from sphexa_tpu.sfc import box as jbox
from sphexa_tpu.sph import kernels as jk
from sphexa_tpu.util import kahan as jkahan
from sphexa_tpu_torch.domain import slab as tslab
from sphexa_tpu_torch.interop import box_from_numpy
from sphexa_tpu_torch.ops import cellmajor as tcm
from sphexa_tpu_torch.sfc import box as tbox
from sphexa_tpu_torch.sph import kernels as tk
from sphexa_tpu_torch.util import kahan as tkahan
from torch_threads import one_torch_thread  # noqa: F401

# x periodic, y open, z fixed
JBOX = jbox.Box(-0.5, 0.5, -1.0, 1.0, 0.0, 2.0, jbox.Boundary.periodic,
                jbox.Boundary.open, jbox.Boundary.fixed)
TBOX = box_from_numpy([-0.5, 0.5, -1.0, 1.0, 0.0, 2.0], [1, 0, 2])


def _f32(r, *shape, lo=-1.0, hi=1.0):
    return r.uniform(lo, hi, shape).astype(np.float32)


def _same(t, j):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


def check_kahan_dot(r):
    a, b = _f32(r, 10001), _f32(r, 10001, lo=-3.0, hi=3.0)
    _same(tkahan.kahan_dot(torch.from_numpy(a), torch.from_numpy(b)),
          jkahan.kahan_dot(jnp.asarray(a), jnp.asarray(b)))


def check_apply_pbc(r):
    d = [_f32(r, 4000, lo=-2.0, hi=2.0) for _ in range(3)]
    for t, j in zip(tbox.apply_pbc(TBOX, *map(torch.from_numpy, d)),
                    jbox.apply_pbc(JBOX, *map(jnp.asarray, d))):
        _same(t, j)


def check_distance_pbc(r):
    p = [_f32(r, 4000, lo=-1.0, hi=1.0) for _ in range(6)]
    np.testing.assert_allclose(
        tbox.distance_pbc(TBOX, *map(torch.from_numpy, p)).numpy(),
        np.asarray(jbox.distance_pbc(JBOX, *map(jnp.asarray, p))),
        rtol=2.4e-7, atol=0)


def check_extend_to_coords(r):
    c = [_f32(r, 500, lo=-3.0, hi=4.0) for _ in range(3)]
    tb = tbox.extend_to_coords(TBOX, *map(torch.from_numpy, c))
    jb = jbox.extend_to_coords(JBOX, *map(jnp.asarray, c))
    got = (tb.xmin, tb.xmax, tb.ymin, tb.ymax, tb.zmin, tb.zmax)
    assert got == (jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin, jb.zmax)
    assert (got[0], got[1], got[4], got[5]) == (-0.5, 0.5, 0.0, 2.0)
    assert got[2] < float(c[1].min()) and got[3] > float(c[1].max())


def check_make_tables(r):
    for n, size in ((6.0, 20000), (5.0, 1001)):
        for t, j in zip(tk.make_tables(n, size), jk.make_tables(n, size)):
            assert t.dtype == j.dtype == np.float32
            _same(t, j)


def check_table_lookup(r):
    v = _f32(r, 5000, lo=-0.1, hi=2.2)
    for t, j in zip(tk.make_tables(6.0), jk.make_tables(6.0)):
        _same(tk.table_lookup(t, torch.from_numpy(v)),
              jk.table_lookup(j, jnp.asarray(v)))


def check_slab_bounds(r):
    for n in (2, 3, 8):
        assert tslab.slab_bounds(TBOX, n) == jslab.slab_bounds(JBOX, n)


def check_refresh_ghosts(r):
    for per in (0, 1):
        jb = jbox.Box(-1.0, 1.0, -1.0, 1.0, -1.0, 1.0,
                      *[jbox.Boundary(per)] * 3)
        tb = box_from_numpy([-1, 1, -1, 1, -1, 1], [per] * 3)
        xyz = [_f32(r, 400, lo=-0.999, hi=0.999) for _ in range(3)]
        jg = jcm.CMGrid(n=4, cap=64)
        tg = tcm.CMGrid(n=4, cap=64)
        jl = jcm.build_layout(jg, jb, *map(jnp.asarray, xyz))
        tl = tcm.build_layout(tg, tb, *map(torch.from_numpy, xyz))
        f = _f32(r, tg.n_slots)
        _same(tcm.refresh_ghosts(tl, torch.from_numpy(f)),
              jcm.refresh_ghosts(jl, jnp.asarray(f)))


CHECKS = {f.__name__.removeprefix("check_"): f for f in (
    check_kahan_dot, check_apply_pbc, check_distance_pbc,
    check_extend_to_coords, check_make_tables, check_table_lookup,
    check_slab_bounds, check_refresh_ghosts)}


@pytest.mark.parametrize("name", list(CHECKS))
def test_port_function_equals_jax(name):
    CHECKS[name](np.random.default_rng(sorted(CHECKS).index(name)))
