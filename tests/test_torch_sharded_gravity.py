"""The port's sharded self-gravity against the JAX package's.

- fmm_gravity_sharded (z-slabs, rings 1 and 2) and
  fmm_gravity_sharded_generic (any decomposition) at D = 2 and 4, under
  jax.jit(jax.shard_map) on the conftest's virtual CPU devices and as
  SlabMesh threads on the CPU, on seeded clustered particles at FMM
  level 3: accelerations and potentials within 1e-5 of their scale over
  the alive rows, egrav at rtol 1e-5 (the psum of the moment grids adds
  the shards in another order than XLA may, and the P2M sums in another
  order), nf_truncated and the band overflow equal. One frame per
  solver truncates its leaves (leaf_cap 8) and overflows its bands
  (band_cap 8), and the port counts both as JAX does.
- min_level_for_bands, moment_grid_bytes, the psum budget's refusal and
  estimate_band_cap equal to JAX.
- The sharded fields against the single-device FMM on the union of
  the shards' rows, within 1e-5 of scale.

ShardedBdtVE with gravity: tests/test_torch_sharded_bdt_gravity.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from sphexa_tpu.domain.slab import AXIS
from sphexa_tpu.gravity import fmm as jfmm
from sphexa_tpu.sfc.box import Box as JBox, Boundary as JB
from sphexa_tpu_torch.domain.mesh import SlabMesh
from sphexa_tpu_torch.gravity import fmm as tfmm
from sphexa_tpu_torch.interop import box_from_numpy
from torch_threads import two_torch_threads  # noqa: F401

JBOX = JBox(-1.0, 1.0, -1.0, 1.0, -1.0, 1.0, JB.open, JB.open, JB.open)
TBOX = box_from_numpy([-1, 1, -1, 1, -1, 1], [0, 0, 0])
CAP = 192
EPS = 0.01
G = 1.0

# name -> (D, generic, rings, leaf_cap, band_cap)
CASES = {
    "slab_d2_r1": (2, False, 1, 128, 0),
    "slab_d4_r2": (4, False, 2, 128, 0),
    "slab_d2_trunc": (2, False, 1, 8, 8),
    "gen_d2": (2, True, 0, 128, 0),
    "gen_d4": (4, True, 0, 128, 0),
    "gen_d2_trunc": (2, True, 0, 8, 8),
}


def _frame(D, seed):
    """Per shard CAP rows, a random alive prefix; z inside the shard's
    slab (for the slab solver; the generic one takes any split); half
    the rows in a cluster (one x-y column, the middle of each slab);
    dead rows noise."""
    r = np.random.default_rng(seed)
    n = D * CAP
    core = r.random(n) < 0.5
    x = np.where(core, r.normal(0.3, 0.08, n), r.uniform(-1, 1, n))
    y = np.where(core, r.normal(-0.2, 0.08, n), r.uniform(-1, 1, n))
    W = 2.0 / D
    z = np.concatenate([-1 + W * (s + np.where(
        core[s * CAP:(s + 1) * CAP],
        np.clip(r.normal(0.5, 0.1, CAP), 0.02, 0.98),
        r.uniform(0.02, 0.98, CAP))) for s in range(D)])
    alive = np.zeros(n, bool)
    for s in range(D):
        alive[s * CAP:s * CAP + int(r.integers(CAP // 2, CAP))] = True
    m = r.uniform(0.5, 1.5, n) / n
    cols = [np.clip(v, -0.999, 0.999).astype(np.float32) for v in (x, y, z)]
    return cols + [m.astype(np.float32)], alive


def _fc(level, leaf_cap, mod):
    return mod.FmmConfig(level=level, leaf_cap=leaf_cap, min_sep=3)


@functools.lru_cache(maxsize=None)
def _both(name):
    D, generic, rings, leaf_cap, band_cap = CASES[name]
    (x, y, z, m), alive = _frame(D, list(CASES).index(name))
    jfc = _fc(3, leaf_cap, jfmm)

    def local(x, y, z, m, a):
        if generic:
            out = jfmm.fmm_gravity_sharded_generic(
                x, y, z, m, a, JBOX, G, jfc, EPS, AXIS, band_cap=band_cap)
        else:
            out = jfmm.fmm_gravity_sharded(x, y, z, m, a, JBOX, G, jfc, EPS,
                                           AXIS, dim=2, band_cap=band_cap,
                                           rings=rings)
        return tuple(out[:4]) + (jnp.stack(out[4:])[None],)

    mesh = Mesh(np.array(jax.devices()[:D]), (AXIS,))
    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P(AXIS),) * 5,
                               out_specs=(P(AXIS),) * 5, check_vma=False))
    ja = [np.asarray(v) for v in fn(*(jnp.asarray(v)
                                      for v in (x, y, z, m, alive)))]

    tfc = _fc(3, leaf_cap, tfmm)
    tmesh = SlabMesh(D, devices=["cpu"])

    def tlocal(comm, x, y, z, m, a):
        if generic:
            out = tfmm.fmm_gravity_sharded_generic(
                comm, x, y, z, m, a, TBOX, G, tfc, EPS, band_cap=band_cap)
        else:
            out = tfmm.fmm_gravity_sharded(comm, x, y, z, m, a, TBOX, G, tfc,
                                           EPS, dim=2, band_cap=band_cap,
                                           rings=rings)
        return tuple(out[:4]) + (torch.stack(out[4:])[None],)

    parts = [[torch.from_numpy(np.ascontiguousarray(v[s * CAP:(s + 1) * CAP]))
              for s in range(D)] for v in (x, y, z, m, alive)]
    res = tmesh.run(tlocal, *parts)
    ta = [np.concatenate([r[k].numpy() for r in res]) for k in range(5)]
    return ja, ta, alive, m


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_fmm_against_jax(name):
    ja, ta, alive, m = _both(name)
    for k in range(4):               # ax, ay, az, pot
        a, b = ja[k][alive], ta[k][alive]
        scale = np.abs(a).max()
        assert np.abs(b - a).max() <= 1e-5 * scale, (k, np.abs(b - a).max(),
                                                     scale)
    ea = 0.5 * np.sum(m[alive] * ja[3][alive], dtype=np.float64)
    eb = 0.5 * np.sum(m[alive] * ta[3][alive], dtype=np.float64)
    np.testing.assert_allclose(eb, ea, rtol=1e-5)
    np.testing.assert_array_equal(ta[4], ja[4])      # nf_trunc, band ovf
    if name.endswith("trunc"):
        assert (ja[4][:, 0] > 0).all() and (ja[4][:, 1] > 0).all()
    else:
        assert (ja[4] == 0).all()


def test_sharded_fmm_matches_one_device():
    """The sharded far + near field equals the single-device FMM on the
    union of the shards' rows (generic D = 4, slab D = 2) within 1e-5 of
    scale: no pair is lost across shards."""
    for name in ("gen_d4", "slab_d2_r1"):
        _, ta, alive, _ = _both(name)
        D = CASES[name][0]
        (x, y, z, m), _ = _frame(D, list(CASES).index(name))
        g = tfmm.fmm_gravity(*(torch.from_numpy(v[alive])
                               for v in (x, y, z, m)),
                             torch.ones(int(alive.sum()), dtype=torch.bool),
                             TBOX, G, _fc(3, 128, tfmm), eps=EPS)
        for k, v in enumerate((g.ax, g.ay, g.az, g.pot)):
            a = v.numpy()
            assert np.abs(ta[k][alive] - a).max() <= 1e-5 * np.abs(a).max()


def test_levels_and_budget():
    for args in ((2,), (4,), (8,), (4, 0.5), (16, 1.0, 2), (3, 0.3, 4)):
        assert tfmm.min_level_for_bands(*args) == jfmm.min_level_for_bands(
            *args)
    for lvl in range(2, 8):
        assert tfmm.moment_grid_bytes(lvl) == jfmm.moment_grid_bytes(lvl)
        ok = tfmm.moment_grid_bytes(lvl) <= tfmm.MOMENT_PSUM_BYTE_CAP
        for mod in (tfmm, jfmm):
            if ok:
                mod._check_psum_budget(mod.FmmConfig(level=lvl))
            else:
                with pytest.raises(ValueError, match="psums"):
                    mod._check_psum_budget(mod.FmmConfig(level=lvl))


@pytest.mark.parametrize("level", [3, 4])
def test_estimate_band_cap(level):
    r = np.random.default_rng(level)
    n = 1 << level
    cells = [r.integers(0, n ** 3, int(r.integers(50, 400)))
             for _ in range(3)] + [np.array([-1, n ** 3, 5])]
    for kw in ({}, dict(margin=1.2, align=64), dict(min_sep=2)):
        assert tfmm.estimate_band_cap(cells, level, **kw) == \
            jfmm.estimate_band_cap(cells, level, **kw)
