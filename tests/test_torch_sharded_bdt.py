"""The port's ShardedBdtVE against the JAX package's (Pallas in interpret
mode, under jax.shard_map on two virtual CPU devices; the port's shards
are SlabMesh threads with the plain kernel versions).

Sedov 12^3 on a 4^3 global grid, local CMGrid(n=4, cap=64, nzi=2)
(2 h_max = 0.240 below the 0.25 cell edge), D = 2, num_rungs = 2 (its
rung histogram is [216, 1512]: both rungs populated), one cycle from the
same host state. Tolerances, as tests/test_torch_bdt.py holds the
single-device BdtVE:
  - distribute_bind, and resync of one and the same state (the JAX
    cycle's, with rows pushed across the slab edge and the periodic seam,
    carried over by interop.sharded_bdt_from_numpy): every
    leaf of every shard equal (unpack, migration with the gid and
    dt_m1k payload, and the local bind move values without arithmetic
    beyond the periodic fold);
  - per substep: dt rtol 1e-5, eint rtol 1e-6, ecin rtol 1e-3;
    rung_hist, active_frac and active_cell_frac equal; overflow and
    lost 0; the per-slot rungs equal;
  - unbound x, y, z, vx, temp, h within 2e-3 of their scale, alpha
    within 1e-4; checkpoint_rungs and restore_rungs equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.domain.slab import AXIS, SlabConfig as JSlabConfig
from sphexa_tpu.init.sedov import init_sedov as j_init_sedov
from sphexa_tpu.ops.cellmajor import CMGrid as JCMGrid
from sphexa_tpu.propagator.ve_bdt_sharded import ShardedBdtVE as JSharded
from sphexa_tpu.state import _FIELDS
from sphexa_tpu_torch.domain.mesh import SlabMesh
from sphexa_tpu_torch.domain.slab import SlabConfig
from sphexa_tpu_torch.interop import (box_from_numpy, config_from_dict,
                                      sharded_bdt_from_numpy,
                                      state_from_numpy)
from sphexa_tpu_torch.ops.cellmajor import CMGrid
from sphexa_tpu_torch.propagator.ve_bdt_sharded import ShardedBdtVE
from torch_threads import one_torch_thread  # noqa: F401

SIDE = 12
N = SIDE ** 3
D = 2
RUNGS = 2


def _np_tree(obj):
    """Dataclass of arrays (nested) -> dict of numpy copies."""
    return {f.name: (_np_tree(getattr(obj, f.name))
                     if dataclasses.is_dataclass(getattr(obj, f.name))
                     else np.array(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)}


def _split_tree(tree):
    """A JAX sharded state's numpy tree -> one tree per shard (slot rows
    cut into D pieces, 0-dim scalars repeated)."""
    def cut(v, i):
        return v if v.ndim == 0 else np.split(v, D)[i]
    return [{k: ({kk: cut(vv, i) for kk, vv in v.items()}
                 if isinstance(v, dict) else cut(v, i))
             for k, v in tree.items()} for i in range(D)]


def _assert_tree_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_tree_equal(got[k], v)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def _diag_np(d):
    return {k: np.asarray(v) for k, v in d._asdict().items()}


@pytest.fixture(scope="module")
def runs():
    state, jb, cfg = j_init_sedov(SIDE, JCfg(cell_cap=256, ngpad=256),
                                  dt0=2e-4)
    grid = JCMGrid(n=4, cap=64, nzi=2)
    sc = JSlabConfig(n_slabs=D, cap=(N // D) * 2 + 64, halo_cap=8,
                     mig_cap=256)
    jmesh = Mesh(np.array(jax.devices()[:D]), (AXIS,))
    jeng = JSharded(jb, grid, cfg, sc, jmesh, num_rungs=RUNGS,
                    interpret=True)
    jb0 = jeng.distribute_bind(state)
    jbound = _np_tree(jb0)
    jbst, jds = jeng.run_cycle(jb0)
    jcyc = _np_tree(jbst)
    # rows pushed across the slab edge at z = 0 and across the periodic
    # seam, so that the resync migrates them
    z, valid = jcyc["rv"]["z"], jcyc["rv"]["valid"] & (jcyc["rv"]["x"] > 0)
    dz = np.where(valid & (np.abs(z) < 0.05), -np.sign(z) * 0.06, 0.0) \
        + np.where(valid & (z < -0.45), -0.06, 0.0)
    jcyc["rv"]["z"] = (z + dz).astype(np.float32)
    jres, jlost = jeng.resync(jbst.replace(rv=jbst.rv.replace(
        z=jnp.asarray(jcyc["rv"]["z"]))))
    jck = jeng.checkpoint_rungs(jbst, N)
    jrest = _np_tree(jeng.restore_rungs(
        jeng.distribute_bind(state), jck["fields"]["bdt_rung"],
        jck["fields"]["bdt_dt_m1k"], jck["attrs"]["bdt_dt_min"]))
    jout = jeng.unbind(jbst, N)

    tbox = box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                           jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])
    mesh = SlabMesh(D, devices=["cpu"])
    teng = ShardedBdtVE(tbox, CMGrid(n=4, cap=64, nzi=2),
                        config_from_dict(dataclasses.asdict(cfg)),
                        SlabConfig(**dataclasses.asdict(sc)), mesh,
                        num_rungs=RUNGS)
    tstate = state_from_numpy({f: np.asarray(getattr(state.p, f))
                               for f in _FIELDS}, float(state.ttot),
                              float(state.dt), float(state.dt_m1),
                              int(state.iteration), device="cpu")
    tb0 = teng.distribute_bind(tstate)
    tbound = [_np_tree(b) for b in tb0]
    tbst, tds = teng.run_cycle(tb0)
    return dict(
        jbound=_split_tree(jbound), tbound=tbound,
        jd=[_diag_np(d) for d in jds], td=[_diag_np(d) for d in tds],
        jcyc=_split_tree(jcyc), jcyc_whole=jcyc, tcyc=[_np_tree(b)
                                                        for b in tbst],
        jres=_split_tree(_np_tree(jres)), jlost=int(jlost),
        jck=jck, jrest=_split_tree(jrest), tstate=tstate,
        jout={f: np.asarray(getattr(jout.p, f)) for f in _FIELDS},
        tbst=tbst, teng=teng, mesh=mesh)


@pytest.mark.parametrize("shard", range(D))
def test_distribute_bind_equal(runs, shard):
    _assert_tree_equal(runs["tbound"][shard], runs["jbound"][shard])


@pytest.mark.parametrize("sub", range(1 << (RUNGS - 1)))
def test_substep_diagnostics(runs, sub):
    a, b = runs["jd"][sub], runs["td"][sub]
    assert int(b["overflow"]) == int(a["overflow"]) == 0
    np.testing.assert_allclose(b["dt"], a["dt"], rtol=1e-5)
    np.testing.assert_allclose(b["eint"], a["eint"], rtol=1e-6)
    np.testing.assert_allclose(b["ecin"], a["ecin"], rtol=1e-3, atol=1e-12)
    np.testing.assert_array_equal(b["rung_hist"], a["rung_hist"])
    assert (a["rung_hist"] > 0).all()
    assert float(b["active_frac"]) == float(a["active_frac"])
    assert float(b["active_cell_frac"]) == float(a["active_cell_frac"])


@pytest.mark.parametrize("shard", range(D))
def test_rungs_per_slot(runs, shard):
    a, b = runs["jcyc"][shard], runs["tcyc"][shard]
    np.testing.assert_array_equal(b["rung"], a["rung"])
    np.testing.assert_array_equal(b["rv"]["valid"], a["rv"]["valid"])
    np.testing.assert_array_equal(b["rv"]["gid"], a["rv"]["gid"])
    assert int(b["substep"]) == int(a["substep"]) == 0


def test_resync_equal(runs):
    """resync of the JAX cycle's own state gives the JAX resync's state
    on every shard, and the same lost count (0); some rows migrate."""
    bsts = sharded_bdt_from_numpy(runs["jcyc_whole"], runs["mesh"])
    res, lost = runs["teng"].resync(bsts)
    assert int(lost) == runs["jlost"] == 0
    moved = 0
    for i in range(D):
        _assert_tree_equal(_np_tree(res[i]), runs["jres"][i])
        before = set(runs["jcyc"][i]["rv"]["gid"][
            runs["jcyc"][i]["rv"]["valid"]].tolist())
        after = set(runs["jres"][i]["rv"]["gid"][
            runs["jres"][i]["rv"]["valid"]].tolist())
        moved += len(after - before)
    print(f"rows migrated at the resync: {moved}")
    assert moved > 0


def test_unbound_fields(runs):
    out = runs["teng"].unbind(runs["tbst"], N)
    a = runs["jout"]
    np.testing.assert_array_equal(out.p.alive.numpy(), a["alive"])
    assert a["alive"].all()
    for f, tol in (("x", 2e-3), ("y", 2e-3), ("z", 2e-3), ("vx", 2e-3),
                   ("temp", 2e-3), ("h", 2e-3), ("alpha", 1e-4)):
        b = getattr(out.p, f).numpy()
        scale = max(np.abs(a[f]).max(), 1e-12)
        assert np.abs(b - a[f]).max() / scale < tol, f


def test_checkpoint_restore_rungs(runs):
    teng, jck = runs["teng"], runs["jck"]
    ck = teng.checkpoint_rungs(runs["tbst"], N)
    for k in ("bdt_rung", "bdt_dt_m1k"):
        np.testing.assert_array_equal(ck["fields"][k].numpy(),
                                      np.asarray(jck["fields"][k]))
    assert ck["attrs"] == jck["attrs"]
    rest = teng.restore_rungs(teng.distribute_bind(runs["tstate"]),
                              ck["fields"]["bdt_rung"],
                              ck["fields"]["bdt_dt_m1k"],
                              ck["attrs"]["bdt_dt_min"])
    for i in range(D):
        t = _np_tree(rest[i])
        for k in ("rung", "dt_m1k", "ticks", "dt_min", "substep"):
            np.testing.assert_array_equal(t[k], runs["jrest"][i][k],
                                          err_msg=k)


def test_checkpoint_refuses_mid_cycle(runs):
    teng = runs["teng"]
    mid, _ = teng.substep(teng.distribute_bind(runs["tstate"]))
    with pytest.raises(ValueError):
        teng.checkpoint_rungs(mid, N)
