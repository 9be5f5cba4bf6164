"""The port's column-range engine (propagator/ve_pallas_hilbert.py)
against the JAX package's.

The JAX side runs under jax.jit(jax.shard_map) on the conftest's
virtual CPU devices, its Pallas stages in interpret mode; the port runs
its shards as SlabMesh threads on the CPU with the kernels' plain
versions, under two torch threads.

1. flat_columns, balance_column_splits (psum'd float32 histogram,
   searchsorted, the n + 1 spacing passes) and distribute_columns
   exactly equal, on seeded uniform rows and on the JAX package's
   80%-clustered set at D = 8, n = 32 (tests/test_pallas_hilbert.py).
2. The step at Sedov 12^3, D = 2, on the global CMGrid(n=4, cap=64)
   (2 h_max = 0.24 below the 0.25 cell edge; the x-row window of
   ceil(4 / 2) + 4 = 6 rows), 2 steps from the same distribution:
   lost, n_owned, n_total, max_nc, overflow and row_span_ok exact; dt,
   ttot, etot, eint, h_max at rtol 1e-5, ecin at 1e-4 (velocities start
   at 0); each shard's alive rows row for row (the port's migrate keeps
   JAX's row order), every field within 1e-5 of its scale.
3. row_span_ok false on a window of 3 rows, which the 2-row ranges and
   their two halo rows outgrow.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.domain.hilbert import AXIS
from sphexa_tpu.init.sedov import init_sedov as j_init_sedov
from sphexa_tpu.propagator import ve_pallas_hilbert as J
from sphexa_tpu.sfc.box import Box as JBox
from sphexa_tpu.state import SimState as JSimState, _FIELDS
from sphexa_tpu_torch.domain.mesh import SlabMesh
from sphexa_tpu_torch.interop import (box_from_numpy, config_from_dict,
                                      sharded_states_from_numpy)
from sphexa_tpu_torch.propagator import ve_pallas_hilbert as T
from torch_threads import two_torch_threads  # noqa: F401

SIDE, N_CELLS, CAP, STEPS = 12, 4, 64, 2


def _tbox(jb):
    return box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                           jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])


def _jmesh(D):
    return Mesh(np.array(jax.devices()[:D]), (AXIS,))


def clustered(n_pts=4096, seed=0):
    """The JAX package's 80%-clustered set (a dense corner cluster)."""
    rng = np.random.default_rng(seed)
    nc = int(n_pts * 0.8)
    pts = np.concatenate([0.1 + 0.12 * rng.random((nc, 3)),
                          rng.random((n_pts - nc, 3))]) - 0.5
    host = {f: np.zeros(n_pts, np.float32) for f in _FIELDS[:-1]}
    host["x"], host["y"], host["z"] = pts.T.astype(np.float32)
    host["h"] = np.full(n_pts, 0.05, np.float32)
    host["m"] = np.full(n_pts, 1.0 / n_pts, np.float32)
    host["temp"] = np.ones(n_pts, np.float32)
    return host


@pytest.mark.parametrize("D,n,data", [(2, 4, "uniform"), (4, 8, "uniform"),
                                      (8, 32, "clustered")])
def test_splits_and_distribution_equal(D, n, data):
    jb = JBox(-0.5, 0.5, -0.5, 0.5, -0.5, 0.5)
    if data == "clustered":
        host = clustered()
    else:
        host = clustered(n_pts=64 * D, seed=D)
        r = np.random.default_rng(D)
        for c in "xyz":
            host[c] = r.uniform(-0.5, 0.5, 64 * D).astype(np.float32)
    N = len(host["x"])
    cd = J.ColDomain(n_ranks=D, n=n, cap=N, halo_cap=8, mig_cap=8)
    jps = J.distribute_columns(host, jb, cd, _jmesh(D))
    mesh = SlabMesh(D, devices=["cpu"])
    tps = T.distribute_columns(host, _tbox(jb),
                               T.ColDomain(**dataclasses.asdict(cd)), mesh)
    for f in _FIELDS:
        np.testing.assert_array_equal(
            np.concatenate([getattr(p, f).numpy() for p in tps]),
            np.asarray(getattr(jps, f)), err_msg=f)

    # the in-step splits on the distributed rows (every shard the same)
    sh = NamedSharding(_jmesh(D), P(AXIS))

    def local(x, y, alive):
        q = J.flat_columns(jb, n, x, y)
        return q, J.balance_column_splits(q, alive, n, D)[None]

    fn = jax.jit(jax.shard_map(local, mesh=_jmesh(D),
                               in_specs=(P(AXIS),) * 3,
                               out_specs=(P(AXIS), P(AXIS)),
                               check_vma=False))
    jq, js = fn(*(jax.device_put(np.asarray(getattr(jps, f)), sh)
                  for f in ("x", "y", "alive")))
    box = _tbox(jb)

    def run(comm, p):
        q = T.flat_columns(box, n, p.x, p.y)
        return q, T.balance_column_splits(comm, q, p.alive, n, D)

    res = mesh.run(run, tps)
    np.testing.assert_array_equal(np.concatenate([r[0].numpy()
                                                  for r in res]), jq)
    np.testing.assert_array_equal(np.stack([r[1].numpy() for r in res]), js)
    assert np.all(np.diff(np.asarray(js)[0]) >= n + 1)
    if data == "clustered":
        counts = np.stack([p.alive.numpy() for p in tps]).sum(1)
        assert counts.max() / counts.mean() - 1.0 < 0.35, counts


def _sedov():
    state, jb, cfg = j_init_sedov(SIDE, JCfg(chunk=512, cell_cap=256,
                                             ngpad=256), dt0=2e-4)
    host = {f: np.asarray(getattr(state.p, f)) for f in _FIELDS[:-1]}
    return state, jb, cfg, host


@pytest.fixture(scope="module")
def run():
    """STEPS steps of both packages' column step at D = 2."""
    D = 2
    state, jb, cfg, host = _sedov()
    n_part = SIDE ** 3
    cd = J.ColDomain(n_ranks=D, n=N_CELLS, cap=int(n_part * 2 / D) + 256,
                     halo_cap=n_part // 2, mig_cap=512)
    jmesh = _jmesh(D)
    js = JSimState(p=J.distribute_columns(host, jb, cd, jmesh),
                   ttot=jnp.float32(0), dt=state.dt, dt_m1=state.dt_m1,
                   iteration=jnp.int32(0))
    mesh = SlabMesh(D, devices=["cpu"])
    ts = sharded_states_from_numpy(
        {f: np.asarray(getattr(js.p, f)) for f in _FIELDS}, 0.0,
        float(state.dt), float(state.dt_m1), 0, mesh)
    jstep = J.make_ve_step_pallas_hilbert(jb, cd, CAP, cfg, jmesh,
                                          interpret=True)
    tstep = T.make_ve_step_pallas_hilbert(
        _tbox(jb), T.ColDomain(**dataclasses.asdict(cd)), CAP,
        config_from_dict(dataclasses.asdict(cfg)), mesh)
    jd, td = [], []
    for _ in range(STEPS):
        js, d = jstep(js)
        jd.append({k: float(v) for k, v in d._asdict().items()})
        ts, d = tstep(ts)
        td.append({k: float(v) for k, v in d._asdict().items()})
    return dict(jd=jd, td=td, D=D,
                jf={f: np.split(np.asarray(getattr(js.p, f)), D)
                    for f in _FIELDS},
                tf={f: [getattr(s.p, f).numpy() for s in ts]
                    for f in _FIELDS})


@pytest.mark.parametrize("step", range(STEPS))
def test_step_diagnostics(run, step):
    a, b = run["jd"][step], run["td"][step]
    for k in ("lost", "n_owned", "n_total", "max_nc", "overflow",
              "row_span_ok", "imbalance"):
        assert b[k] == a[k], k
    assert b["lost"] == 0 and b["overflow"] == 0 and b["row_span_ok"] == 1
    assert b["n_total"] == SIDE ** 3
    for k in ("dt", "ttot", "etot", "eint", "h_max"):
        np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(b["ecin"], a["ecin"], rtol=1e-4)


@pytest.mark.parametrize("shard", [0, 1])
def test_step_shard_rows(run, shard):
    ja, ta = run["jf"]["alive"][shard], run["tf"]["alive"][shard]
    np.testing.assert_array_equal(ta, ja)
    for f in _FIELDS[:-1]:
        a = run["jf"][f][shard][ja]
        b = run["tf"][f][shard][ja]
        scale = max(np.abs(np.concatenate(run["jf"][f])).max(), 1e-12)
        err = np.abs(b - a).max() / scale
        assert err < 1e-5, (f, err)


def test_row_span_ok_false_on_a_short_window():
    """A 3-row window: each shard's 2 rows and its 2 halo rows need 4,
    so row_span_ok is false (the x positions past the window clip onto
    its edge cells); lost and overflow stay 0."""
    state, jb, cfg, host = _sedov()
    D, n_part = 2, SIDE ** 3
    cd = T.ColDomain(n_ranks=D, n=N_CELLS, cap=n_part, halo_cap=n_part // 2,
                     mig_cap=512, rows_cap=3)
    mesh = SlabMesh(D, devices=["cpu"])
    box = _tbox(jb)
    ps = T.distribute_columns(host, box, cd, mesh)
    ts = [T.SimState(p=p, ttot=torch.zeros(()), dt=torch.tensor(
        float(state.dt)), dt_m1=torch.tensor(float(state.dt_m1)),
        iteration=torch.zeros((), dtype=torch.int32)) for p in ps]
    step = T.make_ve_step_pallas_hilbert(
        box, cd, CAP, config_from_dict(dataclasses.asdict(cfg)), mesh)
    _, d = step(ts)
    assert not bool(d.row_span_ok)
    assert int(d.lost) == 0 and int(d.overflow) == 0
    assert int(d.n_total) == n_part
