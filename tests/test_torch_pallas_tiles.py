"""The port's 2-D tile engine (propagator/ve_pallas_tiles.py) against the
JAX package's: the split functions, the host planner and distribution,
the step at D = 2 (1 x 2 tiles), and the adapter's refusal of a shard
count that R x C tiles do not factor.

The JAX side runs under jax.jit(jax.shard_map) on the conftest's
virtual CPU devices, its Pallas stages in interpret mode; the port runs
its shards as SlabMesh threads on the CPU with the kernels' plain
versions, under two torch threads.

1. _quantile_splits (1-D and batched), _cells_of_fine, _in_span and
   _wrap_shift (spans wrapped at a = -1 and b = n + 1), tile_splits
   (psum'd histograms), plan_tile_caps and distribute_tiles exactly
   equal, on the JAX package's 80%-clustered set at R = 4, C = 2
   (tests/test_pallas_tiles.py: counts within 15% of the mean) and on a
   Sedov frame.
2. The step at Sedov 12^3, D = 2 (R = 1, C = 2: z windowed, x keeps
   its periodic layout), on the global CMGrid(n=4, cap=64) (2 h_max =
   0.240 below the 0.25 cell edge; 27 rows a cell; cap 32 has no
   z-group in the JAX make_cell_pair_call), each window exactly the
   widest tile and its two halo cells (4 cells: two owned, one wrapped
   through the periodic seam at a = -1), 2 steps from the same
   distribution: lost, n_owned, n_total, imbalance, max_nc, overflow
   and span_ok exact; dt, ttot, etot, eint, h_max at rtol 1e-5, ecin at
   1e-4 (velocities start at 0); each shard's alive rows row for row
   (the port's migrate keeps JAX's row order), every field within 1e-5 of
   its scale. D = 4 (2 x 2 tiles): tests/test_torch_pallas_tiles_d4.py.
   The frame is no smaller because at Sedov 8^3 the grid is n = 2 and a
   window of 3 cells is wider than the box: the JAX step sends the
   rows of the cell at both of its ends once, and its neighbour sets
   there are wrong (ROADMAP Queue 3); the port sends them twice and is
   held against its single-device step there instead
   (tests/test_torch_pallas_tiles_halo.py).
3. D = 5: the port's adapter refuses it, naming D, R and C; the JAX
   adapter plans R x C = 4 ranks for the 5 devices (multichip.py:218).
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
from sphexa_tpu.propagator import multichip as jmc
from sphexa_tpu.propagator import ve_pallas_tiles as J
from sphexa_tpu.sfc.box import Box as JBox
from sphexa_tpu.state import SimState as JSimState, _FIELDS
from sphexa_tpu_torch.domain.mesh import SlabMesh
from sphexa_tpu_torch.interop import (box_from_numpy, config_from_dict,
                                      sharded_states_from_numpy,
                                      state_from_numpy)
from sphexa_tpu_torch.propagator import multichip as tmc
from sphexa_tpu_torch.propagator import ve_pallas_tiles as T
from torch_threads import two_torch_threads  # noqa: F401

SIDE, STEPS = 8, 2
# the step's frame: every window within the periodic box
STEP_SIDE, N_CELLS, CAP = 12, 4, 64


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


# ---------------------------------------------------------------------------
# the split functions, the planner and the distribution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parts,min_span", [(2, 4), (3, 4), (4, 1), (1, 4)])
def test_quantile_splits_equal(parts, min_span):
    r = np.random.default_rng(parts)
    hist = np.floor(r.exponential(3.0, (5, 32)) ** 2).astype(np.float32)
    hist[1, :20] = 0.0                      # an empty run
    hist[2] = 0.0
    hist[2, 7] = 50.0                       # one heavy bin
    for h in (hist, hist[0]):
        want = np.asarray(J._quantile_splits(jnp.asarray(h), parts,
                                             min_span))
        got = T._quantile_splits(torch.from_numpy(h), parts, min_span)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            T._np_quantile_splits(h.reshape(-1, 32)[0].astype(np.int64),
                                  parts, min_span),
            J._np_quantile_splits(h.reshape(-1, 32)[0].astype(np.int64),
                                  parts, min_span))


@pytest.mark.parametrize("periodic", [True, False], ids=["per", "open"])
def test_span_helpers_equal(periodic):
    n = 6
    i = np.arange(n, dtype=np.int32)
    for a, b in [(-1, 2), (-1, n + 1), (3, n + 1), (1, 4), (0, n),
                 (4, 8), (-1, 1)]:
        ja = jnp.int32(a)
        jb_ = jnp.int32(b)
        ta, tb = torch.tensor(a, dtype=torch.int32), torch.tensor(
            b, dtype=torch.int32)
        np.testing.assert_array_equal(
            T._in_span(torch.from_numpy(i), ta, tb, n, periodic).numpy(),
            np.asarray(J._in_span(jnp.asarray(i), ja, jb_, n, periodic)))
        np.testing.assert_array_equal(
            T._wrap_shift(torch.from_numpy(i), ta, tb, n, periodic).numpy(),
            np.asarray(J._wrap_shift(jnp.asarray(i), ja, jb_, n, periodic)))
    for lo, hi in [(0, 5), (5, 12), (9, 24), (3, 4)]:
        got = T._cells_of_fine(torch.tensor(lo), torch.tensor(hi), 4)
        want = J._cells_of_fine(jnp.int32(lo), jnp.int32(hi), 4)
        assert tuple(int(v) for v in got) == tuple(int(v) for v in want)


def _sedov_host(side=SIDE):
    state, jb, cfg = j_init_sedov(side, JCfg(chunk=512, cell_cap=256,
                                             ngpad=256), dt0=2e-4)
    host = {f: np.asarray(getattr(state.p, f)) for f in _FIELDS[:-1]}
    return state, jb, cfg, host


@pytest.mark.parametrize("R,C,n,data", [(4, 2, 32, "clustered"),
                                        (2, 2, 2, "sedov"),
                                        (1, 2, 2, "sedov")])
def test_plan_distribute_and_splits_equal(R, C, n, data):
    """plan_tile_caps, distribute_tiles and the in-step tile_splits of
    the distributed rows equal the JAX package's; on the clustered set
    the counts stay within 15% of the mean."""
    if data == "clustered":
        host = clustered()
        jb = JBox(-0.5, 0.5, -0.5, 0.5, -0.5, 0.5)
    else:
        _, jb, _, host = _sedov_host()
    D, N = R * C, len(host["x"])
    box = _tbox(jb)
    part = dict(n=n, n_rows=R, n_cols=C)
    caps = T.plan_tile_caps(box, part, host["x"], host["y"], host["z"])
    assert caps == J.plan_tile_caps(jb, part, host["x"], host["y"],
                                    host["z"])
    td = J.TileDomain(n_rows=R, n_cols=C, n=n, cap=N, halo_cap=8,
                      mig_cap=8, rows_cap=caps[0] + 2,
                      zcols_cap=caps[1] + 2)
    jps = J.distribute_tiles(host, jb, td, _jmesh(D))
    mesh = SlabMesh(D, devices=["cpu"])
    tps = T.distribute_tiles(host, box, T.TileDomain(
        **dataclasses.asdict(td)), mesh)
    for f in _FIELDS:
        np.testing.assert_array_equal(
            np.concatenate([getattr(p, f).numpy() for p in tps]),
            np.asarray(getattr(jps, f)), err_msg=f)
    counts = np.stack([p.alive.numpy() for p in tps]).sum(1)
    assert counts.sum() == N
    if data == "clustered":
        assert counts.max() / counts.mean() - 1.0 < 0.15, counts

    nf = n * td.fine
    sh = NamedSharding(_jmesh(D), P(AXIS))

    def local(x, y, z, alive):
        ixf, _, izf = J._cell_coords(jb, nf, x, y, z)
        rs, cs, owner = J.tile_splits(ixf, izf, alive, nf, R, C, td.fine)
        return rs[None], cs[None], owner

    fn = jax.jit(jax.shard_map(local, mesh=_jmesh(D),
                               in_specs=(P(AXIS),) * 4,
                               out_specs=(P(AXIS),) * 3, check_vma=False))
    jrs, jcs, jown = fn(*(jax.device_put(np.asarray(getattr(jps, f)), sh)
                          for f in ("x", "y", "z", "alive")))

    def run(comm, p):
        ixf, _, izf = T._cell_coords(box, nf, p.x, p.y, p.z)
        return T.tile_splits(comm, ixf, izf, p.alive, nf, R, C, td.fine)

    res = mesh.run(run, tps)
    np.testing.assert_array_equal(np.stack([r[0].numpy() for r in res]), jrs)
    np.testing.assert_array_equal(np.concatenate([r[1][None].numpy()
                                                  for r in res]), jcs)
    np.testing.assert_array_equal(np.concatenate([r[2].numpy()
                                                  for r in res]), jown)
    # the distributed rows already sit with their owners
    own = np.concatenate([r[2].numpy() for r in res])
    alive = np.concatenate([p.alive.numpy() for p in tps])
    shard = np.repeat(np.arange(D), N)
    np.testing.assert_array_equal(own[alive], shard[alive])


# ---------------------------------------------------------------------------
# the step at D = 2
# ---------------------------------------------------------------------------

def run_tiles(R, C, side=STEP_SIDE, n=N_CELLS, cap=CAP, steps=STEPS,
              slack=0):
    """`steps` steps of both packages' tile step on Sedov side^3, on the
    global CMGrid(n, cap), the windows plan_tile_caps's + slack (the
    adapters add 2; 0 makes each window exactly the widest tile and its
    two halo cells, which span_ok then holds)."""
    D = R * C
    state, jb, cfg, host = _sedov_host(side)
    n_part = side ** 3
    rows_cap, zcols_cap = J.plan_tile_caps(
        jb, dict(n=n, n_rows=R, n_cols=C), host["x"], host["y"], host["z"])
    td = J.TileDomain(n_rows=R, n_cols=C, n=n,
                      cap=int(n_part * 2 / D) + 256, halo_cap=n_part // 2,
                      mig_cap=512, rows_cap=rows_cap + slack,
                      zcols_cap=zcols_cap + slack)
    jmesh = _jmesh(D)
    js = JSimState(p=J.distribute_tiles(host, jb, td, jmesh),
                   ttot=jnp.float32(0), dt=state.dt, dt_m1=state.dt_m1,
                   iteration=jnp.int32(0))
    mesh = SlabMesh(D, devices=["cpu"])
    ts = sharded_states_from_numpy(
        {f: np.asarray(getattr(js.p, f)) for f in _FIELDS}, 0.0,
        float(state.dt), float(state.dt_m1), 0, mesh)
    jstep = J.make_ve_step_pallas_tiles(jb, td, cap, cfg, jmesh,
                                        interpret=True)
    tstep = T.make_ve_step_pallas_tiles(
        _tbox(jb), T.TileDomain(**dataclasses.asdict(td)), cap,
        config_from_dict(dataclasses.asdict(cfg)), mesh)
    jd, td_ = [], []
    for _ in range(steps):
        js, d = jstep(js)
        jd.append({k: float(v) for k, v in d._asdict().items()})
        ts, d = tstep(ts)
        td_.append({k: float(v) for k, v in d._asdict().items()})
    return dict(jd=jd, td=td_, D=D, n_part=n_part,
                jf={f: np.split(np.asarray(getattr(js.p, f)), D)
                    for f in _FIELDS},
                tf={f: [getattr(s.p, f).numpy() for s in ts]
                    for f in _FIELDS})


def check_diag(run, step):
    a, b = run["jd"][step], run["td"][step]
    for k in ("lost", "n_owned", "n_total", "imbalance", "max_nc",
              "overflow", "span_ok"):
        assert b[k] == a[k], k
    assert b["lost"] == 0 and b["overflow"] == 0 and b["span_ok"] == 1
    assert b["n_total"] == run["n_part"]
    for k in ("dt", "ttot", "etot", "eint", "h_max"):
        np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(b["ecin"], a["ecin"], rtol=1e-4)


def check_rows(run, shard):
    ja, ta = run["jf"]["alive"][shard], run["tf"]["alive"][shard]
    np.testing.assert_array_equal(ta, ja)
    assert ja.sum() > 0
    for f in _FIELDS[:-1]:
        a = run["jf"][f][shard][ja]
        b = run["tf"][f][shard][ja]
        scale = max(np.abs(np.concatenate(run["jf"][f])).max(), 1e-12)
        err = np.abs(b - a).max() / scale
        assert err < 1e-5, (f, err)


@pytest.fixture(scope="module")
def d2():
    return run_tiles(1, 2)


@pytest.mark.parametrize("step", range(STEPS))
def test_d2_diagnostics(d2, step):
    check_diag(d2, step)


@pytest.mark.parametrize("shard", [0, 1])
def test_d2_shard_rows(d2, shard):
    check_rows(d2, shard)


# ---------------------------------------------------------------------------
# the shard count R x C must factor
# ---------------------------------------------------------------------------

def test_d5_refused(monkeypatch):
    """At D = 5 the JAX adapter's rule gives R = 2, C = 2: it plans 4
    ranks for 5 devices (one device idle, its mesh of 5 holding the 4
    ranks' rows). The port's adapter refuses, naming D, R and C; at
    D = 4 and 8 the rule factors exactly."""
    state, jb, cfg, _ = _sedov_host()
    devs = jax.devices()[:5]
    monkeypatch.setattr(jax, "devices", lambda *a: devs)
    seen = {}

    def spy(host, box, td, mesh):
        seen["td"], seen["mesh"] = td, mesh
        raise StopIteration

    monkeypatch.setattr(J, "distribute_tiles", spy)
    h_max = float(np.asarray(state.p.h).max())
    with pytest.raises(StopIteration):
        jmc.MultiChipAdapter("ve-pallas-tiles", jb, cfg, state, h_max)
    assert seen["td"].n_ranks == 4 and seen["mesh"].devices.size == 5

    monkeypatch.setenv("SPHEXA_NUM_DEVICES", "5")
    ts = state_from_numpy({f: np.asarray(getattr(state.p, f))
                           for f in _FIELDS}, 0.0, float(state.dt),
                          float(state.dt_m1), 0, device="cpu")
    with pytest.raises(SystemExit, match=r"D = 5 shards .* = 2 and "
                       r"C = D // R = 2 give R x C = 4 != 5"):
        tmc.MultiChipAdapter("ve-pallas-tiles", _tbox(jb), config_from_dict(
            dataclasses.asdict(cfg)), ts, h_max, device="cpu")
    assert [tmc.tile_factors(d) for d in (2, 4, 8, 9)] == [
        (1, 2), (2, 2), (2, 4), (2, 4)]
