"""The port's Hilbert-domain steps against the JAX package's: ve-hilbert
(make_ve_step_hilbert) and ve-tiered-sharded
(make_ve_step_tiered_hilbert), 2 steps each at Evrard 10 (552
particles, self-gravity through the gathered direct sum), D = 2, from
the same host distribution.

The JAX steps run under jax.shard_map on the conftest's virtual CPU
devices (the tiered one with its gated Pallas stages in interpret
mode); the port's shards are SlabMesh threads with the plain kernel
versions. Both migrate every step, so the shards' rows are matched by
position (as tests/test_tiered_sharded.py matches them) and held within
1e-5 of each field's scale; dt, etot and eint at rtol 1e-5, ecin at
1e-4; lost and the tier fold 0 and n_owned equal in both; the
imbalance equal. The gather caps sit above the densest cell and
neighbour count; the port's HilbertDiag reports the densest cell
(max_cell_count), which the JAX one lacks, and its max_nc over the
owned rows, whose neighbour lists alone it builds (JAX's counts the
halo rows' discarded lists too). The port's _tiered_forces
with owned=None is the single-device path, whose results
tests/test_torch_tiers.py holds.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from scipy.spatial import cKDTree

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.domain.hilbert import AXIS, HilbertConfig as JHC
from sphexa_tpu.init.evrard import init_evrard as j_init_evrard
from sphexa_tpu.neighbors import CellGrid as JCellGrid, choose_level
from sphexa_tpu.propagator.ve_hilbert import (
    distribute_hilbert as j_distribute, make_ve_step_hilbert as j_hilbert)
from sphexa_tpu.propagator.ve_tiered import choose_tiers_auto as j_tiers
from sphexa_tpu.propagator.ve_tiered_sharded import (
    make_ve_step_tiered_hilbert as j_tiered)
from sphexa_tpu.state import SimState as JSimState, _FIELDS
from sphexa_tpu_torch.domain.hilbert import HilbertConfig
from sphexa_tpu_torch.domain.mesh import SlabMesh
from sphexa_tpu_torch.interop import (box_from_numpy, config_from_dict,
                                      hilbert_config_from, tiers_from_numpy)
from sphexa_tpu_torch.neighbors import CellGrid
from sphexa_tpu_torch.propagator.ve_hilbert import (distribute_hilbert,
                                                    make_ve_step_hilbert)
from sphexa_tpu_torch.propagator.ve_tiered_sharded import \
    make_ve_step_tiered_hilbert
from sphexa_tpu_torch.state import SimState
from torch_threads import two_torch_threads  # noqa: F401

D, STEPS = 2, 2
ROWS = ("x", "y", "z", "vx", "vy", "vz", "temp", "h", "alpha", "du_m1")


@pytest.fixture(scope="module")
def setup():
    # gather caps above the densest cell (69) and neighbour count (96):
    # the JAX step has no cell_cap fail-stop (ROADMAP Queue 3)
    state, jb, cfg = j_init_evrard(10, JCfg(cell_cap=192, ngpad=256),
                                   dt0=1e-4)
    alive = np.asarray(state.p.alive)
    host = {f: np.asarray(getattr(state.p, f))[alive] for f in _FIELDS[:-1]}
    n = len(host["x"])
    kw = dict(n_ranks=D, cap=600, halo_cap=408, mig_cap=256, coarse=8,
              dilate=3)
    tb = box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                         jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])
    jhc = JHC(**kw)
    hc = hilbert_config_from(jhc)
    assert hc == HilbertConfig(**kw) and hc.ext == jhc.ext
    return dict(state=state, jb=jb, cfg=cfg, host=host, n=n, jhc=jhc,
                hc=hc, tb=tb,
                tcfg=config_from_dict(dataclasses.asdict(cfg)),
                jmesh=Mesh(np.array(jax.devices()[:D]), (AXIS,)),
                mesh=SlabMesh(D, devices=["cpu"]))


def _jax_run(s, step):
    st = s["state"]
    js = JSimState(p=j_distribute(s["host"], s["jb"], s["jhc"], s["jmesh"]),
                   ttot=st.ttot, dt=st.dt, dt_m1=st.dt_m1,
                   iteration=st.iteration)
    diags = []
    for _ in range(STEPS):
        js, d = step(js)
        diags.append({k: float(v) for k, v in d._asdict().items()})
    a = np.asarray(js.p.alive)
    return {f: np.asarray(getattr(js.p, f))[a] for f in ROWS}, diags


def _torch_run(s, step):
    st = s["state"]
    parts = distribute_hilbert(s["host"], s["tb"], s["hc"], s["mesh"])
    states = [SimState(p=p, ttot=torch.tensor(float(st.ttot)),
                       dt=torch.tensor(float(st.dt)),
                       dt_m1=torch.tensor(float(st.dt_m1)),
                       iteration=torch.tensor(int(st.iteration),
                                              dtype=torch.int32))
              for p in parts]
    diags = []
    for _ in range(STEPS):
        states, d = step(states)
        diags.append({k: float(v) for k, v in d._asdict().items()})
    rows = {f: np.concatenate([getattr(q.p, f)[q.p.alive].numpy()
                               for q in states]) for f in ROWS}
    return rows, diags


@pytest.fixture(scope="module")
def hilbert_runs(setup):
    s = setup
    h_max = float(s["host"]["h"].max())
    lvl = choose_level(s["jb"], h_max * 1.3)
    ja = _jax_run(s, j_hilbert(s["jb"], JCellGrid(lvl), s["cfg"], s["jhc"],
                               s["jmesh"]))
    tr = _torch_run(s, make_ve_step_hilbert(s["tb"], CellGrid(lvl),
                                            s["tcfg"], s["hc"], s["mesh"]))
    return ja, tr


@pytest.fixture(scope="module")
def tiered_runs(setup):
    s = setup
    h = s["host"]
    jt = j_tiers(s["jb"], h["x"], h["y"], h["z"], h["h"])
    ja = _jax_run(s, j_tiered(s["jb"], jt, s["cfg"], s["jhc"], s["jmesh"],
                              interpret=True))
    tr = _torch_run(s, make_ve_step_tiered_hilbert(
        s["tb"], tiers_from_numpy(jt), s["tcfg"], s["hc"], s["mesh"]))
    return ja, tr


def _compare(runs, n, fold):
    (ja, jd), (ta, td) = runs
    for a, b in zip(jd, td):
        assert a["lost"] == b["lost"] == 0
        assert a["n_owned"] == b["n_owned"] == n
        if fold:
            assert a["fold"] == b["fold"] == 0
        assert b["imbalance"] == a["imbalance"]
        for k, rtol in (("dt", 1e-5), ("etot", 1e-5), ("eint", 1e-5),
                        ("ecin", 1e-4)):
            np.testing.assert_allclose(b[k], a[k], rtol=rtol, err_msg=k)
    assert len(ta["x"]) == len(ja["x"]) == n
    tree = cKDTree(np.c_[ja["x"], ja["y"], ja["z"]])
    d, j = tree.query(np.c_[ta["x"], ta["y"], ta["z"]])
    assert len(np.unique(j)) == n
    for f in ROWS:
        scale = max(np.abs(ja[f]).max(), 1e-30)
        err = np.abs(ta[f] - ja[f][j]).max() / scale
        assert err <= 1e-5, (f, err)


def test_ve_hilbert_against_jax(setup, hilbert_runs):
    _compare(hilbert_runs, setup["n"], fold=False)
    (_, jd), (_, td) = hilbert_runs
    cfg = setup["cfg"]
    for a, b in zip(jd, td):
        assert "max_cell_count" not in a      # the JAX diag lacks it
        assert 0 < b["max_cell_count"] <= cfg.cell_cap
        # the port searches the owned rows only; JAX's max_nc counts the
        # halo rows' (discarded) lists too
        assert 0 < b["max_nc"] <= a["max_nc"] <= cfg.ngpad


def test_ve_tiered_sharded_against_jax(setup, tiered_runs):
    _compare(tiered_runs, setup["n"], fold=True)
