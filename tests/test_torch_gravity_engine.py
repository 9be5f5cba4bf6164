"""The port's engines with self-gravity against the JAX package, Evrard
10 (523 particles in an open cube, gravG = 1), under the direct sum and
the FMM (level 4, min_sep 3).

- ResidentVE against the JAX ResidentVE (Pallas in interpret mode)
  from the same state (the setup of tests/test_bdt.py:
  test_bdt_gravity_matches_plain): dt, eint and ecin at rtol 1e-5, the
  gravitational energy (etot - ecin - eint) at rtol 1e-4 (as
  tests/test_pallas_ve.py's Evrard check), nf_truncated equal, and the
  valid interior slots' rows within 1e-5 of each row's scale. Two steps
  under the direct sum, one under the FMM: the JAX engine runs the FMM
  over every slot, and its L2P at the invalid slots' FILL_POS
  coordinates returns accelerations near 1e16, which move those slots
  below 0.5 FILL_POS, so its second step reads them as particles and
  its dt is NaN. The port solves on the valid slots only and keeps
  FILL_POS there (test_resident_fmm_keeps_frame_contract).
- make_ve_step_cellmajor against make_ve_step_pallas for two steps
  under the FMM (the particle frame drops the invalid slots each step).
- BdtVE(num_rungs=1) against ResidentVE with gravity (port only): a
  one-rung cycle is one all-active step.
- The sharded engines with the slab FMM: the gravitational energy of
  their first step equals ResidentVE's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.init.evrard import init_evrard as j_init_evrard
from sphexa_tpu.ops.cellmajor import choose_cap_and_grid
from sphexa_tpu.propagator.ve_pallas import ResidentVE as JResidentVE
from sphexa_tpu.propagator.ve_pallas import make_ve_step_pallas
from sphexa_tpu.state import _FIELDS
from sphexa_tpu_torch.interop import (box_from_numpy, config_from_dict,
                                      state_from_numpy)
from sphexa_tpu_torch.ops.cellmajor import CMGrid
from sphexa_tpu_torch.propagator.ve_bdt import BdtVE
from sphexa_tpu_torch.propagator.ve_cellmajor import (ResidentVE,
                                                      make_ve_step_cellmajor)
from torch_threads import one_torch_thread  # noqa: F401

SOLVERS = ("direct", "fmm")
# (solver, step) pairs held against the JAX ResidentVE
CASES = [("direct", 0), ("direct", 1), ("fmm", 0)]
STEPS = {"direct": 2, "fmm": 1}
ROWS = ("x", "y", "z", "h", "vx", "vy", "vz", "temp", "alpha", "du_m1",
        "x_m1", "y_m1", "z_m1")


def _frame(solver):
    """The JAX Evrard 10 state, box, config and resident grid, and the
    same as the port's objects (state on the CPU)."""
    cfg = JCfg(chunk=512, cell_cap=512, ngpad=256, gravity_solver=solver)
    state, jb, cfg = j_init_evrard(10, cfg, dt0=1e-4)
    p = state.p
    alive = np.asarray(p.alive)
    _, grid = choose_cap_and_grid(
        jb, float(np.asarray(p.h)[alive].max()) * 1.2, int(alive.sum()),
        *(np.asarray(getattr(p, c))[alive] for c in "xyz"),
        cap_min=32, cap_max=512)
    host = ({f: np.asarray(getattr(p, f)) for f in _FIELDS},
            float(state.ttot), float(state.dt), float(state.dt_m1),
            int(state.iteration))
    tb = box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                         jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    return dict(state=state, jb=jb, cfg=cfg, grid=grid, host=host, tb=tb,
                tcfg=tcfg, tgrid=CMGrid(n=grid.n, cap=grid.cap))


def _gravity_energy(d):
    return float(d["etot"]) - float(d["ecin"]) - float(d["eint"])


def _resident_run(solver):
    f = _frame(solver)
    jeng = JResidentVE(f["jb"], f["grid"], f["cfg"], interpret=True)
    jr = jeng.bind(f["state"])
    jd = []
    for _ in range(STEPS[solver]):
        jr, d = jeng.step(jr)
        jd.append({k: np.asarray(v) for k, v in d._asdict().items()})
    jrows = {r: np.asarray(getattr(jr, r)) for r in ROWS + ("valid",)}

    teng = ResidentVE(f["tb"], f["tgrid"], f["tcfg"], device="cpu")
    tr = teng.bind(state_from_numpy(*f["host"], device="cpu"))
    td = []
    for _ in range(STEPS[solver]):
        tr, d = teng.step(tr)
        td.append({k: np.asarray(v) for k, v in d._asdict().items()})
    trows = {r: getattr(tr, r).numpy() for r in ROWS + ("valid",)}
    return dict(jd=jd, td=td, jrows=jrows, trows=trows,
                intmask=teng.intmask.numpy(), frame=f, teng=teng, tr=tr)


@pytest.fixture(scope="module")
def resident():
    return {s: _resident_run(s) for s in SOLVERS}


@pytest.mark.parametrize("solver,step", CASES)
def test_resident_diagnostics(resident, solver, step):
    a, b = resident[solver]["jd"][step], resident[solver]["td"][step]
    assert int(b["overflow"]) == int(a["overflow"]) == 0
    assert bool(b["rebinned"]) == bool(a["rebinned"])
    assert int(b["nf_truncated"]) == int(a["nf_truncated"]) == 0
    np.testing.assert_allclose(b["dt"], a["dt"], rtol=1e-5)
    np.testing.assert_allclose(b["eint"], a["eint"], rtol=1e-5)
    np.testing.assert_allclose(b["ecin"], a["ecin"], rtol=1e-5)
    np.testing.assert_allclose(_gravity_energy(b), _gravity_energy(a),
                               rtol=1e-4)
    assert _gravity_energy(b) < 0.0


@pytest.mark.parametrize("solver", SOLVERS)
def test_resident_rows(resident, solver):
    """Every valid interior slot's rows after the steps, at 1e-5 of each
    row's scale (the layouts agree: no rebin in two steps)."""
    run = resident[solver]
    j, t = run["jrows"], run["trows"]
    np.testing.assert_array_equal(t["valid"], j["valid"])
    mask = j["valid"] & run["intmask"]
    for r in ROWS:
        a, b = j[r][mask], t[r][mask]
        scale = max(np.abs(a).max(), 1e-30)
        assert np.abs(b - a).max() <= 1e-5 * scale, r


@pytest.mark.parametrize("solver", SOLVERS)
def test_resident_collapses(resident, solver):
    """Gravity pulls the cold sphere inward: nearly every particle has
    a negative radial velocity after the steps."""
    run = resident[solver]
    t = run["trows"]
    mask = t["valid"] & run["intmask"]
    vr = sum(t[c][mask] * t[v][mask] for c, v in
             (("x", "vx"), ("y", "vy"), ("z", "vz")))
    assert np.mean(vr < 0) > 0.9


def test_resident_fmm_keeps_frame_contract(resident):
    """Two more FMM steps on the port: the invalid slots keep FILL_POS
    (gravity adds 0 there), the valid rows stay finite, dt is finite."""
    from sphexa_tpu_torch.ops.pair_ve import FILL_POS

    run = resident["fmm"]
    eng, rst = run["teng"], run["tr"]
    for _ in range(2):
        rst, d = eng.step(rst)
        assert np.isfinite(float(d.dt)) and int(d.nf_truncated) == 0
    inval = ~rst.valid.numpy()
    for c in ("x", "y", "z"):
        assert (getattr(rst, c).numpy()[inval] == np.float32(FILL_POS)).all()
    for r in ROWS:
        assert np.isfinite(getattr(rst, r).numpy()).all(), r


def test_particle_frame_step():
    """make_ve_step_cellmajor against make_ve_step_pallas, two FMM
    steps."""
    f = _frame("fmm")
    jstep = make_ve_step_pallas(f["jb"], f["grid"], f["cfg"],
                                interpret=True)
    tstep = make_ve_step_cellmajor(f["tb"], f["tgrid"], f["tcfg"],
                                   device="cpu")
    js, ts = f["state"], state_from_numpy(*f["host"], device="cpu")
    for _ in range(2):
        js, jd = jstep(js)
        ts, td = tstep(ts)
        assert int(td.max_cell_count) == int(jd.max_cell_count) == 0
        assert int(td.nf_truncated) == int(jd.nf_truncated) == 0
        np.testing.assert_allclose(float(td.dt), float(jd.dt), rtol=1e-5)
        np.testing.assert_allclose(float(td.eint), float(jd.eint),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(td.ecin), float(jd.ecin),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(td.egrav), float(jd.egrav),
                                   rtol=1e-4)
    alive = np.asarray(js.p.alive)
    for c in ("x", "vx", "vy", "vz", "h", "temp"):
        a = np.asarray(getattr(js.p, c))[alive]
        b = getattr(ts.p, c).numpy()[alive]
        assert np.abs(b - a).max() <= 1e-5 * max(np.abs(a).max(), 1e-30), c


@pytest.mark.parametrize("solver", SOLVERS)
def test_bdt_one_rung_is_the_resident_step(solver):
    """tests/test_bdt.py::test_bdt_gravity_matches_plain on the port:
    BdtVE(num_rungs=1) for two cycles against two ResidentVE steps with
    gravity (same pipeline, solver and dt candidates, the acceleration
    limit included)."""
    f = _frame(solver)
    tstate = state_from_numpy(*f["host"], device="cpu")
    bdt = BdtVE(f["tb"], f["tgrid"], f["tcfg"], num_rungs=1, device="cpu")
    bst = bdt.bind_bdt(tstate)
    diags = []
    for _ in range(2):
        bst, ds = bdt.run_cycle(bst)
        diags += ds
    db = diags[-1]
    plain = ResidentVE(f["tb"], f["tgrid"], f["tcfg"], device="cpu")
    rst = plain.bind(tstate)
    for _ in range(2):
        rst, dp = plain.step(rst)
    assert int(db.overflow) == 0
    np.testing.assert_allclose(float(db.dt), float(dp.dt), rtol=1e-5)
    np.testing.assert_allclose(float(db.eint), float(dp.eint), rtol=1e-5)
    np.testing.assert_allclose(float(db.ecin), float(dp.ecin), rtol=1e-3,
                               atol=1e-10)
    np.testing.assert_allclose(float(db.etot), float(dp.etot), rtol=1e-4)
    np.testing.assert_allclose(bst.rv.x.numpy(), rst.x.numpy(), rtol=0,
                               atol=5e-6)


def test_sharded_engines_refuse_gravity():
    """The sharded engines no longer refuse gravG != 0 (the name is kept
    from when they did): on the Evrard 10 FMM frame (level 4) at D = 2,
    on plan_slab's plan, the first step of make_ve_step_pallas_sharded
    and the first substep of ShardedBdtVE (the slab FMM across the
    shards) give the gravitational energy (etot - ecin - eint) of the
    single-device ResidentVE's first step at rtol 1e-5, with no lost
    row and no gravity or slot overflow."""
    import torch

    from sphexa_tpu_torch.domain.mesh import SlabMesh
    from sphexa_tpu_torch.propagator.multichip import _host_fields
    from sphexa_tpu_torch.propagator.ve_bdt_sharded import ShardedBdtVE
    from sphexa_tpu_torch.propagator.ve_pallas_sharded import (
        make_ve_step_pallas_sharded)
    from sphexa_tpu_torch.propagator.ve_sharded import distribute, plan_slab
    from sphexa_tpu_torch.state import SimState

    f = _frame("fmm")
    tstate = state_from_numpy(*f["host"], device="cpu")
    teng = ResidentVE(f["tb"], f["tgrid"], f["tcfg"], device="cpu")
    _, d1 = teng.step(teng.bind(tstate))
    eg1 = float(d1.etot) - float(d1.ecin) - float(d1.eint)
    assert eg1 < 0.0

    host = _host_fields(tstate.p)
    grid, sc = plan_slab(host, f["tb"], float(host["h"].max()), 2)
    mesh = SlabMesh(2, devices=["cpu"])
    states = [SimState(p=p, ttot=tstate.ttot, dt=tstate.dt,
                       dt_m1=tstate.dt_m1, iteration=tstate.iteration)
              for p in distribute(host, f["tb"], sc, mesh)]
    step = make_ve_step_pallas_sharded(f["tb"], grid, f["tcfg"], sc, mesh)
    _, d2 = step(states)
    assert int(d2.lost) == 0 and int(d2.overflow) == 0
    assert int(d2.n_owned) == len(host["x"])
    eng = ShardedBdtVE(f["tb"], grid, f["tcfg"], sc, mesh, num_rungs=1)
    _, d3 = eng.substep(eng.distribute_bind(tstate))
    assert int(d3.overflow) == 0
    for d in (d2, d3):
        eg = float(d.etot) - float(d.ecin) - float(d.eint)
        np.testing.assert_allclose(eg, eg1, rtol=1e-5)
    assert torch.isfinite(d3.dt)


def test_resident_ewald_on_periodic_box():
    """The Ewald solver through ResidentVE on a periodic Sedov 6 frame
    with gravG = 1 (port only): the step's gravitational energy equals
    ewald_gravity's on the particles it was given (rtol 1e-5), and an
    open box is refused, as the JAX solver refuses it."""
    from sphexa_tpu_torch.config import SphConfig
    from sphexa_tpu_torch.gravity.direct import egrav
    from sphexa_tpu_torch.gravity.ewald import ewald_gravity
    from sphexa_tpu_torch.init.sedov import init_sedov
    from sphexa_tpu_torch.sfc.box import Box, Boundary

    state, box, cfg = init_sedov(6, SphConfig(), dt0=1e-6, device="cpu")
    cfg = cfg.replace(gravG=1.0, gravity_solver="ewald")
    p = state.p
    grid = CMGrid(n=2, cap=64)
    eng = ResidentVE(box, grid, cfg, device="cpu")
    _, d = eng.step(eng.bind(state))
    g = ewald_gravity(p.x, p.y, p.z, p.m, p.alive, box, 1.0, eps=cfg.eps)
    want = float(egrav(p.m, g.pot, p.alive))
    got = float(d.etot) - float(d.ecin) - float(d.eint)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert int(d.nf_truncated) == 0 and int(d.overflow) == 0

    open_box = Box.cube(box.xmin, box.xmax, Boundary.open)
    eng = ResidentVE(open_box, grid, cfg, device="cpu")
    with pytest.raises(ValueError, match="periodic"):
        eng.step(eng.bind(state))


def test_interop_carries_gravity_config():
    """config_from_dict takes the JAX Evrard config with every gravity
    field set away from its default."""
    cfg = JCfg(gravity_solver="fmm", fmm_level=6, fmm_min_sep=2, eps=0.01,
               eta_acc=0.3)
    _, _, cfg = j_init_evrard(10, cfg)
    t = config_from_dict(dataclasses.asdict(cfg))
    for k in ("gravG", "gravity_solver", "fmm_level", "fmm_min_sep", "eps",
              "eta_acc"):
        assert getattr(t, k) == getattr(cfg, k), k
    assert t.gravG == 1.0
