"""The port's h-tier planner and particle-frame tiered step against the
JAX package (sphexa_tpu/propagator/ve_tiered.py), and the tiered props
through the port's main.

Planner (host numpy, the band audit and cell counts in C): the same
tiers, exactly (bands, CMGrids, sub-boxes and their boundaries, shift),
for
  - Evrard 20, choose_tiers_auto(cap_max=128) and choose_tiers(cap_max=
    128) (tests/test_tiered.py:18-21's setup);
  - the periodic spiked cluster of tests/test_tiered.py:185 (Evrard 20
    scaled to 45% and rolled to the corner of a periodic box): its tiers
    zoom in the rolled frame, so choose_shift and the float32 roll run;
  - choose_tiers_robust on Evrard 20 with a tail of 1% of the particles
    at 6 h, which no rung of the ladder fits until the tail is clipped;
and audit_tiers in C against its numpy form and the JAX package on
clean plans and on planted violations (tests/test_tiered.py:42-64).

Step: Evrard 10 (552 particles, the direct sum) on the two tiers the
JAX choose_tiers gives with cap_max=128, cap_max_top=64, theta=1.3,
grid_slack=1.0, top_headroom=1.0, headroom=0: CMGrid(n=2, cap=64) for
h >= 0.2875 and CMGrid(n=2, cap=128) below (at Evrard 10-14 no plan has
two tiers and a clean audit at small caps; this one's theta band drops
48 in-support pairs, identically in both packages). The JAX reference
is make_ve_step_pallas_tiered's split_gravity composition
(ve_tiered.py:553-585: sph_part, grav_part, finish), with sph_part
jitted once (Pallas in interpret mode) for both configurations, gravG 0
and the direct sum, since it does not read gravG: one interpret-mode
compile for the file. Tolerances as tests/test_torch_gravity_engine.py:
dt, eint, ecin at rtol 1e-5, egrav at rtol 1e-4, fold and fold_parts
equal; the particle rows after the step and every row of the tiered
forces within 1e-5 of each row's scale (nc and nonconv exactly).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.init.evrard import init_evrard as j_init_evrard
from sphexa_tpu.observables import evrard_solution as j_ev
from sphexa_tpu.propagator import ve_tiered as J
from sphexa_tpu.propagator.common import finish_step as j_finish_step
from sphexa_tpu.propagator.ve_pallas import _add_gravity as j_add_gravity
from sphexa_tpu.sfc.box import Box as JBox
from sphexa_tpu.sfc.box import Boundary as JBoundary
from sphexa_tpu.state import _FIELDS
from sphexa_tpu_torch.interop import (box_from_numpy, config_from_dict,
                                      state_from_numpy, tiers_from_numpy)
from sphexa_tpu_torch.main import main
from sphexa_tpu_torch.observables import evrard_solution as t_ev
from sphexa_tpu_torch.ops.cellmajor import (CMGrid, max_cell_count,
                                            max_cell_count_plain)
from sphexa_tpu_torch.propagator import ve_tiered as T
from sphexa_tpu_torch.sfc.box import Box


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads (tests/test_torch_bdt.py: the plain stages on
    these small frames are many small ops)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _tbox(jb) -> Box:
    return box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                           jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])


def _evrard(side, gravG=None):
    cfg = JCfg(chunk=512, cell_cap=512, ngpad=256, gravity_solver="direct")
    state, box, cfg = j_init_evrard(side, cfg, dt0=1e-4)
    if gravG is not None:
        cfg = cfg.replace(gravG=gravG)
    return state, box, cfg


def _xyzh(state):
    p = state.p
    return [np.asarray(getattr(p, c)) for c in "xyzh"], np.asarray(p.alive)


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------

def _periodic_cluster():
    """tests/test_tiered.py:185's positions and h (float32, as its
    make_particles stores them) in the periodic [-1, 1) box."""
    state, _, _ = _evrard(20)
    p = state.p
    scale = 0.45

    def wrap(v):
        return (np.mod(np.asarray(v) * scale + 1.0 + 1.0, 2.0)
                - 1.0).astype(np.float32)

    xyzh = [wrap(p.x), wrap(p.y), wrap(p.z),
            (np.asarray(p.h) * scale).astype(np.float32)]
    jb = JBox.cube(-1.0, 1.0, JBoundary.periodic)
    return xyzh, np.ones(len(xyzh[0]), bool), jb


def _planner_inputs():
    state, jb, _ = _evrard(20)
    xyzh, alive = _xyzh(state)
    # a tail of 1% at 6 h: no rung fits until choose_tiers_robust clips it
    h_tail = xyzh[3].copy()
    idx = np.flatnonzero(alive)[::100]
    h_tail[idx] *= 6.0
    return {"evrard": (xyzh, alive, jb),
            "periodic": _periodic_cluster(),
            "tail": (xyzh[:3] + [h_tail], alive, jb)}


def _plan(pkg, case, inputs):
    """(tiers, h_clip) of one planner case in one package."""
    xyzh, alive, jb = inputs[{"evrard_auto": "evrard",
                              "evrard_greedy": "evrard",
                              "periodic_auto": "periodic",
                              "tail_robust": "tail"}[case]]
    box = jb if pkg is J else _tbox(jb)
    if case == "evrard_greedy":
        return pkg.choose_tiers(box, *xyzh, alive=alive, cap_max=128), None
    if case == "tail_robust":
        return pkg.choose_tiers_robust(box, *xyzh, alive=alive, cap_max=128)
    return pkg.choose_tiers_auto(box, *xyzh, alive=alive, cap_max=128), None


PLAN_CASES = ("evrard_auto", "evrard_greedy", "periodic_auto",
              "tail_robust")


@pytest.fixture(scope="module")
def plans():
    inputs = _planner_inputs()
    return {c: (_plan(J, c, inputs), _plan(T, c, inputs))
            for c in PLAN_CASES}, inputs


def _sub(t):
    s = t.sub
    return ([s.xmin, s.xmax, s.ymin, s.ymax, s.zmin, s.zmax],
            [b.value for b in (s.bx, s.by, s.bz)])


@pytest.mark.parametrize("aspect", ("bands", "grids", "subboxes", "shift"))
@pytest.mark.parametrize("case", PLAN_CASES)
def test_planner_matches(plans, case, aspect):
    (jt, jclip), (tt, tclip) = plans[0][case]
    assert jt is not None and len(tt) == len(jt)
    assert tclip == jclip
    for a, b in zip(jt, tt):
        if aspect == "bands":
            assert (b.h_lo, b.h_hi, b.cutoff) == (a.h_lo, a.h_hi, a.cutoff)
        elif aspect == "grids":
            assert (b.grid.n, b.grid.cap, b.grid.nzi, b.grid.nxi) == \
                (a.grid.n, a.grid.cap, a.grid.nzi, a.grid.nxi)
            assert b.grid.cap % 32 == 0 and b.grid.cap <= 1024
        elif aspect == "subboxes":
            assert _sub(b) == _sub(a)
        else:
            assert tuple(b.shift) == tuple(a.shift)


def test_planner_cases_reach_their_branches(plans):
    """Evrard 20 has two tiers; the periodic cluster zooms through a
    nonzero roll (the float32 roll ran); the tail needs a clip."""
    p, _ = plans
    assert len(p["evrard_auto"][1][0]) >= 2
    tiers = p["periodic_auto"][1][0]
    assert any(s != 0.0 for s in tiers[0].shift)
    assert any(t.sub.lx < 2.0 for t in tiers)
    assert p["tail_robust"][1][1] is not None


def test_float32_roll_matches_jax():
    """tier_coords on host arrays: the JAX planner's float32 roll, bit
    for bit, every dim float32 once any dim is shifted."""
    (x, y, z, _), _, jb = _periodic_cluster()
    x64, y64, z64 = (v.astype(np.float64) + 1e-3 for v in (x, y, z))
    shift = (0.53125, 0.0, 1.96875)
    want = J.tier_coords(jb, shift, jnp.asarray(x64), jnp.asarray(y64),
                         jnp.asarray(z64))
    got = T.tier_coords(_tbox(jb), shift, x64, y64, z64)
    for a, b in zip(want, got):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b, np.asarray(a))
    tx = T.tier_coords(_tbox(jb), shift, *(torch.from_numpy(
        v.astype(np.float32)) for v in (x64, y64, z64)))
    for a, b in zip(want, tx):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


AUDIT_CASES = ("evrard_clean", "evrard_planted", "periodic_clean",
               "periodic_planted")


@pytest.mark.parametrize("case", AUDIT_CASES)
def test_audit_matches(plans, case):
    """audit_tiers in C, its numpy form and the JAX package count the
    same violations: 0 on the planned tiers, > 0 with the band cut
    planted past h_lo (cutoff = 1.5 h_lo, tests/test_tiered.py:51)."""
    p, inputs = plans
    src = "evrard" if case.startswith("evrard") else "periodic"
    xyzh, alive, jb = inputs[src]
    jt = p[f"{src}_auto"][0][0]
    if case.endswith("planted"):
        jt = [dataclasses.replace(t, cutoff=t.h_lo * 1.5) if t.cutoff > 0
              else t for t in jt]
    tt = tiers_from_numpy(jt)
    want = J.audit_tiers(jt, jb, *xyzh, alive=alive)
    got = T.audit_tiers(tt, _tbox(jb), *xyzh, alive=alive)
    plain = sum(T._band_audit_plain(*a) for a in T._audit_sets(
        tt, _tbox(jb), *xyzh, alive=alive))
    assert got == plain == want
    assert (want > 0) == case.endswith("planted")


@pytest.mark.parametrize("n", (2, 5, 13))
def test_max_cell_count_c_against_numpy(n):
    """ops/cellmajor.max_cell_count (C) against its numpy form, on
    positions that land on cell faces (float32 grid points) and inside."""
    rng = np.random.default_rng(n)
    box = Box(-1.0, 1.0, -0.5, 0.5, 0.0, 3.0)
    x = np.concatenate([rng.uniform(-1, 1, 3000),
                        np.linspace(-1, 1, 4 * n + 1)]).astype(np.float32)
    y = np.concatenate([rng.normal(0, 0.2, 3000),
                        np.linspace(-0.5, 0.5, 4 * n + 1)]).astype(
                            np.float32)
    z = np.concatenate([rng.uniform(0, 3, 3000),
                        np.linspace(0, 3, 4 * n + 1)]).astype(np.float32)
    g = CMGrid(n=n, nzi=n + 1, nxi=n + 2)
    assert max_cell_count(g, box, x, y, z) == \
        max_cell_count_plain(g, box, x, y, z)


# ---------------------------------------------------------------------------
# the particle-frame tiered step
# ---------------------------------------------------------------------------

STEP_CASES = ("nograv", "direct")
FORCE_ROWS = ("ax", "ay", "az", "du", "maxvsignal", "h", "alpha", "c",
              "divv", "curlv", "rho", "p", "kx", "xm")
STATE_ROWS = ("x", "y", "z", "vx", "vy", "vz", "h", "temp", "alpha",
              "du_m1")


def _engine_tiers(state, box):
    xyzh, alive = _xyzh(state)
    return J.choose_tiers(box, *xyzh, alive=alive, cap_max=128,
                          cap_max_top=64, theta=1.3, grid_slack=1.0,
                          top_headroom=1.0, headroom=0)


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def steps():
    state, jb, jcfg = _evrard(10)
    jt = _engine_tiers(state, jb)
    engines = J._tier_engines(jt, jcfg, True)

    @jax.jit
    def sph_part(state):
        layouts = J._build_layouts(engines, jb, state.p)
        return J._tiered_forces(state.p, state.dt, layouts, engines, jb,
                                jcfg)

    tb, tt = _tbox(jb), tiers_from_numpy(jt)
    host = ({f: np.asarray(getattr(state.p, f)) for f in _FIELDS},
            float(state.ttot), float(state.dt), float(state.dt_m1),
            int(state.iteration))
    fo = sph_part(state)
    out = {"tiers": jt, "jfo": _np(fo)}
    ts = state_from_numpy(*host, device="cpu")
    eng = T._tier_engines(tt, config_from_dict(dataclasses.asdict(jcfg)),
                          "cpu")
    tfo = T._tiered_forces(ts.p, ts.dt, T._build_layouts(eng, tb, ts.p),
                           eng, tb, config_from_dict(dataclasses.asdict(
                               jcfg)))
    out["tfo"] = {k: v.numpy() for k, v in tfo.items()}
    for case in STEP_CASES:
        cfg = jcfg.replace(gravG=0.0) if case == "nograv" else jcfg

        # the split composition of make_ve_step_pallas_tiered
        @jax.jit
        def grav_part(x, y, z, m, alive, ax, ay, az, cfg=cfg):
            o = dict(ax=ax, ay=ay, az=az, du=jnp.zeros_like(ax),
                     maxvsignal=jnp.zeros_like(ax))
            o, egrav, nf = j_add_gravity(o, x, y, z, m, alive, jb, cfg)
            return o["ax"], o["ay"], o["az"], egrav, nf

        @jax.jit
        def finish(state, fo, ax, ay, az, egrav, nf_trunc, cfg=cfg):
            ps = state.p
            ps2 = ps.replace(h=fo["h"], alpha=fo["alpha"])
            max_nc = jnp.max(jnp.where(ps.alive, fo["nc_sph"] - 1.0, 0.0))
            return j_finish_step(
                state, ps2, ax, ay, az, fo["du"], fo["maxvsignal"],
                fo["c"], fo["divv"], fo["nc_sph"], jb, cfg,
                max_nc=max_nc.astype(jnp.int32),
                max_cell_count=fo["fold"].astype(jnp.int32), egrav=egrav,
                nf_truncated=nf_trunc, rho=fo["rho"], p=fo["p"])

        ps = state.p
        g = grav_part(ps.x, ps.y, ps.z, ps.m, ps.alive, fo["ax"], fo["ay"],
                      fo["az"])
        js, jd = finish(state, fo, *g)
        tstep = T.make_ve_step_tiered(
            tb, tt, config_from_dict(dataclasses.asdict(cfg)), device="cpu")
        ts2, td = tstep(state_from_numpy(*host, device="cpu"))
        out[case] = dict(
            jd=_np(jd._asdict()) | {"egrav": float(jd.egrav)},
            td={k: np.asarray(v) for k, v in td._asdict().items()
                if v is not None},
            js={f: np.asarray(getattr(js.p, f)) for f in STATE_ROWS},
            ts={f: getattr(ts2.p, f).numpy() for f in STATE_ROWS})
    out["alive"] = np.asarray(state.p.alive)
    return out


def test_engine_frame_has_two_tiers(steps):
    jt = steps["tiers"]
    assert len(jt) == 2
    assert [(t.grid.n, t.grid.cap) for t in jt] == [(2, 64), (2, 128)]


@pytest.mark.parametrize("row", FORCE_ROWS)
def test_tiered_forces_rows(steps, row):
    """Every merged particle-frame row of the five tiered stages, alive
    rows within 1e-5 of the row's scale."""
    alive = steps["alive"]
    a, b = steps["jfo"][row][alive], steps["tfo"][row][alive]
    scale = max(np.abs(a).max(), 1e-30)
    assert np.abs(b - a).max() <= 1e-5 * scale, row


def test_tiered_forces_counts(steps):
    """nc and nonconv exactly; fold and its four parts equal."""
    j, t = steps["jfo"], steps["tfo"]
    np.testing.assert_array_equal(t["nc_sph"], j["nc_sph"])
    np.testing.assert_array_equal(t["nonconv"], j["nonconv"])
    assert int(t["fold"]) == int(j["fold"]) == 0
    np.testing.assert_array_equal(t["fold_parts"], j["fold_parts"])


@pytest.mark.parametrize("case", STEP_CASES)
def test_step_diagnostics(steps, case):
    a, b = steps[case]["jd"], steps[case]["td"]
    for k in ("dt", "eint", "ecin"):
        np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(b["egrav"]), a["egrav"], rtol=1e-4)
    assert (float(b["egrav"]) < 0.0) == (case == "direct")
    for k in ("max_cell_count", "max_nc", "nf_truncated"):
        assert int(b[k]) == int(a[k]), k


@pytest.mark.parametrize("row", STATE_ROWS)
@pytest.mark.parametrize("case", STEP_CASES)
def test_step_rows(steps, case, row):
    alive = steps["alive"]
    a, b = steps[case]["js"][row][alive], steps[case]["ts"][row][alive]
    scale = max(np.abs(a).max(), 1e-30)
    assert np.abs(b - a).max() <= 1e-5 * scale, row


# ---------------------------------------------------------------------------
# observables/evrard_solution and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ("rho", "p", "vr"))
def test_evrard_solution_matches(kind):
    """The tables bit-equal, the L1 helper equal, at the three times and
    between them."""
    rng = np.random.default_rng(3)
    r = np.sort(rng.uniform(0.005, 1.2, 200))
    for t in (0.77, 1.0, 1.29, 2.0, 2.58):
        for a, b in zip(j_ev.solution(kind, t), t_ev.solution(kind, t)):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        ys = np.interp(r, *j_ev.solution(kind, t)[:2]) * (
            1.0 + 0.1 * rng.standard_normal(r.size))
        for log_interp in (True, False):
            assert t_ev.l1_error(r, ys, kind, t, log_interp) == \
                j_ev.l1_error(r, ys, kind, t, log_interp)


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("SPHEXA_PLATFORM", "cpu")
    monkeypatch.setenv("SPHEXA_BDT_RUNGS", "2")


@pytest.mark.parametrize("prop", ("ve-tiered", "ve-tiered-resident",
                                  "ve-tiered-bdt"))
def test_cli_runs_tiers(cpu, tmp_path, capsys, prop):
    """main at Evrard 8 on the CPU: the tiers line printed, the steps
    taken, rows finite, the energy kept."""
    consts = tmp_path / "c.txt"
    st = main(["--init", "evrard", "-n", "8", "-s", "2", "--prop", prop,
               "--constants", str(consts)])
    out = capsys.readouterr().out
    assert "# tiers: slack=" in out and "# tiers: h[" in out
    for f in ("x", "vx", "h", "temp"):
        assert torch.isfinite(getattr(st.p, f)).all(), f
    rows = np.loadtxt(consts, ndmin=2)
    assert rows.shape[0] == 2
    if prop != "ve-tiered-bdt":
        assert int(st.iteration) == 3
    etot = rows[:, 3]
    assert abs(etot[-1] - etot[0]) <= 5e-3 * abs(etot[0])


# ---------------------------------------------------------------------------
# JAX CLI faults the port reproduces (ROADMAP Queue 3)
# ---------------------------------------------------------------------------

def test_cli_planner_raises_on_grown_edge_h(plans):
    """The CLI re-plans with choose_tiers_auto (JAX main.py:225), which
    raises once the sphere's edge h has grown past what any rung's band
    audit allows; choose_tiers_robust (the JAX bench's planner) clips the
    tail and plans. Evrard 20 with h x 3 on its 192 particles at r >
    0.99, a stronger form of the edge growth that makes Evrard 100 fail
    the CLI's re-plan after one step on the card (chip_smoke.py phase
    (o), EXPECTED_TIER_FAULT): both packages raise the same error and
    clip at the same h."""
    xyzh, alive, jb = plans[1]["evrard"]
    x, y, z, h = xyzh
    r = np.sqrt(x.astype(np.float64) ** 2 + y ** 2 + z ** 2)
    h3 = np.where(r > 0.99, h * 3.0, h).astype(np.float32)
    msgs = []
    for pkg, box in ((J, jb), (T, _tbox(jb))):
        with pytest.raises(ValueError, match="no feasible") as e:
            pkg.choose_tiers_auto(box, x, y, z, h3, alive=alive,
                                  cap_max=128)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "band audit violations" in msgs[0]
    (jt, jclip), (tt, tclip) = (
        pkg.choose_tiers_robust(box, x, y, z, h3, alive=alive, cap_max=128)
        for pkg, box in ((J, jb), (T, _tbox(jb))))
    assert tclip == jclip is not None
    assert [(t.grid, t.h_lo, _sub(t)) for t in tt] == \
        [(CMGrid(n=t.grid.n, cap=t.grid.cap), t.h_lo, _sub(t)) for t in jt]


def test_tiered_bdt_cli_reports_no_max_nc(cpu, monkeypatch):
    """The ve-tiered-bdt adapter's diagnostics carry max_nc 0 (JAX
    main.py:271), so the loop's max_nc > ngpad fail-stop never fires
    under it: with ngpad 1, --prop ve-tiered fail-stops on max_nc and
    ends after three re-plans, while ve-tiered-bdt runs."""
    from sphexa_tpu_torch import main as cli
    build = cli.build_sim

    def small_ngpad(args, device):
        state, box, cfg, extras = build(args, device)
        return state, box, cfg.replace(ngpad=1), extras

    monkeypatch.setattr(cli, "build_sim", small_ngpad)
    argv = ["--init", "evrard", "-n", "8", "-s", "1", "--quiet",
            "--constants", ""]
    with pytest.raises(RuntimeError, match="max_nc="):
        main(argv + ["--prop", "ve-tiered"])
    st = main(argv + ["--prop", "ve-tiered-bdt"])
    assert torch.isfinite(st.p.h).all()
