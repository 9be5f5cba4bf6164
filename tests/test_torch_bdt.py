"""The port's block time-steps against the JAX package's BdtVE (Pallas in
interpret mode): the engine over two rung cycles from the same bound
Sedov 10^3 state. The gated pair stages K2g one at a time are in
tests/test_torch_bdt_gated.py, which imports GRID and the converters
from here.

Grid CMGrid(n=4, cap=128): npz = 6, so the JAX gate unit (legal_zgroup)
is a z-supercell of Z = 6 cells, one per (x, y) column.

Tolerances, and why:
  - engine, per substep: dt rtol 1e-5, eint rtol 1e-6, ecin rtol 1e-3
    (tests/test_torch_resident.py); active_frac, active_cell_frac,
    rung_hist and the per-slot rungs equal (a rung is a floor of a
    log2: no tolerance).
  - unbound x, y, z, vx, temp, h within 2e-3 of their scale, as the
    resident engine test; alpha within 1e-4 of its scale. On this run
    the port is 4.6e-7 of alpha's scale from the JAX package; gated per
    cell (Z = 1 in place of 6) it is 4.9e-3 (test_gate_unit_shows_in_
    alpha prints both), which the energy diagnostics at these
    tolerances do not see.
The JAX reference is computed once per module.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.init.sedov import init_sedov as j_init_sedov
from sphexa_tpu.ops import cellmajor as jcm
from sphexa_tpu.propagator.ve_bdt import BdtVE as JBdtVE
from sphexa_tpu.state import _FIELDS
from sphexa_tpu_torch.interop import (bdt_from_numpy, box_from_numpy,
                                      config_from_dict, state_from_numpy)
from sphexa_tpu_torch.ops import pair_ve as tpv
from sphexa_tpu_torch.ops.cellmajor import CMGrid
from sphexa_tpu_torch.propagator.ve_bdt import BdtVE

GRID = jcm.CMGrid(n=4, cap=128)
NUM_RUNGS = 3
N_SUB = 1 << (NUM_RUNGS - 1)      # substeps per cycle
MID = 2                           # handover point inside cycle 2


def _tbox(jb):
    return box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                           jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])


def _tgrid(g):
    return CMGrid(n=g.n, cap=g.cap, nzi=g.nzi, nxi=g.nxi)


def _tcfg(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


# ---------------------------------------------------------------------------
# the engine over two cycles
# ---------------------------------------------------------------------------

def _np_tree(obj):
    """Dataclass of arrays (nested) -> dict of numpy copies."""
    return {f.name: (_np_tree(getattr(obj, f.name))
                     if dataclasses.is_dataclass(getattr(obj, f.name))
                     else np.array(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)}


def _assert_tree_equal(got, want):
    """Every leaf of two _np_tree dicts (one nesting level: rv) equal."""
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_tree_equal(got[k], v)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def _diag_np(d):
    return {k: np.asarray(v) for k, v in d._asdict().items()}


def _assert_diag_close(b, a):
    """Port substep diagnostics b against the JAX package's a."""
    assert int(b["overflow"]) == int(a["overflow"]) == 0
    np.testing.assert_allclose(b["dt"], a["dt"], rtol=1e-5)
    np.testing.assert_allclose(b["eint"], a["eint"], rtol=1e-6)
    np.testing.assert_allclose(b["ecin"], a["ecin"], rtol=1e-3, atol=1e-12)
    np.testing.assert_array_equal(b["rung_hist"], a["rung_hist"])
    assert float(b["active_frac"]) == float(a["active_frac"])
    assert float(b["active_cell_frac"]) == float(a["active_cell_frac"])


def _mixed_cells(bst, grid, Z):
    """Occupied cells left inactive inside an active z-supercell, summed
    over substeps 1..N_SUB-1 of the cycle that produced bst (rungs are
    fixed within a cycle, the layout too)."""
    rung = bst["rung"]
    valid = bst["rv"]["valid"] & np.asarray(jcm.interior_mask(grid))
    total = 0
    for s in range(1, N_SUB):
        act = (valid & (s % np.exp2(np.minimum(rung, 60.0)) == 0))
        cell_act = act.reshape(-1, grid.cap).any(1)
        occ = valid.reshape(-1, grid.cap).any(1)
        sc = cell_act.reshape(-1, Z).any(1).repeat(Z)
        total += int((occ & ~cell_act & sc).sum())
    return total


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads for this module: the port's plain stages on
    these small frames are many small ops, which more threads only slow
    down when the test run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs():
    state, jb, cfg = j_init_sedov(10, JCfg(), dt0=2e-4)
    n = state.p.n
    grid = GRID
    host = ({f: np.asarray(getattr(state.p, f)) for f in _FIELDS},
            float(state.ttot), float(state.dt), float(state.dt_m1),
            int(state.iteration))

    # JAX: cycle 1 whole, cycle 2 substep by substep (mid-cycle capture)
    jeng = JBdtVE(jb, grid, cfg, num_rungs=NUM_RUNGS, interpret=True)
    jb0 = jeng.bind_bdt(state)
    jbound = _np_tree(jb0)
    jbst, ds = jeng.run_cycle(jb0)
    jd = [_diag_np(d) for d in ds]
    jcyc = [_np_tree(jbst)]
    jck = jeng.checkpoint_rungs(jbst, n)
    jck = {k: np.asarray(v) for k, v in jck["fields"].items()} | dict(
        dt_min=jck["attrs"]["bdt_dt_min"])
    jrest = _np_tree(jeng.restore_rungs(
        jeng.bind_bdt(state), jck["bdt_rung"], jck["bdt_dt_m1k"],
        jck["dt_min"]))
    jbst, _ = jeng.resync(jbst)
    jmid = None
    for s in range(N_SUB):
        if s == MID:
            jmid = _np_tree(jbst)
        jbst, d = jeng.substep(jbst)
        jd.append(_diag_np(d))
    jcyc.append(_np_tree(jbst))
    jout = jeng.unbind(jbst.rv, n)
    jfields = {f: np.asarray(getattr(jout.p, f)) for f in _FIELDS}

    # the port: run_cycle twice from the same state
    tbox, tgrid, tcfg = _tbox(jb), _tgrid(grid), _tcfg(cfg)
    teng = BdtVE(tbox, tgrid, tcfg, num_rungs=NUM_RUNGS, device="cpu")
    tstate = state_from_numpy(*host, device="cpu")
    tb0 = teng.bind_bdt(tstate)
    tbound = _np_tree(tb0)
    td, tcyc, tstates = [], [], []
    tbst = tb0
    for _ in range(2):
        tbst, ds = teng.run_cycle(tbst)
        td += [_diag_np(d) for d in ds]
        tcyc.append(_np_tree(tbst))
        tstates.append(tbst)
    tout = teng.unbind(tbst.rv, n)
    tfields = {f: getattr(tout.p, f).numpy() for f in _FIELDS}

    # the same run with the wrong gate unit: one cell in place of Z = 6
    weng = BdtVE(tbox, tgrid, tcfg, num_rungs=NUM_RUNGS, device="cpu")
    weng.pve_gated = tpv.PairVE(tgrid, tcfg, gated=True, zgroup=1)
    wbst = weng.bind_bdt(tstate)
    for _ in range(2):
        wbst, _ = weng.run_cycle(wbst)
    walpha = weng.unbind(wbst.rv, n).p.alpha.numpy()
    return dict(jbound=jbound, tbound=tbound, jd=jd, td=td, jcyc=jcyc,
                tcyc=tcyc, tstates=tstates, jfields=jfields,
                tfields=tfields, walpha=walpha, jck=jck, jrest=jrest,
                jmid=jmid, teng=teng, tstate=tstate, n=n)


def test_bind_bdt_equal(runs):
    _assert_tree_equal(runs["tbound"], runs["jbound"])


@pytest.mark.parametrize("sub", range(2 * N_SUB))
def test_substep_diagnostics(runs, sub):
    _assert_diag_close(runs["td"][sub], runs["jd"][sub])


@pytest.mark.parametrize("cycle", [0, 1])
def test_rungs_per_slot(runs, cycle):
    a, b = runs["jcyc"][cycle], runs["tcyc"][cycle]
    np.testing.assert_array_equal(b["rung"], a["rung"])
    np.testing.assert_array_equal(b["rv"]["valid"], a["rv"]["valid"])
    assert int(b["substep"]) == int(a["substep"]) == 0


def test_run_exercises_the_gate_unit(runs):
    """The run has substeps where an occupied cell is inactive inside an
    active supercell, so a per-cell gate would compute something else;
    and it skips cells (active_cell_frac < 1)."""
    mixed = sum(_mixed_cells(c, GRID, 6) for c in runs["tcyc"])
    assert mixed > 0
    assert min(float(d["active_cell_frac"]) for d in runs["td"]) < 1.0


def test_unbound_fields(runs):
    a, b = runs["jfields"], runs["tfields"]
    np.testing.assert_array_equal(b["alive"], a["alive"])
    for f, tol in (("x", 2e-3), ("y", 2e-3), ("z", 2e-3), ("vx", 2e-3),
                   ("temp", 2e-3), ("h", 2e-3), ("alpha", 1e-4)):
        scale = max(np.abs(a[f]).max(), 1e-12)
        assert np.abs(b[f] - a[f]).max() / scale < tol, f


def test_gate_unit_shows_in_alpha(runs):
    """alpha tells the gate units apart where the energies do not: the
    port is within 1e-4 of alpha's scale from the JAX engine, and the
    same run gated per cell (Z = 1) is more than 10x that away."""
    a = runs["jfields"]["alpha"]
    scale = np.abs(a).max()
    right = np.abs(runs["tfields"]["alpha"] - a).max() / scale
    wrong = np.abs(runs["walpha"] - a).max() / scale
    print(f"alpha error of its scale: Z = 6 {right:.3e}, Z = 1 {wrong:.3e}")
    assert right < 1e-4 and wrong > 1e-3, (right, wrong)


def test_checkpoint_restore_rungs(runs):
    """checkpoint_rungs after cycle 1 and restore_rungs on a fresh bind
    give the JAX package's arrays."""
    teng, jck = runs["teng"], runs["jck"]
    ck = teng.checkpoint_rungs(runs["tstates"][0], runs["n"])
    for k in ("bdt_rung", "bdt_dt_m1k"):
        np.testing.assert_array_equal(ck["fields"][k].numpy(), jck[k])
    assert ck["attrs"]["bdt_dt_min"] == jck["dt_min"]
    assert ck["attrs"]["bdt_num_rungs"] == NUM_RUNGS
    rest = _np_tree(teng.restore_rungs(
        teng.bind_bdt(runs["tstate"]), ck["fields"]["bdt_rung"],
        ck["fields"]["bdt_dt_m1k"], ck["attrs"]["bdt_dt_min"]))
    for k in ("rung", "dt_m1k", "ticks", "dt_min", "substep"):
        np.testing.assert_array_equal(rest[k], runs["jrest"][k], err_msg=k)


def test_checkpoint_refuses_mid_cycle(runs):
    with pytest.raises(ValueError):
        runs["teng"].checkpoint_rungs(
            bdt_from_numpy(runs["jmid"], device="cpu"), runs["n"])


def test_bdt_from_numpy_mid_cycle_handover(runs):
    """A JAX mid-cycle state carried over by bdt_from_numpy round-trips
    and gives the JAX package's next substep."""
    bst = bdt_from_numpy(runs["jmid"], device="cpu")
    _assert_tree_equal(_np_tree(bst), runs["jmid"])
    assert int(bst.substep) == MID
    nxt, d = runs["teng"].substep(bst)
    _assert_diag_close(_diag_np(d), runs["jd"][N_SUB + MID])
    assert int(nxt.substep) == MID + 1


def test_substep_leaves_input_state_alone(runs):
    """No BDTState leaf is written in place (leaves alias after bind)."""
    teng = runs["teng"]
    bst = teng.bind_bdt(runs["tstate"])
    before = _np_tree(bst)
    for _ in range(2):
        nxt, _ = teng.substep(bst)
        _assert_tree_equal(_np_tree(bst), before)
        bst, before = nxt, _np_tree(nxt)
