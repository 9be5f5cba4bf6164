"""The port's resident VE engine against the JAX ResidentVE (Pallas in
interpret mode), from the same Sedov 10^3 state, across a forced rebin.

Bounds are those of tests/test_pallas_ve.py::test_resident_engine_
matches_compat: dt rtol 1e-5, eint rtol 1e-6, ecin rtol 1e-3 (the
kinetic energy starts at zero and is carried by a few particles, so
pair-sum order shows there first), and the unbound fields within 2e-3
of their scale. The JAX reference is computed once per module.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.init.sedov import init_sedov as j_init_sedov
from sphexa_tpu.ops.cellmajor import choose_cap_and_grid
from sphexa_tpu.propagator.ve_pallas import ResidentVE as JResidentVE
from sphexa_tpu.state import _FIELDS
from sphexa_tpu_torch.interop import (box_from_numpy, config_from_dict,
                                      resident_from_numpy, state_from_numpy)
from sphexa_tpu_torch.ops.cellmajor import CMGrid
from sphexa_tpu_torch.propagator.ve_cellmajor import ResidentVE
from torch_threads import one_torch_thread  # noqa: F401

N_STEPS = 3
FORCE_REBIN_AT = 1          # drift = 1e9 before this step


def _np_state(state):
    return ({f: np.asarray(getattr(state.p, f)) for f in _FIELDS},
            float(state.ttot), float(state.dt), float(state.dt_m1),
            int(state.iteration))


@pytest.fixture(scope="module")
def runs():
    state, jb, cfg = j_init_sedov(10, JCfg(), dt0=2e-4)
    alive = np.asarray(state.p.alive)
    cap, grid = choose_cap_and_grid(
        jb, float(state.p.h[0]) * 1.2, 1000,
        *(np.asarray(getattr(state.p, c))[alive] for c in "xyz"))
    host = _np_state(state)

    jeng = JResidentVE(jb, grid, cfg, interpret=True)
    jr = jeng.bind(state)
    jbound = {f.name: np.asarray(getattr(jr, f.name))
              for f in dataclasses.fields(jr)}
    jd = []
    for i in range(N_STEPS):
        if i == FORCE_REBIN_AT:
            jr = jr.replace(drift=jnp.float32(1e9))
        jr, d = jeng.step(jr)
        jd.append({k: np.asarray(v) for k, v in d._asdict().items()})
    jout = jeng.unbind(jr, state.p.n)
    jfields = {f: np.asarray(getattr(jout.p, f)) for f in _FIELDS}

    tbox = box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                           jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    teng = ResidentVE(tbox, CMGrid(n=grid.n, cap=grid.cap), tcfg,
                      device="cpu")
    tstate = state_from_numpy(*host, device="cpu")
    tr = teng.bind(tstate)
    tbound = {f.name: getattr(tr, f.name).numpy()
              for f in dataclasses.fields(tr)}
    td = []
    for i in range(N_STEPS):
        if i == FORCE_REBIN_AT:
            tr = tr.replace(drift=tr.drift.new_tensor(1e9))
        tr, d = teng.step(tr)
        td.append({k: np.asarray(v) for k, v in d._asdict().items()})
    tout = teng.unbind(tr, tstate.p.n)
    tfields = {f: getattr(tout.p, f).numpy() for f in _FIELDS}
    return dict(jbound=jbound, tbound=tbound, jd=jd, td=td, jfields=jfields,
                tfields=tfields, tstate=tstate, host=host, teng=teng)


def test_bind_equal(runs):
    jb, tb = runs["jbound"], runs["tbound"]
    assert set(jb) == set(tb)
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


@pytest.mark.parametrize("step", range(N_STEPS))
def test_step_diagnostics(runs, step):
    a, b = runs["jd"][step], runs["td"][step]
    assert int(b["overflow"]) == int(a["overflow"]) == 0
    assert bool(b["rebinned"]) == bool(a["rebinned"])
    if step == FORCE_REBIN_AT:
        assert bool(b["rebinned"])
    np.testing.assert_allclose(b["dt"], a["dt"], rtol=1e-5)
    np.testing.assert_allclose(b["eint"], a["eint"], rtol=1e-6)
    np.testing.assert_allclose(b["ecin"], a["ecin"], rtol=1e-3, atol=1e-12)
    np.testing.assert_allclose(b["h_max"], a["h_max"], rtol=1e-5)
    assert int(b["h_nonconv"]) == int(a["h_nonconv"])


def test_unbound_fields(runs):
    a, b = runs["jfields"], runs["tfields"]
    np.testing.assert_array_equal(b["alive"], a["alive"])
    for f in ("x", "y", "z", "vx", "temp", "h"):
        scale = max(np.abs(a[f]).max(), 1e-12)
        assert np.abs(b[f] - a[f]).max() / scale < 2e-3, f


def test_step_leaves_caller_state_alone(runs):
    """bind/step/unbind copy: the caller's SimState is unchanged."""
    fields, ttot, dt, dt_m1, it = runs["host"]
    ts = runs["tstate"]
    for f in ("x", "h", "vx", "temp"):
        np.testing.assert_array_equal(getattr(ts.p, f).numpy(), fields[f])
    assert float(ts.ttot) == ttot and float(ts.dt) == np.float32(dt)


def test_resident_from_numpy_roundtrip(runs):
    rst = resident_from_numpy(runs["jbound"], device="cpu")
    for k, v in runs["jbound"].items():
        np.testing.assert_array_equal(getattr(rst, k).numpy(), v, err_msg=k)
    eng = runs["teng"]
    _, d = eng.step(rst)
    np.testing.assert_allclose(float(d.dt), runs["jd"][0]["dt"], rtol=1e-5)
