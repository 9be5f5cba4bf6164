"""The port's particle-frame step (make_ve_step_cellmajor) against the
JAX make_ve_step_pallas (Pallas in interpret mode) for two Sedov 10^3
steps from the same state. Bounds as tests/test_pallas_ve.py: dt rtol
1e-5, eint rtol 1e-6, ecin rtol 1e-3; fields within 2e-3 of scale.
"""

import dataclasses

import numpy as np
import pytest

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.init.sedov import init_sedov as j_init_sedov
from sphexa_tpu.ops.cellmajor import choose_cap_and_grid
from sphexa_tpu.propagator.ve_pallas import make_ve_step_pallas
from sphexa_tpu.state import _FIELDS
from sphexa_tpu_torch.interop import (box_from_numpy, config_from_dict,
                                      state_from_numpy)
from sphexa_tpu_torch.ops.cellmajor import CMGrid
from sphexa_tpu_torch.propagator.ve_cellmajor import make_ve_step_cellmajor
from torch_threads import one_torch_thread  # noqa: F401

N_STEPS = 2


@pytest.fixture(scope="module")
def runs():
    state, jb, cfg = j_init_sedov(10, JCfg(), dt0=2e-4)
    alive = np.asarray(state.p.alive)
    cap, grid = choose_cap_and_grid(
        jb, float(state.p.h[0]) * 1.2, 1000,
        *(np.asarray(getattr(state.p, c))[alive] for c in "xyz"))
    tstate = state_from_numpy(
        {f: np.asarray(getattr(state.p, f)) for f in _FIELDS},
        float(state.ttot), float(state.dt), float(state.dt_m1),
        int(state.iteration), device="cpu")

    jstep = make_ve_step_pallas(jb, grid, cfg, interpret=True)
    tbox = box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                           jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])
    tstep = make_ve_step_cellmajor(tbox, CMGrid(n=grid.n, cap=grid.cap),
                                   config_from_dict(dataclasses.asdict(cfg)),
                                   device="cpu")
    jd, td = [], []
    js, ts = state, tstate
    for _ in range(N_STEPS):
        js, d = jstep(js)
        jd.append(d)
        ts, d = tstep(ts)
        td.append(d)
    return jd, td, js, ts


@pytest.mark.parametrize("step", range(N_STEPS))
def test_step_diagnostics(runs, step):
    jd, td, _, _ = runs
    a, b = jd[step], td[step]
    assert int(b.max_cell_count) == int(a.max_cell_count) == 0
    np.testing.assert_allclose(float(b.dt), float(a.dt), rtol=1e-5)
    np.testing.assert_allclose(float(b.eint), float(a.eint), rtol=1e-6)
    np.testing.assert_allclose(float(b.ecin), float(a.ecin), rtol=1e-3,
                               atol=1e-12)
    assert int(b.max_nc) == int(a.max_nc)
    np.testing.assert_allclose(b.bounds.numpy(), np.asarray(a.bounds),
                               rtol=1e-5, atol=1e-6)


def test_final_fields(runs):
    _, _, js, ts = runs
    for f in ("x", "y", "z", "vx", "vy", "temp", "h", "alpha"):
        a = np.asarray(getattr(js.p, f))
        b = getattr(ts.p, f).numpy()
        scale = max(np.abs(a).max(), 1e-12)
        assert np.abs(b - a).max() / scale < 2e-3, f
    assert int(ts.iteration) == int(js.iteration)
