"""The port's resident tiered step (make_ve_step_tiered_resident) against
the JAX package's make_ve_step_pallas_tiered_resident (Pallas in
interpret mode), Evrard 10 under the direct sum on the two tiers of
tests/test_torch_tiers.py (CMGrid(n=2, cap=64) and CMGrid(n=2,
cap=128)).

Three steps from the same bound carry: the first on the bound layouts,
the second with the carried drift forced past the margin (a rebuild in
both packages, as tests/test_tiered.py:150 forces it), the third on the
rebuilt layouts. After each: the rebuild count equal, the carried
layouts (src, valid, slot_of) equal, dt, eint, ecin at rtol 1e-5, egrav
at rtol 1e-4, the fold equal, the particle rows within 1e-5 of each
row's scale (tests/test_torch_gravity_engine.py's tolerances). The JAX
engine is one jitted program, called three times (the JAX package's
own resident test drives one program for the same reason,
docs/DESIGN.md "Known test-backend pitfall").
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.init.evrard import init_evrard as j_init_evrard
from sphexa_tpu.propagator import ve_tiered as J
from sphexa_tpu.state import _FIELDS
from sphexa_tpu_torch.interop import (box_from_numpy, config_from_dict,
                                      state_from_numpy, tiers_from_numpy)
from sphexa_tpu_torch.propagator import ve_tiered as T

STEPS = 3
FORCED = 1          # the step whose carry has its drift forced past the margin
ROWS = ("x", "y", "z", "vx", "vy", "vz", "h", "temp", "alpha", "du_m1")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs():
    cfg = JCfg(chunk=512, cell_cap=512, ngpad=256, gravity_solver="direct")
    state, jb, cfg = j_init_evrard(10, cfg, dt0=1e-4)
    p = state.p
    alive = np.asarray(p.alive)
    jt = J.choose_tiers(jb, *(np.asarray(getattr(p, c)) for c in "xyzh"),
                        alive=alive, cap_max=128, cap_max_top=64, theta=1.3,
                        grid_slack=1.0, top_headroom=1.0, headroom=0)
    host = ({f: np.asarray(getattr(p, f)) for f in _FIELDS},
            float(state.ttot), float(state.dt), float(state.dt_m1),
            int(state.iteration))
    tb = box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                         jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])

    jbind, jstep = J.make_ve_step_pallas_tiered_resident(jb, jt, cfg,
                                                         interpret=True)
    tbind, tstep = T.make_ve_step_tiered_resident(
        tb, tiers_from_numpy(jt), config_from_dict(dataclasses.asdict(cfg)),
        device="cpu")
    jc = jbind(state)
    tc = tbind(state_from_numpy(*host, device="cpu"))
    out = []
    for i in range(STEPS):
        if i == FORCED:
            jc = J.TieredCarry(jc.state, jc.layouts, jnp.float32(1e9),
                               jc.rebuilds)
            tc = dataclasses.replace(tc, drift=torch.tensor(1e9))
        jc, jd = jstep(jc)
        tc, td = tstep(tc)
        out.append(dict(
            j_rebuilds=int(jc.rebuilds), t_rebuilds=int(tc.rebuilds),
            jd={k: np.asarray(v) for k, v in jd._asdict().items()},
            td={k: np.asarray(v) for k, v in td._asdict().items()
                if v is not None},
            jl=[[np.asarray(a) for a in lay[:3]] for lay in jc.layouts],
            tl=[[a.numpy() for a in lay[:3]] for lay in tc.layouts],
            js={f: np.asarray(getattr(jc.state.p, f)) for f in ROWS},
            ts={f: getattr(tc.state.p, f).numpy() for f in ROWS}))
    return dict(steps=out, alive=alive, n_tiers=len(jt))


@pytest.mark.parametrize("step", range(STEPS))
def test_rebuilds(runs, step):
    r = runs["steps"][step]
    assert runs["n_tiers"] == 2
    assert r["t_rebuilds"] == r["j_rebuilds"] == int(step >= FORCED)


@pytest.mark.parametrize("step", range(STEPS))
def test_carried_layouts(runs, step):
    r = runs["steps"][step]
    for a, b in zip(r["jl"], r["tl"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("step", range(STEPS))
def test_diagnostics(runs, step):
    a, b = runs["steps"][step]["jd"], runs["steps"][step]["td"]
    for k in ("dt", "eint", "ecin"):
        np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(b["egrav"], a["egrav"], rtol=1e-4)
    assert float(b["egrav"]) < 0.0
    for k in ("max_cell_count", "max_nc", "nf_truncated"):
        assert int(b[k]) == int(a[k]), k


@pytest.mark.parametrize("row", ROWS)
def test_rows_after_steps(runs, row):
    alive = runs["alive"]
    for r in runs["steps"]:
        a, b = r["js"][row][alive], r["ts"][row][alive]
        scale = max(np.abs(a).max(), 1e-30)
        assert np.abs(b - a).max() <= 1e-5 * scale, row
