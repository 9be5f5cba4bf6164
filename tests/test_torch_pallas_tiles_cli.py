"""--prop ve-pallas-tiles through the port's main against the JAX CLI,
and the fail-stop on TileDiag.span_ok with its re-plan.

1. Evrard 9 (388 particles; self-gravity through the gathered direct
   sum) on 4 shards (2 x 2 tiles on CMGrid(n=2, cap=128), windows of
   5 cells), one step: the constants file of `main` under
   SPHEXA_PLATFORM=cpu SPHEXA_NUM_DEVICES=4 against the JAX CLI's
   (jax.devices cut to 4 of the conftest's virtual CPU devices, its
   Pallas stages in interpret mode; at Evrard 6-8 its planner picks cap
   64, and its make_cell_pair_call finds no z-group for cap 64 on a
   window of 7 padded z-cells, pallas_ve.py:126): the iteration column
   equal, time,
   dt, etot, ecin, eint and egrav at rtol 1e-5 (the JAX constants
   file's eint carries cv computed in float32, corrected as
   tests/test_torch_cases.py corrects it), the momenta within 1e-5 of
   sqrt(2 M ecin) (times the half diagonal for the angular one).
2. The span fail-stop at Sedov 8^3 on 2 shards (1 x 2 tiles): with the
   z window planned 2 columns wide, the tiles' one column and two halo
   columns outgrow it. The JAX step (interpret mode) returns span_ok
   false and carries on (its adapter does not read it,
   sphexa_tpu/propagator/multichip.py:343-369); the port's adapter hands
   the step back as a re-plan, the main loop restores the state, plans
   the windows again from it (plan_tile_caps) and runs the step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.domain.hilbert import AXIS
from sphexa_tpu.init.sedov import init_sedov as j_init_sedov
from sphexa_tpu.propagator import ve_pallas_tiles as J
from sphexa_tpu.state import SimState as JSimState, _FIELDS
from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.init.factory import make_initializer
from sphexa_tpu_torch.main import main
from sphexa_tpu_torch.propagator import ve_pallas_tiles as T
from sphexa_tpu_torch.sph.eos import R_GAS, ideal_gas_cv
from torch_threads import two_torch_threads  # noqa: F401


def test_evrard_main_against_jax_cli(tmp_path, monkeypatch):
    from sphexa_tpu.main import main as j_main
    argv = ["--init", "evrard", "-n", "9", "-s", "1", "--prop",
            "ve-pallas-tiles", "--quiet"]
    jc, tc = tmp_path / "j.txt", tmp_path / "t.txt"
    devs = jax.devices()[:4]
    with monkeypatch.context() as m:
        m.setattr(jax, "devices", lambda *a: devs)
        j_main(argv + ["--constants", str(jc)])
    monkeypatch.setenv("SPHEXA_PLATFORM", "cpu")
    monkeypatch.setenv("SPHEXA_NUM_DEVICES", "4")
    st = main(argv + ["--constants", str(tc)])
    assert jc.read_text().splitlines()[0] == tc.read_text().splitlines()[0]
    a, b = np.loadtxt(jc, ndmin=2), np.loadtxt(tc, ndmin=2)
    assert a.shape == b.shape and a.shape[0] == 1
    assert np.isfinite(b).all()
    st0, _, cfg = make_initializer("evrard")(9, SphConfig(), device="cpu")
    # the JAX constants line's cv is float32 (ROADMAP Queue 3)
    f = np.float32
    cv32 = f(R_GAS) / f(cfg.mui) / (f(cfg.gamma) - f(1.0))
    a[:, [3, 5]] *= ideal_gas_cv(cfg.mui, cfg.gamma) / float(cv32)
    np.testing.assert_array_equal(b[:, 0], a[:, 0])
    for col in range(1, 7):
        np.testing.assert_allclose(b[:, col], a[:, col], rtol=1e-5,
                                   err_msg=str(col))
    alive = st0.p.alive
    p_scale = np.sqrt(2.0 * float(st0.p.m[alive].sum()) * a[:, 4])
    half_diag = float(torch.max(torch.abs(torch.cat(
        [st0.p.x[alive], st0.p.y[alive], st0.p.z[alive]])))) * np.sqrt(3)
    for col, scale in ((7, p_scale), (8, p_scale * half_diag)):
        assert np.all(np.abs(b[:, col] - a[:, col]) <= 1e-5 * scale), col
    assert int(st.p.alive.sum()) == int(alive.sum())


def test_span_fail_stop_and_replan(monkeypatch, capsys):
    # the JAX step on a 2-column z window: span_ok false, and it goes on
    state, jb, cfg = j_init_sedov(8, JCfg(), dt0=2e-4)
    host = {f: np.asarray(getattr(state.p, f)) for f in _FIELDS[:-1]}
    td = J.TileDomain(n_rows=1, n_cols=2, n=2, cap=768, halo_cap=256,
                      mig_cap=512, rows_cap=4, zcols_cap=2)
    mesh = Mesh(np.array(jax.devices()[:2]), (AXIS,))
    js = JSimState(p=J.distribute_tiles(host, jb, td, mesh),
                   ttot=jnp.float32(0), dt=state.dt, dt_m1=state.dt_m1,
                   iteration=jnp.int32(0))
    js, jd = J.make_ve_step_pallas_tiles(jb, td, 128, cfg, mesh,
                                         interpret=True)(js)
    assert not bool(jd.span_ok) and int(js.iteration) == 1

    # the port: the first plan undersized, then the loop re-plans
    real = T.plan_tile_caps
    calls = []

    def plan(*a, **k):
        calls.append(real(*a, **k))
        return (calls[-1][0], 0) if len(calls) == 1 else calls[-1]

    monkeypatch.setattr(T, "plan_tile_caps", plan)
    monkeypatch.setenv("SPHEXA_PLATFORM", "cpu")
    monkeypatch.setenv("SPHEXA_NUM_DEVICES", "2")
    st = main(["--init", "sedov", "-n", "8", "-s", "1", "--prop",
               "ve-pallas-tiles", "--constants", ""])
    err = capsys.readouterr().err
    assert "tile windows outgrown: re-planning" in err
    assert len(calls) == 2 and calls[1][1] + 2 > 2
    assert int(st.iteration) == 2 and int(st.p.alive.sum()) == 512
    for f in _FIELDS[:-1]:
        assert torch.isfinite(getattr(st.p, f)[st.p.alive]).all(), f
