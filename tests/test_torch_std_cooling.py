"""The port's std-cooling step (sphexa_tpu_torch/propagator/
std_cooling.py), init/evrard_cooling.py and the std-cooling CLI against
the JAX package.

- make_std_cooling_step for 2 steps at Evrard-cooling n = 8 as
  tests/test_physics_batch.py:98 sets it up (chunk 512, cell_cap 256,
  ngpad 256, dt0 1e-4, grid level from 1.3 h_max), without and with
  chemistry under the direct sum and with it under the FMM (level 4;
  the JAX FMM step compiles in ~15 s here, so once): max_nc and
  max_cell_count equal, dt, etot, eint, ecin and egrav at rtol 1e-5, the
  fields and the chemistry at 1e-4 of their scale (tests/
  test_torch_std.py's step tolerances: the std step's neighbour sums in
  another order);
- init_evrard_cooling: the state, the cooling parameters exact, the
  chemistry at the CIE tolerance of tests/test_torch_cooling.py;
- `main --init evrard-cooling` against the JAX CLI (3 steps): the
  constants files' columns at rtol 1e-5; with a settings file whose
  cooling:: keys override the case's parameters, the merged
  CoolingParams of the port's run equal to those the JAX make_stepper
  builds from the same settings (its step is not compiled);
- a cooling time below the hydro dt (rho_to_cgs 1e-9; the case's 1e-22
  gives dt_cool ~7e8 against dt 1e-4): dt = dt_cool in both;
- the retry that leaves the chemistry un-rolled-back (JAX main.py:545
  restores the state only, :313-320 stored the discarded step's
  chemistry), shown in both packages (ROADMAP Queue 3).
The module runs on one torch thread (see tests/torch_threads.py).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.init.evrard_cooling import init_evrard_cooling as j_init
from sphexa_tpu.neighbors import CellGrid as JGrid
from sphexa_tpu.neighbors import choose_level as j_choose_level
from sphexa_tpu.propagator.std_cooling import \
    make_std_cooling_step as j_make_step
from sphexa_tpu.state import _FIELDS
from sphexa_tpu_torch.init.evrard_cooling import init_evrard_cooling
from sphexa_tpu_torch.interop import (box_from_numpy, config_from_dict,
                                      state_from_numpy)
from sphexa_tpu_torch.neighbors import CellGrid
from sphexa_tpu_torch.physics.chemistry import FIELDS as CHEM
from sphexa_tpu_torch.physics.chemistry import ChemistryData
from sphexa_tpu_torch.physics.cooling import CoolingParams
from sphexa_tpu_torch.propagator.std_cooling import make_std_cooling_step
from torch_threads import one_torch_thread  # noqa: F401

SIDE = 8
STEPS = 2
EVRARD_COOLING = ["--init", "evrard-cooling", "-n", str(SIDE), "--dt0",
                  "1e-4", "-s", "3"]
COOLING_KEYS = {"cooling::metallicity": 0.3, "cooling::subcycles": 2.0,
                "cooling::Compton_xray_heating": 1.0,
                "cooling::UVbackground": 1.0}


def close(what, got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rtol, f"{what}: {err:.3e} of scale > {rtol}"


def tbox(jb):
    return box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                           jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])


def tstate(js):
    return state_from_numpy({f: np.asarray(getattr(js.p, f)) for f in _FIELDS},
                            float(js.ttot), float(js.dt), float(js.dt_m1),
                            int(js.iteration), device="cpu")


def tchem(jc):
    return ChemistryData(**{f: torch.from_numpy(np.array(getattr(jc, f)))
                            for f in CHEM})


def setup(solver):
    cfg = JCfg(chunk=512, cell_cap=256, ngpad=256, gravity_solver=solver)
    state, box, cfg, ex = j_init(SIDE, cfg, dt0=1e-4)
    h_max = float(np.asarray(state.p.h)[np.asarray(state.p.alive)].max())
    return state, box, cfg, ex, j_choose_level(box, h_max * 1.3)


@functools.lru_cache(maxsize=None)
def jax_run(solver, chem):
    """The JAX step's states, diagnostics and chemistry after each step."""
    js, jb, jc, ex, level = setup(solver)
    step = j_make_step(jb, JGrid(level), jc, params=ex["cooling_params"],
                       with_chemistry=chem)
    c = ex["chem"]
    out = []
    for _ in range(STEPS):
        if chem:
            js, jd, c = step(js, c)
        else:
            js, jd = step(js)
        out.append((js, jd, c if chem else None))
    return out


def test_init_matches_jax():
    js, jb, jc, jex = j_init(SIDE, JCfg(), dt0=1e-4)
    ts, tb, tc, tex = init_evrard_cooling(SIDE, config_from_dict(
        dataclasses.asdict(JCfg())), dt0=1e-4, device="cpu")
    for f in _FIELDS:
        assert np.array_equal(getattr(ts.p, f).numpy(),
                              np.asarray(getattr(js.p, f))), f
    assert tb == tbox(jb)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tex["cooling_params"]) \
        == dataclasses.asdict(jex["cooling_params"])
    for f in CHEM:
        np.testing.assert_allclose(getattr(tex["chem"], f).numpy(),
                                   np.asarray(getattr(jex["chem"], f)),
                                   rtol=1e-5, atol=2.4e-7, err_msg=f)


@pytest.mark.parametrize("solver,chem", [("direct", False),
                                         ("direct", True), ("fmm", True)],
                         ids=["direct-plain", "direct-chem", "fmm-chem"])
def test_std_cooling_steps(solver, chem):
    js, jb, jc, ex, level = setup(solver)
    params = CoolingParams(**dataclasses.asdict(ex["cooling_params"]))
    step = make_std_cooling_step(tbox(jb), CellGrid(level),
                                 config_from_dict(dataclasses.asdict(jc)),
                                 params=params, with_chemistry=chem,
                                 device="cpu")
    ts, tc = tstate(js), tchem(ex["chem"])
    for i, (jsi, jd, jci) in enumerate(jax_run(solver, chem)):
        if chem:
            ts, td, tc = step(ts, tc)
        else:
            ts, td = step(ts)
        assert int(td.max_nc) == int(jd.max_nc), i
        assert int(td.max_cell_count) == int(jd.max_cell_count), i
        assert int(td.nf_truncated) == 0, i
        for k in ("dt", "etot", "eint", "ecin", "egrav"):
            np.testing.assert_allclose(float(getattr(td, k)),
                                       float(getattr(jd, k)), rtol=1e-5,
                                       err_msg=f"{solver} step {i} {k}")
        assert float(td.egrav) < 0.0
    for c in ("x", "y", "z", "vx", "vy", "vz", "temp", "h", "du_m1"):
        close(f"{solver} {c}", getattr(ts.p, c).numpy(), getattr(jsi.p, c),
              rtol=1e-4)
    if chem:
        for f in CHEM:
            close(f"{solver} {f}", getattr(tc, f).numpy(), getattr(jci, f),
                  rtol=1e-4)
        x = tc.x_HII.numpy()
        assert ((x >= 0) & (x <= 1)).all()


def test_cooling_limits_dt():
    """A short cooling time: dt = dt_cool, the same in both packages
    (cooling_timestep over the rows, dead rows at 1e8)."""
    js, jb, jc, ex, level = setup("direct")
    kw = dict(dataclasses.asdict(ex["cooling_params"]), rho_to_cgs=1e-9)
    jstep = j_make_step(jb, JGrid(level), jc,
                        params=type(ex["cooling_params"])(**kw))
    tstep = make_std_cooling_step(tbox(jb), CellGrid(level),
                                  config_from_dict(dataclasses.asdict(jc)),
                                  params=CoolingParams(**kw), device="cpu")
    js1, jd = jstep(js)
    ts1, td = tstep(tstate(js))
    np.testing.assert_allclose(float(td.dt), float(jd.dt), rtol=1e-5)
    assert float(td.dt) < float(ts1.dt_m1)      # below the hydro dt's bound
    close("cooled temp", ts1.p.temp.numpy(), js1.p.temp, rtol=1e-4)


def cli_pair(tmp_path, monkeypatch, capsys, argv, tag):
    """The JAX CLI and the port's on argv; their constants files and the
    CoolingParams each std-cooling stepper was built with."""
    import sphexa_tpu.propagator.std_cooling as jmod
    import sphexa_tpu_torch.propagator.std_cooling as tmod
    from sphexa_tpu.main import main as j_main
    from sphexa_tpu_torch.main import main as t_main

    seen = {"jax": [], "torch": []}
    for key, mod in (("jax", jmod), ("torch", tmod)):
        real = mod.make_std_cooling_step

        def spy(*a, _real=real, _key=key, **kw):
            seen[_key].append(kw["params"])
            return _real(*a, **kw)
        monkeypatch.setattr(mod, "make_std_cooling_step", spy)
    jc, tc = tmp_path / f"j{tag}.txt", tmp_path / f"t{tag}.txt"
    j_main(argv + ["--constants", str(jc), "--quiet"])
    monkeypatch.setenv("SPHEXA_PLATFORM", "cpu")
    t_main(argv + ["--constants", str(tc), "--quiet"])
    monkeypatch.delenv("SPHEXA_PLATFORM")
    capsys.readouterr()
    assert jc.read_text().splitlines()[0] == tc.read_text().splitlines()[0]
    return np.loadtxt(jc), np.loadtxt(tc), seen


def check_constants(a, b):
    assert a.shape == b.shape == (3, 9)
    np.testing.assert_array_equal(b[:, 0], a[:, 0])
    np.testing.assert_allclose(b[:, 1:7], a[:, 1:7], rtol=1e-5)
    p_scale = np.sqrt(2.0 * 1.0 * a[:, 4])     # total mass 1
    for col in (7, 8):   # momenta: round-off around 0, at 1e-5 of scale
        assert np.all(np.abs(b[:, col] - a[:, col]) <= 1e-5 * p_scale), col


def test_cli_evrard_cooling_matches_jax(tmp_path, monkeypatch, capsys):
    a, b, seen = cli_pair(tmp_path, monkeypatch, capsys,
                          list(EVRARD_COOLING), "")
    check_constants(a, b)
    assert len(seen["jax"]) == len(seen["torch"]) >= 1
    for jp, tp in zip(seen["jax"], seen["torch"]):
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)


def test_cli_settings_cooling_override(tmp_path, monkeypatch, capsys):
    """`--init evrard-cooling:settings.h5`: the file's cooling:: keys
    merged over the case's parameters. The port's CLI runs; the JAX
    make_stepper builds (but does not compile) its step from the same
    settings; the CoolingParams are equal."""
    import h5py
    import sphexa_tpu.main as jcli
    import sphexa_tpu.propagator.std_cooling as jmod
    import sphexa_tpu_torch.propagator.std_cooling as tmod
    from sphexa_tpu_torch.main import main as t_main

    path = tmp_path / "settings.h5"
    with h5py.File(path, "w") as f:
        for k, v in COOLING_KEYS.items():
            f.attrs[k] = v
    argv = list(EVRARD_COOLING)
    argv[1] = f"evrard-cooling:{path}"
    seen = {"jax": [], "torch": []}
    for key, mod in (("jax", jmod), ("torch", tmod)):
        real = mod.make_std_cooling_step

        def spy(*a, _real=real, _key=key, **kw):
            seen[_key].append(kw["params"])
            return _real(*a, **kw)
        monkeypatch.setattr(mod, "make_std_cooling_step", spy)
    args = jcli.parse_args(argv)
    js, jb, jc, jex = jcli.build_sim(args)
    assert args.prop == "std-cooling" and "settings" in jex
    jcli.make_stepper(args, jb, jc, 0.1, 100, jex, state=js)
    monkeypatch.setenv("SPHEXA_PLATFORM", "cpu")
    t_main(argv + ["--constants", str(tmp_path / "t.txt"), "--quiet"])
    capsys.readouterr()
    assert len(seen["jax"]) == 1 and len(seen["torch"]) >= 1
    for tp in seen["torch"]:
        assert dataclasses.asdict(tp) == dataclasses.asdict(seen["jax"][0])
        assert tp.metallicity == 0.3 and tp.subcycles == 2
        assert tp.compton_xray_heating is True
        assert tp.extra == (("UVbackground", 1.0),)
        assert tp.temp_to_k > 1e10 and tp.rho_to_cgs == 1e-22   # the case's


def retried_run(monkeypatch, pkg):
    """`main --init evrard-cooling -n 8 -s 1` with cell_cap 8, so the
    first call fail-stops and the loop retries, and the initial
    temperatures scaled by a seeded factor in [0.7, 1.3] (the chemistry
    at their CIE), so that rows differ: (state, chem in, chem out, diag)
    of each call."""
    import importlib
    cli = importlib.import_module(f"{pkg}.main")
    config = importlib.import_module(f"{pkg}.config")
    init = importlib.import_module(f"{pkg}.init.evrard_cooling")
    real_cfg, real_make, real_init = (config.SphConfig, cli.make_stepper,
                                      init.init_evrard_cooling)

    def hot_init(side, cfg, **kw):
        state, box, cfg, ex = real_init(side, cfg, **kw)
        f = np.random.default_rng(4).uniform(0.7, 1.3, state.p.n)
        temp = (np.asarray(state.p.temp) * f).astype(np.float32)
        temp = torch.from_numpy(temp) if pkg.endswith("torch") \
            else jnp.asarray(temp)
        state = state.replace(p=state.p.replace(temp=temp))
        ex["chem"] = init.cie_equilibrium(
            temp * ex["cooling_params"].temp_to_k)
        return state, box, cfg, ex

    monkeypatch.setattr(config, "SphConfig", lambda: real_cfg(cell_cap=8))
    monkeypatch.setattr(init, "init_evrard_cooling", hot_init)
    calls = []

    def spy(args, box, cfg, h_max, n, extras=None, **kw):
        fn, grid = real_make(args, box, cfg, h_max, n, extras, **kw)

        def step(state):
            chem_in = extras["chem"]
            out = fn(state)
            calls.append((state, chem_in, extras["chem"], out[1]))
            return out
        return step, grid
    monkeypatch.setattr(cli, "make_stepper", spy)
    if pkg == "sphexa_tpu_torch":
        monkeypatch.setenv("SPHEXA_PLATFORM", "cpu")
    cli.main(["--init", "evrard-cooling", "-n", str(SIDE), "--dt0", "1e-4",
              "-s", "1", "--constants", "", "--quiet"])
    return calls


def chem_np(c):
    return {f: np.asarray(getattr(c, f)) for f in CHEM}


def test_retry_keeps_discarded_chemistry(monkeypatch, capsys):
    """JAX main.py:545 restores the state after a fail-stop, but
    step_with_chem (:313-320) has already stored the discarded step's
    chemistry, permuted by that step's cell sort. The port's loop does
    the same: the retried call gets the restored state and the
    discarded call's chemistry."""
    runs = {pkg: retried_run(monkeypatch, pkg)
            for pkg in ("sphexa_tpu", "sphexa_tpu_torch")}
    capsys.readouterr()
    for pkg, calls in runs.items():
        assert len(calls) == 2, pkg
        (s0, in0, out0, d0), (s1, in1, out1, _) = calls
        assert int(d0.max_cell_count) > 8, pkg     # the fail-stop
        assert s1 is s0, pkg                        # the state restored
        assert in1 is out0, pkg                     # the chemistry not
        a, b = chem_np(in0), chem_np(in1)
        assert not np.array_equal(a["x_HII"], b["x_HII"]), pkg
        # a permutation of the initial rows (every row alive: the CIE
        # update recomputes them from the temperatures, which the
        # negligible cooling of the case's units leaves as they were)
        np.testing.assert_allclose(np.sort(b["x_HII"]), np.sort(a["x_HII"]),
                                   rtol=1e-5, atol=2.4e-7)
    jo, to = chem_np(runs["sphexa_tpu"][0][2]), \
        chem_np(runs["sphexa_tpu_torch"][0][2])
    for f in CHEM:
        np.testing.assert_allclose(to[f], jo[f], rtol=1e-5, atol=2.4e-7,
                                   err_msg=f)
