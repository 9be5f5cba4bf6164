"""The port's remaining cases (init/noh, gresho_chan, isobaric_cube,
kelvin_helmholtz, wind_shock, lattice, glass), their solutions and
observables (observables/noh_solution, gresho_solution,
case_observables, grav_waves, factory) and the command line's new cases
and props, against the JAX package.

Bounds, and why:
  - each init: every field and the config equal (the same numpy float64
    arithmetic, cast to float32 once), on the lattice paths and, with a
    small glass template installed by set_glass_template in both
    packages, on the glass paths;
  - relax_glass_block at side 6, 10 steps, cache off: bit-equal (the
    same numpy and cKDTree steps); glass_cuboid equal, and its refusal
    the JAX package's, raised before any relaxation in the port;
  - the Noh and Gresho-Chan solutions: numpy, equal;
  - the KH growth amplitude (numpy on the host): equal; the wind-bubble
    fraction (a std density over a throwaway neighbour list, then a
    count): equal; the grav-wave strains (float32 sums, another order):
    rtol 1e-5;
  - each new case (--prop ve) and prop (std, turbulence-ve,
    turbulence-ve-bdt) through main at n 6-8 against the JAX CLI's
    constants file (its eint and etot taken back from the float32 cv of
    the JAX constants line, see test_jax_constants_cv_in_float32): the
    step column equal, time, dt, etot, eint, egrav
    and the case's extra column at rtol 1e-5 (machRMS, ecin and the
    momenta of the turbulence runs, which start at rest on a lattice
    whose pressure forces are rounding noise, at rtol 1e-3: see
    tests/test_torch_turbulence.py), ecin at rtol 1e-5, the momenta at
    1e-5 of sqrt(2 M ecin) (and that times the box's half diagonal for
    the angular one), as tests/test_torch_cli.py holds Sedov.
The module runs on one torch thread (see tests/torch_threads.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.init import glass as j_glass
from sphexa_tpu.init import lattice as j_lattice
from sphexa_tpu.init.factory import make_initializer as j_make_init
from sphexa_tpu.observables import factory as j_obs
from sphexa_tpu.observables import gresho_solution as j_gresho
from sphexa_tpu.observables import noh_solution as j_noh
from sphexa_tpu.state import _FIELDS
from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.init import glass as t_glass
from sphexa_tpu_torch.init import lattice as t_lattice
from sphexa_tpu_torch.init.factory import make_initializer
from sphexa_tpu_torch.interop import (box_from_numpy, config_from_dict,
                                      state_from_numpy)
from sphexa_tpu_torch.main import main
from sphexa_tpu_torch.observables import factory as t_obs
from sphexa_tpu_torch.observables import gresho_solution, noh_solution
from torch_threads import one_torch_thread  # noqa: F401

CASES = ("noh", "isobaric-cube", "gresho-chan", "kelvin-helmholtz",
         "wind-shock")


@pytest.fixture
def template(tmp_path):
    """A 2^3 glass template (a jittered lattice) installed in both
    packages, cleared afterwards (the override is module state)."""
    x, y, z = j_lattice.jittered_lattice(2, jitter=0.3, seed=5)
    path = str(tmp_path / "tmpl.npz")
    np.savez(path, x=x, y=y, z=z)
    j_glass.set_glass_template(path)
    t_glass.set_glass_template(path)
    yield path
    j_glass.set_glass_template(None)
    t_glass.set_glass_template(None)


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Both packages' glass caches in a directory of the test's own."""
    monkeypatch.setattr(j_glass, "_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(t_glass, "_CACHE_DIR", str(tmp_path / "torch"))


def tbox(jb):
    return box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                           jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])


def tstate(js):
    return state_from_numpy({f: np.asarray(getattr(js.p, f))
                             for f in _FIELDS}, float(js.ttot), float(js.dt),
                            float(js.dt_m1), int(js.iteration), device="cpu")


def _assert_init_equal(js, jb, jc, ts, tb, tc):
    for f in _FIELDS:
        np.testing.assert_array_equal(getattr(ts.p, f).numpy(),
                                      np.asarray(getattr(js.p, f)), f)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tb == tbox(jb)
    for k in ("ttot", "dt", "dt_m1", "iteration"):
        assert float(getattr(ts, k)) == float(getattr(js, k)), k


@pytest.mark.parametrize("side", [6, 9])
@pytest.mark.parametrize("case", CASES)
def test_init_lattice(case, side):
    kw = ({"glass": False} if case in ("kelvin-helmholtz", "wind-shock")
          else {})
    _assert_init_equal(*j_make_init(case)(side, JCfg(), dt0=2e-4, **kw),
                       *make_initializer(case)(side, SphConfig(), dt0=2e-4,
                                               device="cpu", **kw))


@pytest.mark.parametrize("case", ["kelvin-helmholtz", "wind-shock"])
def test_glass_branch_falls_back(case, monkeypatch):
    """At n 6 neither cuboid hosts 24^3 template blocks: the port gives
    the lattice fallback without relaxing a template."""
    def no_relax(*a, **k):
        raise AssertionError("relaxed a template for a refused cuboid")
    monkeypatch.setattr(t_glass, "relax_glass_block", no_relax)
    a = make_initializer(case)(6, SphConfig(), device="cpu")
    b = make_initializer(case)(6, SphConfig(), device="cpu", glass=False)
    for f in _FIELDS:
        assert torch.equal(getattr(a[0].p, f), getattr(b[0].p, f)), f


@pytest.mark.parametrize("case,side", [("kelvin-helmholtz", 24),
                                       ("wind-shock", 6)])
def test_init_glass(case, side, template):
    """The glass branches with the 2^3 template: KH at 24 (its thin z
    hosts blocks of 2 x 1/24), wind-shock at 6."""
    js = j_make_init(case)(side, JCfg())
    ts = make_initializer(case)(side, SphConfig(), device="cpu")
    lattice = make_initializer(case)(side, SphConfig(), device="cpu",
                                     glass=False)
    assert ts[0].p.n != lattice[0].p.n            # the glass branch ran
    _assert_init_equal(*js, *ts)


def test_lattice_helpers():
    for a, b in zip(t_lattice.jittered_lattice(5, 0.3, 9),
                    j_lattice.jittered_lattice(5, 0.3, 9)):
        np.testing.assert_array_equal(a, b)
    tmpl = j_lattice.jittered_lattice(3)
    args = (tmpl, (2, 1, 3), (0.0, -1.0, 0.5), (1.0, 1.0, 2.0))
    for a, b in zip(t_lattice.assemble_cuboid(*args),
                    j_lattice.assemble_cuboid(*args)):
        np.testing.assert_array_equal(a, b)
    assert t_lattice.h_from_density(100, 1e-3, 2.0) == \
        j_lattice.h_from_density(100, 1e-3, 2.0)


def test_relax_glass_block():
    a = t_glass.relax_glass_block(6, steps=10, seed=3, cache=False)
    b = j_glass.relax_glass_block(6, steps=10, seed=3, cache=False)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    assert t_glass.density_noise(*a) == j_glass.density_noise(*b)


def test_glass_cuboid_and_refusal(caches):
    args = ((0, 0, 0), (1, 0.5, 0.5), 1.0 / 8)
    a = t_glass.glass_cuboid(*args, template_side=4)
    b = j_glass.glass_cuboid(*args, template_side=4)
    for u, v in zip(a, b):
        assert u.dtype == np.float32
        np.testing.assert_array_equal(u, v)
    thin = ((0, 0, 0), (1, 1, 0.0625), 1.0 / 8)
    with pytest.raises(ValueError) as want:
        j_glass.glass_cuboid(*thin, template_side=4)
    with pytest.raises(ValueError) as got:
        t_glass.glass_cuboid(*thin, template_side=4)
    assert str(got.value) == str(want.value)


def test_noh_solution():
    r = np.linspace(0.0, 0.5, 101)
    for t in (0.0, 0.3):
        for a, b in zip(noh_solution.noh_profile(r, t, 5.0 / 3.0),
                        j_noh.noh_profile(r, t, 5.0 / 3.0)):
            np.testing.assert_array_equal(a, b)


def test_gresho_solution():
    rng = np.random.default_rng(4)
    x, y, vx, vy = (rng.uniform(-0.5, 0.5, 300) for _ in range(4))
    for a, b in zip(gresho_solution.tangential_velocity(x, y, vx, vy),
                    j_gresho.tangential_velocity(x, y, vx, vy)):
        np.testing.assert_array_equal(a, b)
    r = np.hypot(x, y)
    np.testing.assert_array_equal(gresho_solution.analytic_vt(r),
                                  j_gresho.analytic_vt(r))
    assert gresho_solution.l1_error(r, vx) == j_gresho.l1_error(r, vx)


def _moving(case, side, seed):
    js, jb, jc = j_make_init(case)(side, JCfg(), **(
        {"glass": False} if case in ("kelvin-helmholtz", "wind-shock")
        else {}))
    rng = np.random.default_rng(seed)
    n = js.p.x.shape[0]
    v = {c: np.asarray(getattr(js.p, c))
         + np.float32(0.1) * rng.standard_normal(n).astype(np.float32)
         for c in ("vx", "vy", "vz")}
    x1 = {c + "_m1": (1e-4 * v["v" + c]).astype(np.float32) for c in "xyz"}
    js = js.replace(p=js.p.replace(**{k: jnp.asarray(a) for k, a in
                                      {**v, **x1}.items()}))
    return js, jb, jc, tstate(js), tbox(jb), config_from_dict(
        dataclasses.asdict(jc))


class _Diag:
    egrav, ttot, dt = 0.0, 2.5e-4, 1e-4


@pytest.mark.parametrize("case,settings,rtol", [
    ("kelvin-helmholtz", None, 0.0),
    # rhoInt 2: the density threshold some of the lattice blob's rows
    # pass at n 8 (at the case's 10 none does)
    ("wind-shock", {"rhoInt": 2.0}, 0.0),
    ("evrard", {"observeGravWaves": 1.0, "gravWaveTheta": 0.7,
                "gravWavePhi": 1.3}, 1e-5)])
def test_case_observables(case, settings, rtol):
    """KH growth, wind-bubble survival and grav-wave strains: the extra
    columns of each observable's constants line against the JAX one's."""
    js, jb, jc, ts, tb, tc = _moving(case, 8, 6)
    jo = j_obs.make_observables(case, settings)
    to = t_obs.make_observables(case, settings)
    want = np.asarray(jo.compute_extras(js, _Diag, jc, jb), np.float64)
    got = np.asarray(to.compute_extras(ts, _Diag, tc, tb), np.float64)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=rtol)
    jl, tl = (np.array(o.line(s, _Diag, c, b).split(), np.float64)
              for o, s, c, b in ((jo, js, jc, jb), (to, ts, tc, tb)))
    np.testing.assert_allclose(tl[-len(want):], jl[-len(want):],
                               rtol=max(rtol, 1e-9))


def cv_float32_error(mui, gamma):
    """cv = R / mui / (gamma - 1) in float64 over the same in float32."""
    from sphexa_tpu_torch.sph.eos import R_GAS
    f = np.float32
    cv32 = f(R_GAS) / f(mui) / (f(gamma) - f(1.0))
    return (R_GAS / mui / (gamma - 1.0)) / float(cv32)


def test_jax_constants_cv_in_float32():
    """The JAX constants line's eint at gamma 1.001 is 4.67e-5 below the
    JAX step's own eint diagnostic; the port's line agrees with the
    step."""
    from sphexa_tpu.observables.conserved import \
        conserved_quantities as j_cq
    from sphexa_tpu.propagator.common import compute_energies as j_energies
    from sphexa_tpu_torch.observables.conserved import conserved_quantities
    js, jb, jc = j_make_init("turbulence")(6, JCfg())
    j_line = float(j_cq(js.p, jc).eint)
    j_step = float(j_energies(js.p, jc)[1])
    t_line = float(conserved_quantities(
        tstate(js).p, config_from_dict(dataclasses.asdict(jc))).eint)
    ratio = cv_float32_error(jc.mui, jc.gamma)
    print(f"JAX line {j_line!r}, JAX step {j_step!r}, port line {t_line!r}, "
          f"float64/float32 cv {ratio!r}")
    assert abs(j_step / j_line - 1.0) > 4e-5
    np.testing.assert_allclose(t_line, j_step, rtol=1e-6)
    np.testing.assert_allclose(j_line * ratio, j_step, rtol=1e-6)


# (case, prop, n, steps, extra argv)
CLI_RUNS = [
    ("noh", "ve", 6, 2, []),
    ("isobaric-cube", "ve", 6, 2, []),
    ("gresho-chan", "ve", 6, 2, []),
    ("kelvin-helmholtz", "ve", 8, 2, ["--glass", None]),
    ("wind-shock", "ve", 6, 2, ["--glass", None]),
    ("noh", "std", 6, 2, []),
    ("turbulence", "turbulence-ve", 6, 2, []),
    ("turbulence", "turbulence-ve-bdt", 6, 1, []),
]


@pytest.mark.parametrize("case,prop,n,steps,extra", CLI_RUNS,
                         ids=[f"{c}-{p}" for c, p, *_ in CLI_RUNS])
def test_cli_against_jax(case, prop, n, steps, extra, tmp_path, monkeypatch,
                         template):
    """The constants file of `main` against the JAX CLI's; --glass with
    the 2^3 template (wind-shock at 6 takes the glass branch with it,
    KH at 8 falls back to its lattices)."""
    from sphexa_tpu.main import main as j_main
    argv = ["--init", case, "-n", str(n), "-s", str(steps), "--prop", prop,
            "--quiet"] + [template if a is None else a for a in extra]
    jc, tc = tmp_path / "j.txt", tmp_path / "t.txt"
    j_main(argv + ["--constants", str(jc)])
    monkeypatch.setenv("SPHEXA_PLATFORM", "cpu")
    main(argv + ["--constants", str(tc)])
    assert jc.read_text().splitlines()[0] == tc.read_text().splitlines()[0]
    a, b = np.loadtxt(jc, ndmin=2), np.loadtxt(tc, ndmin=2)
    assert a.shape == b.shape == (steps, 9 + (case in ("turbulence",
                                                      "kelvin-helmholtz",
                                                      "wind-shock")))
    assert np.isfinite(b).all()
    noisy = case == "turbulence"
    st, _, cfg = make_initializer(case)(n, SphConfig(), device="cpu")
    # the JAX constants file's eint (and etot) carry cv computed in
    # float32 (its _conserved_impl traces mui and gamma): at turbulence's
    # gamma 1.001 that is 4.67e-5 low; the port computes cv in float64,
    # as both packages' step diagnostics do (ROADMAP Queue 3)
    a[:, [3, 5]] *= cv_float32_error(cfg.mui, cfg.gamma)
    np.testing.assert_array_equal(b[:, 0], a[:, 0])
    for col in (1, 2, 3, 5, 6):
        np.testing.assert_allclose(b[:, col], a[:, col], rtol=1e-5,
                                   err_msg=str(col))
    np.testing.assert_allclose(b[:, 4], a[:, 4], rtol=1e-3 if noisy
                               else 1e-5, err_msg="ecin")
    mass = float(st.p.m.sum())
    p_scale = np.sqrt(2.0 * mass * a[:, 4])
    half_diag = max(np.abs(np.concatenate([st.p.x.numpy(), st.p.y.numpy(),
                                           st.p.z.numpy()]))) * np.sqrt(3)
    tol = 1e-3 if noisy else 1e-5
    for col, scale in ((7, p_scale), (8, p_scale * half_diag)):
        assert np.all(np.abs(b[:, col] - a[:, col]) <= tol * scale), col
    if a.shape[1] > 9:
        np.testing.assert_allclose(b[:, 9], a[:, 9],
                                   rtol=1e-3 if noisy else 1e-5)


def test_slot_frame_fail_stop_on_max_nc(monkeypatch):
    """Kept from the JAX CLI (ROADMAP Queue 3): a slot-frame prop
    fail-stops when max_nc exceeds ngpad, which no slot-frame stage
    reads, and its re-grid raises only the cap headroom. The isobaric
    cube at n 8 under --prop ve-pallas counts max_nc 168 > 160 at its
    first step, so the loop ends after 3 re-grids, as `python -m
    sphexa_tpu.main --init isobaric-cube -n 8 -s 2 --prop ve-pallas`
    does. The loop is driven here with that first step's diagnostics
    (each re-grid's own step, at a larger cap, counts the same)."""
    import argparse

    from sphexa_tpu_torch import main as cli
    monkeypatch.setenv("SPHEXA_PLATFORM", "cpu")
    st, box, cfg = make_initializer("isobaric-cube")(8, SphConfig(),
                                                     device="cpu")
    args = argparse.Namespace(prop="ve-pallas", quiet=True)
    h = float(st.p.h.max())
    step, _ = cli.make_stepper(args, box, cfg, h, st.p.n, {}, state=st,
                               device="cpu")
    first = step(st)
    assert (int(first[1].max_nc), int(first[1].max_cell_count)) == (168, 0)
    assert cfg.ngpad == 160
    headroom = []
    real = cli.make_stepper

    def stepper(args, box, cfg, h_max, n, extras=None, **kw):
        headroom.append(int(extras.get("cap_headroom", 8)))
        real(args, box, cfg, h_max, n, extras, **kw)    # plans the grid
        return (lambda state: first), None

    monkeypatch.setattr(cli, "make_stepper", stepper)
    with pytest.raises(RuntimeError, match=r"persists after 3 re-grids "
                                           r"\(max_nc=168, max_cell=0\)"):
        main(["--init", "isobaric-cube", "-n", "8", "-s", "1", "--prop",
              "ve-pallas", "--quiet", "--constants", ""])
    assert headroom == [8, 56, 104, 152]


def test_regrid_restarts_the_stirring(monkeypatch):
    """Kept from the JAX CLI (ROADMAP Queue 3): every make_stepper call,
    a re-grid's too, makes its OU driver afresh from the reference
    constants (or the restart's dump), so a re-grid mid-run restarts the
    stirring's phases and RNG."""
    import argparse

    from sphexa_tpu_torch import main as cli
    args = argparse.Namespace(prop="turbulence-ve", quiet=True)
    st, box, cfg = make_initializer("turbulence")(6, SphConfig(),
                                                  device="cpu")
    h = float(st.p.h.max())
    step, _ = cli.make_stepper(args, box, cfg, h, 216, {}, device="cpu")
    step(st)
    assert np.abs(step.turb.phases).max() > 0
    again, _ = cli.make_stepper(args, box, cfg, h, 216, {}, device="cpu")
    assert not again.turb.phases.any()
    assert again.turb.rng.bit_generator.state == \
        cli._turbulence(args, {}).rng.bit_generator.state
