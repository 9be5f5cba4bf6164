"""The port's observables (observables/conserved.py, factory.py, and its
copies of radial.py and sedov_solution.py) and init settings
(init/settings.py, init/factory.py) against the JAX package.

Bounds: the conserved quantities at rtol 1e-6 (the momenta, round-off
around 0 on a symmetric state, are given a seeded velocity field here);
the constants lines' numbers at the same; the numpy copies equal to the
JAX package's; settings layering and init specs equal; the observable
classes selected as the JAX factory selects them.
"""

import dataclasses

import numpy as np
import pytest

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.init.settings import apply_settings as j_apply
from sphexa_tpu.init.settings import parse_init_spec as j_parse
from sphexa_tpu.init.sedov import init_sedov as j_init_sedov
from sphexa_tpu.observables import radial as j_radial
from sphexa_tpu.observables import sedov_solution as j_sedov
from sphexa_tpu.observables.conserved import conserved_quantities as j_cq
from sphexa_tpu.observables.factory import TimeEnergyObs as JObs
from sphexa_tpu.state import _FIELDS
from sphexa_tpu_torch.init.factory import available_cases, make_initializer
from sphexa_tpu_torch.init.settings import apply_settings, parse_init_spec
from sphexa_tpu_torch.interop import (box_from_numpy, config_from_dict,
                                      state_from_numpy)
from sphexa_tpu_torch.observables import radial, sedov_solution
from sphexa_tpu_torch.observables.conserved import (conserved_quantities,
                                                    format_constants_line)
from sphexa_tpu_torch.observables.factory import (TimeEnergyObs,
                                                  make_observables)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def moving():
    """Sedov 8^3 with padding rows and a seeded velocity field."""
    js, jb, cfg = j_init_sedov(8, JCfg(), capacity=530)
    rng = np.random.default_rng(11)
    n = js.p.x.shape[0]
    v = {c: rng.standard_normal(n).astype(np.float32) for c in
         ("vx", "vy", "vz")}
    js = js.replace(p=js.p.replace(**v))
    ts = state_from_numpy({f: np.asarray(getattr(js.p, f)) for f in _FIELDS},
                          float(js.ttot), float(js.dt), float(js.dt_m1),
                          int(js.iteration), device="cpu")
    tb = box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                         jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])
    return js, jb, cfg, ts, tb, config_from_dict(dataclasses.asdict(cfg))


def test_conserved_quantities(moving):
    js, _, cfg, ts, _, tcfg = moving
    want = j_cq(js.p, cfg, egrav=-0.25)
    got = conserved_quantities(ts.p, tcfg, egrav=-0.25)
    for k in want._fields:
        np.testing.assert_allclose(float(getattr(got, k)),
                                   float(getattr(want, k)), rtol=1e-6,
                                   err_msg=k)


def test_constants_lines(moving):
    """format_constants_line and TimeEnergyObs (header and line) against
    the JAX package's for one state and step diagnostics."""
    js, jb, cfg, ts, tb, tcfg = moving

    class Diag:
        egrav, ttot, dt = -0.125, 3.5e-4, 1.25e-5

    jline = JObs().line(js, Diag, cfg, jb)
    tline = TimeEnergyObs().line(ts, Diag, tcfg, tb)
    assert TimeEnergyObs().header() == JObs().header()
    jv, tv = (np.array(s.split(), np.float64) for s in (jline, tline))
    assert jv.shape == tv.shape == (9,)
    np.testing.assert_allclose(tv, jv, rtol=1e-6)
    q = conserved_quantities(ts.p, tcfg, egrav=Diag.egrav)
    assert format_constants_line(int(ts.iteration) - 1, Diag.ttot, Diag.dt,
                                 q) == tline


def test_observables_selection():
    """Each class as the JAX factory selects it, with its columns and
    its constructor's values."""
    from sphexa_tpu.observables.factory import \
        make_observables as j_make_observables
    from sphexa_tpu_torch.observables import factory as tf
    for case in (None, "sedov", "evrard", "noh", "gresho-chan"):
        assert type(make_observables(case)) is TimeEnergyObs
    for case, settings, cls in (
            ("wind-shock", None, tf.WindBubbleObs),
            ("wind-shock", {"rhoInt": 5.0, "rSphere": 0.05},
             tf.WindBubbleObs),
            ("turbulence", None, tf.TurbMachObs),
            ("kelvin-helmholtz", None, tf.TimeEnergyGrowthObs),
            ("sedov", {"observeGravWaves": 1.0, "gravWaveTheta": 0.5,
                       "gravWavePhi": 0.25}, tf.GravWaveObs),
            ("turbulence", {"observeGravWaves": 1.0, "gravWaveTheta": 0.0,
                            "gravWavePhi": 0.0}, tf.GravWaveObs)):
        got = make_observables(case, settings)
        want = j_make_observables(case, settings)
        assert type(got) is cls
        assert type(want).__name__ == cls.__name__
        assert got.header() == want.header()
        # the JAX WindBubbleObs also keeps temp_wind, always None
        assert vars(got) == {k: v for k, v in vars(want).items()
                             if k != "temp_wind"}
    with pytest.raises(ValueError, match="gravWaveTheta"):
        make_observables("sedov", {"observeGravWaves": 1.0})


def test_radial_and_l1():
    rng = np.random.default_rng(2)
    x, y, z = (rng.uniform(-0.5, 0.5, 5000) for _ in range(3))
    rho = 1.0 + np.exp(-((x ** 2 + y ** 2 + z ** 2) - 0.1) ** 2 * 50)
    for args in ((x, y, z, rho), (x, y, z, rho, 30, 0.6)):
        for a, b in zip(radial.radial_profile(*args),
                        j_radial.radial_profile(*args)):
            np.testing.assert_array_equal(a, b)
    assert radial.shock_radius_from_density(x, y, z, rho) == \
        j_radial.shock_radius_from_density(x, y, z, rho)
    sim = rho[:50]
    ana = rho[50:100]
    assert radial.l1_error(sim, ana) == j_radial.l1_error(sim, ana)


def test_sedov_solution():
    """alpha at gamma 5/3 is Sedov's tabulated 0.4936 to 4 digits; the
    profile, radius and jump conditions equal the JAX copy's."""
    alpha = sedov_solution.alpha_constant(5.0 / 3.0)
    assert round(alpha, 4) == 0.4936
    assert alpha == j_sedov.alpha_constant(5.0 / 3.0)
    r = np.linspace(0.0, 0.5, 101)
    for a, b in zip(sedov_solution.sedov_profile(r, 0.05, 1.0, 1.0, 5 / 3),
                    j_sedov.sedov_profile(r, 0.05, 1.0, 1.0, 5 / 3)):
        np.testing.assert_array_equal(a, b)
    assert sedov_solution.shock_radius(0.05, 1.0, 1.0, 5 / 3) == \
        j_sedov.shock_radius(0.05, 1.0, 1.0, 5 / 3)
    np.testing.assert_array_equal(
        sedov_solution.jump_conditions(0.05, 1.0, 1.0, 5 / 3),
        j_sedov.jump_conditions(0.05, 1.0, 1.0, 5 / 3))


@pytest.mark.parametrize("spec", ["sedov", "sedov:s.h5", "dump.h5",
                                  "dump.h5:3", "d.txt", "d.dat:2", "a.asc"])
def test_parse_init_spec(spec):
    assert parse_init_spec(spec) == j_parse(spec)


def test_apply_settings():
    settings = {"ng0": 64.0, "Kcour": 0.3, "gravConstant": 1.0,
                "muiConst": 0.6, "sincIndex": 5.0, "epsilon": 0.01,
                "maxDtIncrease": 1.2, "Atmin": 0.2, "Atmax": 0.3,
                "unrelated": 7.0}
    want = dataclasses.asdict(j_apply(JCfg(), settings))
    assert dataclasses.asdict(apply_settings(config_from_dict(
        dataclasses.asdict(JCfg())), settings)) == want
    assert apply_settings(config_from_dict({}), {}) == config_from_dict({})


def test_init_factory():
    from sphexa_tpu.init.factory import available_cases as j_available
    assert available_cases() == j_available()
    assert "turbulence" in available_cases() and "noh" in available_cases()
    state, box, cfg = make_initializer("evrard")(6, config_from_dict({}),
                                                 device="cpu")
    assert cfg.uniform_mass and cfg.gravG == 1.0 and box.lx == 2.0
    with pytest.raises(ValueError, match=r"available: \['evrard', "):
        make_initializer("evrard-cooling")
