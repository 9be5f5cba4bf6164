"""The port's cooling and chemistry (sphexa_tpu_torch/physics/cooling.py,
physics/chemistry.py) against the JAX package on the same inputs.

Inputs are seeded numpy float32 arrays handed to both packages.
Tolerances:
  - CoolingParams: from_settings, to_settings and cv equal (the same
    fields, the same casts, the same raise on an unknown key);
  - lambda_cie: rtol 2e-5, the zeros (at and below 1e4 K) exact. XLA's
    and PyTorch's float32 log10 differ by up to 2 ulp (interp and 10**x
    agree to 1 ulp); the table's steepest segment (7.6 decades of
    Lambda a decade of T, at the 1e4 K wall) and 10**x's ln(10) turn
    2 ulp of log10(T) ~ 4 into 1.7e-5 of Lambda;
  - cooling_rate_du, cool_particles, cooling_timestep: rtol 3e-5
    (Lambda's rounding, carried through the subcycles);
    cooling_rate_du with heating on: per row, 3e-5 of the sum of the
    magnitudes of its cooling and heating terms (they cancel where the
    gas is near equilibrium);
  - chemistry: rtol 1e-5: exp(-E/T) with |E/T| up to 80 carries the
    float32 rounding of its argument times 80 (~5e-6), then pow;
    the fractions also within 2.4e-7 absolute (4 ulp of 1: x_HI =
    1 - x_HII and the helium stages cancel to 0 near full ionization);
    ChemistryData.create exact.
The float32 guards: a row with rho 0 gives NaN in cooling_rate_du and
in cooling_timestep in both packages (ROADMAP Queue 3).
The module runs on one torch thread (see tests/torch_threads.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.physics import chemistry as jchem
from sphexa_tpu.physics import cooling as jcool
from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.physics import chemistry as tchem
from sphexa_tpu_torch.physics import cooling as tcool
from torch_threads import one_torch_thread  # noqa: F401

LAMBDA_RTOL = 2e-5
RATE_RTOL = 3e-5
CHEM_RTOL = 1e-5
CHEM_ATOL = 2.4e-7

SETTINGS = {"cooling::Gamma": 1.4, "cooling::HydrogenFractionByMass": 0.7,
            "cooling::metal_cooling": 0.0, "cooling::metallicity": 0.3,
            "cooling::cmb_temperature_floor": 1.0,
            "cooling::max_iterations": 16.0, "cooling::subcycles": "3",
            "cooling::photoelectric_heating": "2",
            "cooling::UVbackground": 1, "cooling::DeuteriumToHydrogenRatio":
            6.8e-5, "other::unrelated": 5}


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def tparams(jp) -> tcool.CoolingParams:
    """The port's CoolingParams with every field of the JAX package's."""
    return tcool.CoolingParams(**dataclasses.asdict(jp))


def close(what, got, want, rtol, atol=0.0):
    """NaN where the JAX package has NaN; elsewhere within rtol (and
    atol), zeros exact when atol is 0."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), what)
    if atol == 0.0:
        np.testing.assert_array_equal(want == 0, got == 0, what)
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol,
                               err_msg=what)


def temps():
    """1e2-1e10 K on a log grid, the table's knots and exactly 1e4 K."""
    grid = np.logspace(2.0, 10.0, 401)
    knots = 10.0 ** np.concatenate([jcool._LOGT_PRIM, jcool._LOGT_MET])
    return np.concatenate([grid, knots, [1e4, 1.0, 1e9, 2e9]]) \
        .astype(np.float32)


def test_params_from_settings_matches_jax():
    jp = jcool.CoolingParams.from_settings(SETTINGS)
    tp = tcool.CoolingParams.from_settings(SETTINGS)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert tp.metal_cooling is False and tp.cmb_temperature_floor is True
    assert tp.photoelectric_heating is True     # bool(int("2"))
    assert tp.subcycles == 3 and isinstance(tp.max_iterations, int)
    assert tp.to_settings() == jp.to_settings()
    assert tcool.CoolingParams.from_settings(tp.to_settings()) == tp
    assert tp.cv(SphConfig()) == jp.cv(JCfg())
    assert tcool.CoolingParams().cv(SphConfig(gamma=1.4)) \
        == jcool.CoolingParams().cv(JCfg(gamma=1.4))
    assert tcool.UNAPPLIED == jcool.UNAPPLIED
    assert tcool.CoolingParams._MAP == jcool.CoolingParams._MAP


@pytest.mark.parametrize("key", ["cooling::metal_coling", "cooling::mu_"])
def test_unknown_cooling_key_raises(key):
    for mod in (jcool, tcool):
        with pytest.raises(ValueError, match="unknown cooling parameter"):
            mod.CoolingParams.from_settings({key: 1.0})


@pytest.mark.parametrize("value,expect", [(0.0, False), (1.0, True),
                                          ("0", False), (2.0, True)])
def test_bool_cast(value, expect):
    s = {"cooling::with_radiative_cooling": value}
    assert tcool.CoolingParams.from_settings(s).with_radiative_cooling \
        is expect
    assert jcool.CoolingParams.from_settings(s).with_radiative_cooling \
        is expect


def test_interp_matches_jnp_interp():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(2.0, 10.0, 500), jcool._LOGT_MET,
                        [3.9, 9.5, 4.0, 9.0]]).astype(np.float32)
    xp, fp = jcool._LOGT_MET, jcool._LOGL_MET
    want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp),
                                 jnp.asarray(fp)))
    got = tcool.interp(t(x), t(xp), t(fp)).numpy()
    close("interp", got, want, 1e-6)
    assert got[x < 4.0].tolist() == [np.float32(fp[0])] * int((x < 4).sum())
    assert got[x > 9.0].tolist() == [np.float32(fp[-1])] * int((x > 9).sum())


PARAM_CASES = {
    "default": {},
    "no_metals": dict(metal_cooling=False),
    "metallicity_2": dict(metallicity=2.0, solar_metal_fraction=0.02),
    "table_clamp": dict(temperature_start=2e4, temperature_end=1e7),
}


@pytest.mark.parametrize("case", sorted(PARAM_CASES))
def test_lambda_cie(case):
    jp = jcool.CoolingParams(**PARAM_CASES[case])
    jt, tt = jnp.asarray(temps()), t(temps())
    want = np.asarray(jcool.lambda_cie(jt, jp))
    got = tcool.lambda_cie(tt, tparams(jp)).numpy()
    close(f"lambda_cie {case}", got, want, LAMBDA_RTOL)
    assert (got[temps() <= 1e4] == 0.0).all()
    at_wall = temps() == np.float32(1e4)
    assert at_wall.sum() >= 2 and (got[at_wall] == 0.0).all()


HEATING = {
    "radiative_only": {},
    "off": dict(with_radiative_cooling=False),
    "photoelectric": dict(photoelectric_heating=True),
    "compton": dict(compton_xray_heating=True),
    "volumetric": dict(use_volumetric_heating_rate=True,
                       volumetric_heating_rate=3e-25),
    "specific": dict(use_specific_heating_rate=True,
                     specific_heating_rate=2e-3),
    "all_heating": dict(with_radiative_cooling=False,
                        photoelectric_heating=True,
                        compton_xray_heating=True,
                        use_volumetric_heating_rate=True,
                        volumetric_heating_rate=1e-26,
                        use_specific_heating_rate=True,
                        specific_heating_rate=1e-4),
}


def rate_inputs(seed, n=512):
    rng = np.random.default_rng(seed)
    temp = 10.0 ** rng.uniform(2.0, 9.0, n)
    rho = 10.0 ** rng.uniform(-26.0, -20.0, n)
    return temp.astype(np.float32), rho.astype(np.float32)


@pytest.mark.parametrize("case", sorted(HEATING))
def test_cooling_rate_du(case):
    jp = jcool.CoolingParams(**HEATING[case])
    temp, rho = rate_inputs(11)
    want = np.asarray(jcool.cooling_rate_du(jnp.asarray(temp),
                                            jnp.asarray(rho), jp))
    got = tcool.cooling_rate_du(t(temp), t(rho), tparams(jp)).numpy()
    # per-row scale: |cooling term| + |heating terms| (the JAX package's)
    cool = np.asarray(jcool.cooling_rate_du(
        jnp.asarray(temp), jnp.asarray(rho),
        jcool.CoolingParams(with_radiative_cooling=jp.with_radiative_cooling)),
        np.float64)
    scale = np.abs(cool) + np.abs(want.astype(np.float64) - cool)
    err = np.abs(got.astype(np.float64) - want) / np.where(scale > 0, scale,
                                                            1.0)
    assert err.max() <= RATE_RTOL, f"cooling_rate_du {case}: {err.max()}"
    assert np.array_equal(got == 0, want == 0)
    if case == "off":
        assert (got == 0).all()


def test_float32_guards_give_nan_in_both():
    """cooling_rate_du's and cooling_timestep's 1e-60 guards round to 0
    in float32 (cooling.py:194, :249): a row with rho 0 gives NaN, and
    the timestep's min carries it (ROADMAP Queue 3)."""
    temp = np.array([2e4, 1e6, 3e5], np.float32)
    rho = np.array([1e-22, 0.0, 1e-23], np.float32)
    jp = jcool.CoolingParams()
    assert float(jnp.maximum(jnp.zeros(1, jnp.float32), 1e-60)[0]) == 0.0
    assert float(torch.clamp_min(torch.zeros(1), 1e-60)[0]) == 0.0
    jdu = np.asarray(jcool.cooling_rate_du(jnp.asarray(temp),
                                           jnp.asarray(rho), jp))
    tdu = tcool.cooling_rate_du(t(temp), t(rho), tparams(jp)).numpy()
    assert np.isnan(jdu[1]) and np.isnan(tdu[1])
    close("du with a rho-0 row", tdu, jdu, RATE_RTOL)
    cfg = (JCfg(), SphConfig())
    jdt = float(jcool.cooling_timestep(jnp.asarray(temp), jnp.asarray(rho),
                                       cfg[0], jp))
    tdt = float(tcool.cooling_timestep(t(temp), t(rho), cfg[1],
                                       tparams(jp)))
    assert np.isnan(jdt) and np.isnan(tdt)


def test_default_units_overflow_float32():
    """CoolingParams() reads code density as g/cm^3 (rho_to_cgs 1): at
    rho ~ 1, n_H ~ 4.5e23 and n_H^2 overflows float32, so du is -inf (NaN
    where Lambda is 0) and cool_particles gives NaN, in both packages. The JAX CLI's
    `--prop std-cooling` on a case other than evrard-cooling (Sedov 6^3)
    ends its first step with temp and dt NaN (ROADMAP Queue 3)."""
    temp = np.array([1e4, 2e5, 3e6], np.float32)
    rho = np.array([1.0, 0.5, 2.0], np.float32)
    jp = jcool.CoolingParams()
    jdu = np.asarray(jcool.cooling_rate_du(jnp.asarray(temp),
                                           jnp.asarray(rho), jp))
    tdu = tcool.cooling_rate_du(t(temp), t(rho), tparams(jp)).numpy()
    np.testing.assert_array_equal(tdu, jdu)
    # inf * Lambda: NaN at 1e4 K (Lambda 0), -inf above
    assert np.isnan(jdu[0]) and np.isneginf(jdu[1:]).all()
    jt = np.asarray(jcool.cool_particles(jnp.asarray(temp), jnp.asarray(rho),
                                         1e-4, JCfg(), jp))
    tt = tcool.cool_particles(t(temp), t(rho), 1e-4, SphConfig(),
                              tparams(jp)).numpy()
    assert np.isnan(jt).all() and np.isnan(tt).all()


COOL_CASES = {
    # (params, dt): the Evrard-cooling units, with the subcycles' plain
    # update; a long dt that drives u_new <= 0 (the exponential floor);
    # the CMB floor with more subcycles than max_iterations
    "evrard_units": (dict(temp_to_k=2e4 / 3.0, rho_to_cgs=1e-22), 1e-3),
    "exponential_floor": (dict(rho_to_cgs=1e-22, temp_to_k=1.0), 3e12),
    "cmb_floor": (dict(rho_to_cgs=1e-23, t_floor=1.0,
                       cmb_temperature_floor=True, subcycles=9,
                       max_iterations=5), 1e13),
}


def cool_inputs(case):
    rng = np.random.default_rng(5)
    n = 384
    if case == "evrard_units":
        temp = rng.uniform(0.5, 30.0, n)
        rho = 10.0 ** rng.uniform(-1.0, 2.0, n)
    else:
        temp = 10.0 ** rng.uniform(3.0, 8.0, n)
        rho = 10.0 ** rng.uniform(-1.0, 1.5, n)
    return temp.astype(np.float32), rho.astype(np.float32)


@pytest.mark.parametrize("case", sorted(COOL_CASES))
def test_cool_particles(case):
    kw, dt = COOL_CASES[case]
    jp = jcool.CoolingParams(**kw)
    tp = tparams(jp)
    temp, rho = cool_inputs(case)
    jcfg, tcfg = JCfg(gamma=5.0 / 3.0), SphConfig(gamma=5.0 / 3.0)
    want = np.asarray(jcool.cool_particles(jnp.asarray(temp),
                                           jnp.asarray(rho), dt, jcfg, jp))
    got = tcool.cool_particles(t(temp), t(rho), dt, tcfg, tp).numpy()
    close(f"cool_particles {case}", got, want, RATE_RTOL)
    # the same with dt as a 0-dim float32 tensor / array, as the step
    # passes state.dt
    want0 = np.asarray(jcool.cool_particles(
        jnp.asarray(temp), jnp.asarray(rho), jnp.float32(dt), jcfg, jp))
    got0 = tcool.cool_particles(t(temp), t(rho), torch.tensor(
        np.float32(dt)), tcfg, tp).numpy()
    close(f"cool_particles {case} (0-dim dt)", got0, want0, RATE_RTOL)

    # which branches the inputs reach: the first subcycle's u_new
    cv = tp.cv(tcfg)
    nsub = min(tp.subcycles, tp.max_iterations)
    du = tcool.cooling_rate_du(t(temp) * tp.temp_to_k,
                               t(rho) * tp.rho_to_cgs, tp) / tp.temp_to_k
    u_new = (cv * t(temp) + du * (dt / nsub)).numpy()
    floor = max(tp.t_floor, tcool.T_CMB0 if tp.cmb_temperature_floor
                else 0.0) / tp.temp_to_k
    if case == "exponential_floor":
        assert (u_new <= 0).sum() > 50
    if case == "cmb_floor":
        assert (got == np.float32(floor)).sum() > 10
    assert (got >= np.float32(floor)).all()


@pytest.mark.parametrize("case", sorted(COOL_CASES))
def test_cooling_timestep(case):
    kw, _ = COOL_CASES[case]
    jp = jcool.CoolingParams(**kw)
    temp, rho = cool_inputs(case)
    want = float(jcool.cooling_timestep(jnp.asarray(temp), jnp.asarray(rho),
                                        JCfg(), jp))
    got = float(tcool.cooling_timestep(t(temp), t(rho), SphConfig(),
                                       tparams(jp)))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=RATE_RTOL)


def assert_chem_close(what, got, want, rtol=CHEM_RTOL):
    for f in tchem.FIELDS:
        close(f"{what} {f}", getattr(got, f).numpy(), getattr(want, f), rtol,
              atol=CHEM_ATOL)


def test_cie_equilibrium():
    temp = np.concatenate([temps(), [0.0, 5.0, 10.0]]).astype(np.float32)
    want = jchem.cie_equilibrium(jnp.asarray(temp))
    got = tchem.cie_equilibrium(t(temp))
    assert_chem_close("cie_equilibrium", got, want)
    np.testing.assert_allclose((got.x_HI + got.x_HII).numpy(), 1.0,
                               rtol=1e-6)


@pytest.mark.parametrize("ionized", [False, True])
def test_chemistry_create(ionized):
    want = jchem.ChemistryData.create(7, ionized=ionized)
    got = tchem.ChemistryData.create(7, ionized=ionized, device="cpu")
    for f in tchem.FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


def test_update_chemistry_and_permute():
    rng = np.random.default_rng(9)
    n = 300
    old = {f: rng.uniform(0.0, 1.0, n).astype(np.float32)
           for f in tchem.FIELDS}
    temp = (10.0 ** rng.uniform(3.5, 6.5, n)).astype(np.float32)
    alive = rng.uniform(size=n) < 0.8
    perm = rng.permutation(n)
    jold = jchem.ChemistryData(**{f: jnp.asarray(v) for f, v in old.items()})
    told = tchem.ChemistryData(**{f: t(v) for f, v in old.items()})
    want = jchem.update_chemistry(jold, jnp.asarray(temp),
                                  jnp.asarray(alive))
    got = tchem.update_chemistry(told, t(temp), torch.from_numpy(alive))
    assert_chem_close("update_chemistry", got, want)
    for f in tchem.FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy()[~alive],
                                      old[f][~alive], f)
    jperm = jax.tree.map(lambda a: a[jnp.asarray(perm)], want)
    assert_chem_close("permute", got.permute(torch.from_numpy(perm)), jperm,
                      CHEM_RTOL)
    close("mean_molecular_weight",
          tchem.mean_molecular_weight(got).numpy(),
          jchem.mean_molecular_weight(want), CHEM_RTOL, atol=CHEM_ATOL)
