"""The PyTorch port's foundation modules against the JAX package.

Both packages get the same seeded numpy inputs; results come back as
numpy. Elementwise float32 physics agrees to rtol 1e-6 (the same
formulas; only rounding of transcendentals such as pow may differ by an
ulp), the compensated sum to rtol 1e-7, and the Sedov initial
conditions bit for bit after the float32 cast.
"""

import ast
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu import config as jcfg
from sphexa_tpu.init import grid as jgrid
from sphexa_tpu.init.sedov import init_sedov as j_init_sedov
from sphexa_tpu.sfc import box as jbox
from sphexa_tpu.sph import eos as jeos
from sphexa_tpu.sph import kernels as jk
from sphexa_tpu.sph import positions as jpos
from sphexa_tpu.sph import timestep as jts
from sphexa_tpu.util.kahan import kahan_sum as j_kahan_sum
from sphexa_tpu_torch import config as tcfg
from sphexa_tpu_torch.init import grid as tgrid
from sphexa_tpu_torch.init.sedov import init_sedov as t_init_sedov
from sphexa_tpu_torch.interop import box_from_numpy, config_from_dict
from sphexa_tpu_torch.sfc import box as tbox
from sphexa_tpu_torch.sph import eos as teos
from sphexa_tpu_torch.sph import kernels as tk
from sphexa_tpu_torch.sph import positions as tpos
from sphexa_tpu_torch.sph import timestep as tts
from sphexa_tpu_torch.util.kahan import kahan_sum as t_kahan_sum
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-6
PKG = pathlib.Path(__file__).resolve().parents[1] / "sphexa_tpu_torch"


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f32(a):
    return np.asarray(a, np.float32)


def _j(a):
    return jnp.asarray(_f32(a))


def _t(a):
    return torch.from_numpy(_f32(a).copy())


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# import guard and device policy (inherited by every later slice)
# ---------------------------------------------------------------------------

def test_port_imports_nothing_of_jax():
    """No module of the port imports jax, flax or the JAX package."""
    files = sorted(PKG.rglob("*.py"))
    assert files
    bad = []
    for f in files:
        tree = ast.parse(f.read_text(), str(f))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "flax", "sphexa_tpu"):
                    bad.append(f"{f.relative_to(PKG)}: {name}")
    assert not bad, bad


def test_entry_points_refuse_silent_cpu(monkeypatch):
    """With no GPU and no explicit device the entry points raise."""
    from sphexa_tpu_torch.ops.cellmajor import CMGrid
    from sphexa_tpu_torch.propagator.ve_cellmajor import (
        ResidentVE, make_ve_step_cellmajor)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    box = tbox.Box.cube(-0.5, 0.5, tbox.Boundary.periodic)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResidentVE(box, CMGrid(n=2, cap=128), tcfg.SphConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_ve_step_cellmajor(box, CMGrid(n=2, cap=128), tcfg.SphConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_init_sedov(4, tcfg.SphConfig())
    ResidentVE(box, CMGrid(n=2, cap=128), tcfg.SphConfig(), device="cpu")


def test_gravity_accepted_and_bdt_avclean_refused():
    """Single-device gravity is ported: the resident engine and BdtVE
    take gravG != 0. avClean runs on the resident engine, but not with
    block time-steps (the JAX BdtVE asserts it off)."""
    from sphexa_tpu_torch.ops.cellmajor import CMGrid
    from sphexa_tpu_torch.propagator.ve_bdt import BdtVE
    from sphexa_tpu_torch.propagator.ve_cellmajor import ResidentVE

    box = tbox.Box.cube(-0.5, 0.5, tbox.Boundary.periodic)
    grid = CMGrid(n=2, cap=128)
    ResidentVE(box, grid, tcfg.SphConfig(gravG=1.0), device="cpu")
    BdtVE(box, grid, tcfg.SphConfig(gravG=1.0), device="cpu")
    with pytest.raises(NotImplementedError):
        BdtVE(box, grid, tcfg.SphConfig(av_clean=True), device="cpu")
    ResidentVE(box, grid, tcfg.SphConfig(av_clean=True), device="cpu")


# ---------------------------------------------------------------------------
# config, box
# ---------------------------------------------------------------------------

def test_config_same_fields_and_defaults():
    j = dataclasses.asdict(jcfg.SphConfig())
    t = dataclasses.asdict(tcfg.SphConfig())
    assert j == t
    assert config_from_dict(j) == tcfg.SphConfig()
    assert tcfg.SphConfig().ramp == jcfg.SphConfig().ramp
    assert tcfg.COORD_DTYPE == torch.float32
    assert tcfg.HYDRO_DTYPE == torch.float32


@pytest.mark.parametrize("boundary", ["periodic", "open"])
def test_box_put_in_box_and_normalize(boundary):
    jb = jbox.Box(-0.5, 0.5, -0.25, 0.75, -1.0, 1.0,
                  jbox.Boundary[boundary], jbox.Boundary.periodic,
                  jbox.Boundary.open)
    tb = box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin, jb.zmax],
                        [b.value for b in (jb.bx, jb.by, jb.bz)])
    assert tb.periodic == jb.periodic and tb.lengths == jb.lengths
    r = _rng(1)
    xyz = [r.uniform(-2.0, 2.0, 4000) for _ in range(3)]
    jw = jbox.put_in_box(jb, *map(_j, xyz))
    tw = tbox.put_in_box(tb, *map(_t, xyz))
    for a, b in zip(jw, tw):
        np.testing.assert_allclose(_np(b), _np(a), rtol=RTOL, atol=1e-7)
    jn = jbox.normalize_coords(jb, *map(_j, xyz))
    tn = tbox.normalize_coords(tb, *map(_t, xyz))
    for a, b in zip(jn, tn):
        np.testing.assert_array_equal(_np(b), _np(a))


# ---------------------------------------------------------------------------
# kahan, kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 7, 1000, 12345])
def test_kahan_sum(n):
    x = _rng(n).normal(0.0, 1.0, n) * np.exp(_rng(n + 1).uniform(-8, 8, n))
    a = float(j_kahan_sum(_j(x)))
    b = float(t_kahan_sum(_t(x)))
    np.testing.assert_allclose(b, a, rtol=1e-7)
    np.testing.assert_allclose(b, np.sum(_f32(x).astype(np.float64)),
                               rtol=1e-6)


def test_sinc_polynomials_and_pow_int():
    assert tk._SINC_COEF == jk._SINC_COEF
    assert tk._DSINC_OVER_V_COEF == jk._DSINC_OVER_V_COEF
    v2 = _rng(2).uniform(0.0, 4.0, 5000)
    for coef in (jk._SINC_COEF, jk._DSINC_OVER_V_COEF):
        a = _np(jk._poly_even(_j(v2), coef))
        b = _np(tk._poly_even(_t(v2), coef))
        scale = np.abs(a).max()
        assert np.abs(b - a).max() <= 1e-6 * scale
    s = _rng(3).uniform(-1.0, 1.0, 5000)
    for n in (1, 2, 3, 5, 6, 9):
        np.testing.assert_allclose(_np(tk._pow_int(_t(s), n)),
                                   _np(jk._pow_int(_j(s), n)), rtol=RTOL,
                                   atol=1e-30)


def test_exp_pair_and_kernel_constant():
    x = _rng(4).uniform(-0.6, 0.6, 5000)
    for a, b in zip(jk.exp_pair(_j(x)), tk.exp_pair(_t(x))):
        np.testing.assert_allclose(_np(b), _np(a), rtol=RTOL)
    for n in (4.0, 6.0, 6.5):
        assert tk.kernel_3d_k(n) == jk.kernel_3d_k(n)


@pytest.mark.parametrize("h_cap", [0.0, 0.0123])
def test_update_h_and_courant(h_cap):
    r = _rng(5)
    nc = np.floor(r.uniform(0, 300, 5000))
    h = r.uniform(0.005, 0.02, 5000)
    a = jk.update_h(100, _j(nc), _j(h), h_cap=h_cap)
    b = tk.update_h(100, _t(nc), _t(h), h_cap=h_cap)
    np.testing.assert_allclose(_np(b), _np(a), rtol=RTOL)
    mvs = np.where(r.random(5000) < 0.3, 0.0, r.uniform(0.1, 5, 5000))
    c = r.uniform(0.1, 3, 5000)
    np.testing.assert_allclose(
        _np(tk.ts_k_courant(_t(mvs), _t(h), _t(c), 0.2)),
        _np(jk.ts_k_courant(_j(mvs), _j(h), _j(c), 0.2)), rtol=RTOL)


# ---------------------------------------------------------------------------
# eos, positions, timestep
# ---------------------------------------------------------------------------

def test_eos_ve():
    r = _rng(6)
    args = [r.uniform(1e2, 1e6, 4000), r.uniform(1e-6, 1e-3, 4000),
            r.uniform(1e2, 1e4, 4000), r.uniform(1e-7, 1e-6, 4000),
            r.uniform(0.8, 1.2, 4000)]
    assert teos.ideal_gas_cv(10.0, 5 / 3) == jeos.ideal_gas_cv(10.0, 5 / 3)
    a = jeos.eos_ve(*map(_j, args), 10.0, 5.0 / 3.0)
    b = teos.eos_ve(*map(_t, args), 10.0, 5.0 / 3.0)
    for x, y in zip(a, b):
        np.testing.assert_allclose(_np(y), _np(x), rtol=RTOL)


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("boundary", ["periodic", "fixed"])
def test_position_and_temp_update(fold, boundary):
    r = _rng(7)
    n = 4000
    jb = jbox.Box.cube(-0.5, 0.5, jbox.Boundary[boundary])
    tb = tbox.Box.cube(-0.5, 0.5, tbox.Boundary[boundary])
    pos = [r.uniform(-0.55, 0.55, n) for _ in range(3)]
    acc = [r.normal(0, 10.0, n) for _ in range(3)]
    dpos = [r.normal(0, 1e-4, n) for _ in range(3)]
    h = r.uniform(0.01, 0.02, n)
    vel = [np.where(r.random(n) < 0.2, 0.0, r.normal(0, 1, n))
           for _ in range(3)]
    vel = [np.where(vel[0] == 0.0, 0.0, v) for v in vel]
    dt, dt_m1 = 1.3e-5, 1.1e-5
    a = jpos.position_update(jnp.float32(dt), jnp.float32(dt_m1),
                             *map(_j, pos + acc + dpos), jb, h=_j(h),
                             vx=_j(vel[0]), vy=_j(vel[1]), vz=_j(vel[2]),
                             fold=fold)
    tdt = torch.tensor(dt, dtype=torch.float32)
    tdtm1 = torch.tensor(dt_m1, dtype=torch.float32)
    b = tpos.position_update(tdt, tdtm1, *map(_t, pos + acc + dpos), tb,
                             h=_t(h), vx=_t(vel[0]), vy=_t(vel[1]),
                             vz=_t(vel[2]), fold=fold)
    for x, y in zip(a, b):
        np.testing.assert_allclose(_np(y), _np(x), rtol=RTOL, atol=1e-9)
    temp = r.uniform(1.0, 1e6, n)
    du = r.normal(0, 1e9, n)
    du_m1 = r.normal(0, 1e9, n)
    ta = jpos.temp_update(_j(temp), jnp.float32(dt), jnp.float32(dt_m1),
                          _j(du), _j(du_m1), 10.0, 5.0 / 3.0)
    tbb = tpos.temp_update(_t(temp), tdt, tdtm1, _t(du), _t(du_m1), 10.0,
                           5.0 / 3.0)
    np.testing.assert_allclose(_np(tbb), _np(ta), rtol=RTOL)


def test_timestep_functions():
    r = _rng(8)
    n = 5000
    mvs, h, c = r.uniform(0, 5, n), r.uniform(0.01, 0.02, n), r.uniform(1, 3, n)
    divv = r.normal(0, 100, n)
    acc = [r.normal(0, 10, n) for _ in range(3)]
    alive = r.random(n) < 0.9
    ja, ta = jnp.asarray(alive), torch.from_numpy(alive)
    pairs = [
        (jts.courant_timestep(_j(mvs), _j(h), _j(c), ja, 0.2),
         tts.courant_timestep(_t(mvs), _t(h), _t(c), ta, 0.2)),
        (jts.rho_timestep(_j(divv), ja, 0.06),
         tts.rho_timestep(_t(divv), ta, 0.06)),
        (jts.acceleration_timestep(*map(_j, acc), ja, 0.2, 0.005),
         tts.acceleration_timestep(*map(_t, acc), ta, 0.2, 0.005)),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(float(b), float(a), rtol=RTOL)
    cands = [1e-4, 3e-5, 2e-5]
    a = jts.combine_timesteps(jnp.float32(2.5e-5), jnp.asarray(cands,
                                                              jnp.float32),
                              jcfg.SphConfig())
    b = tts.combine_timesteps(torch.tensor(2.5e-5),
                              [torch.tensor(v) for v in cands],
                              tcfg.SphConfig())
    np.testing.assert_allclose(float(b), float(a), rtol=RTOL)


# ---------------------------------------------------------------------------
# initial conditions
# ---------------------------------------------------------------------------

def test_grid_helpers_equal():
    for a, b in zip(jgrid.regular_grid(0.5, 7), tgrid.regular_grid(0.5, 7)):
        np.testing.assert_array_equal(a, b)
    assert tgrid.initial_h(100, 1.0, 1000) == jgrid.initial_h(100, 1.0, 1000)


@pytest.mark.parametrize("capacity", [None, 1100])
def test_init_sedov_bit_equal(capacity):
    js, jb, jc = j_init_sedov(10, jcfg.SphConfig(), capacity=capacity,
                              dt0=1e-5)
    ts_, tb, tc = t_init_sedov(10, tcfg.SphConfig(), capacity=capacity,
                               dt0=1e-5, device="cpu")
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert (jb.xmin, jb.xmax, jb.periodic) == (tb.xmin, tb.xmax, tb.periodic)
    for f in ("x", "y", "z", "x_m1", "y_m1", "z_m1", "vx", "vy", "vz",
              "temp", "h", "m", "alpha", "du_m1", "alive"):
        a = np.asarray(getattr(js.p, f))
        b = getattr(ts_.p, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    for f in ("ttot", "dt", "dt_m1", "iteration"):
        assert float(getattr(ts_, f)) == float(getattr(js, f)), f
