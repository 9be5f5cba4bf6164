"""The port's gravity solvers, N-body step and Evrard initial conditions
against the JAX package, on the same seeded numpy inputs (CPU).

Bounds: the direct sum and egrav at rtol 1e-5 of each output's scale
(the largest absolute value of the row); the FMM's ax, ay, az and pot
within 1e-4 of each row's scale and nf_truncated equal (levels 3 and
4, min_sep 2 and 3, a uniform and an Evrard-clustered frame, and a
frame whose leaves overflow leaf_cap); the Ewald sum within 1e-4 of
scale; three N-body steps (FMM and direct) with dt and the energies at
rtol 1e-5 and positions within 1e-5 of scale; init_evrard bit-equal.
The M2L tables (float64 numpy) are compared exactly or at 1e-12.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.gravity import direct as jd
from sphexa_tpu.gravity import ewald as je
from sphexa_tpu.gravity import fmm as jf
from sphexa_tpu.init.evrard import init_evrard as j_init_evrard
from sphexa_tpu.propagator.nbody import make_nbody_step as j_nbody
from sphexa_tpu.sfc.box import Box as JBox
from sphexa_tpu.sfc.box import Boundary as JBoundary
from sphexa_tpu.state import _FIELDS
from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.gravity import direct as td
from sphexa_tpu_torch.gravity import ewald as te
from sphexa_tpu_torch.gravity import fmm as tf
from sphexa_tpu_torch.init.evrard import init_evrard as t_init_evrard
from sphexa_tpu_torch.interop import (box_from_numpy, config_from_dict,
                                      state_from_numpy)
from sphexa_tpu_torch.propagator.nbody import make_nbody_step as t_nbody
from sphexa_tpu_torch.sfc.box import Box as TBox
from sphexa_tpu_torch.sfc.box import Boundary as TBoundary
from torch_threads import one_torch_thread  # noqa: F401

EPS = 0.01


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


def _uniform(n=2000, seed=0, dead=5):
    r = np.random.default_rng(seed)
    x, y, z = (r.uniform(-1, 1, n).astype(np.float32) for _ in range(3))
    m = (r.uniform(0.5, 1.5, n) / n).astype(np.float32)
    alive = np.arange(n) < n - dead
    return x, y, z, m, alive


def _evrard(side=14):
    """The Evrard sphere's positions (rho ~ 1/r), equal masses."""
    x, y, z = (np.asarray(getattr(j_init_evrard(side, JCfg())[0].p, c))
               for c in "xyz")
    n = x.size
    return x, y, z, np.full(n, 1.0 / n, np.float32), np.ones(n, bool)


def _clustered(n=3000, seed=1):
    """A Gaussian cluster: at level 3 its central leaves hold several
    hundred particles, beyond leaf_cap (128)."""
    r = np.random.default_rng(seed)
    x, y, z = (np.clip(r.normal(0, 0.15, n), -0.99, 0.99).astype(np.float32)
               for _ in range(3))
    return x, y, z, np.full(n, 1.0 / n, np.float32), np.ones(n, bool)


FRAMES = {"uniform": _uniform, "evrard": _evrard, "clustered": _clustered}


def _close(got, want, rtol, what=""):
    """Each row within rtol of its largest absolute value."""
    for i, (a, b) in enumerate(zip(want, got)):
        a = np.asarray(a, np.float64)
        b = b.numpy().astype(np.float64) if isinstance(b, torch.Tensor) \
            else np.asarray(b, np.float64)
        scale = max(np.abs(a).max(), 1e-30)
        err = np.abs(b - a).max()
        assert err <= rtol * scale, f"{what} row {i}: {err:.3e} > " \
                                    f"{rtol} x {scale:.3e}"


# ---------------------------------------------------------------------------
# direct sum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [512, 4096])
def test_direct_gravity_and_egrav(chunk):
    x, y, z, m, alive = _uniform(1500)
    jg = jd.direct_gravity(_j(x), _j(y), _j(z), _j(m), _j(alive), 1.0, EPS,
                           chunk=chunk)
    tg = td.direct_gravity(_t(x), _t(y), _t(z), _t(m), _t(alive), 1.0, EPS,
                           chunk=chunk)
    _close(tg, jg, 1e-5, "direct")
    np.testing.assert_allclose(float(td.egrav(_t(m), tg.pot, _t(alive))),
                               float(jd.egrav(_j(m), jg.pot, _j(alive))),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# FMM
# ---------------------------------------------------------------------------

def _fmm_pair(frame, level, min_sep):
    x, y, z, m, alive = FRAMES[frame]()
    jb = JBox.cube(-1.0, 1.0, JBoundary.open)
    tb = TBox.cube(-1.0, 1.0, TBoundary.open)
    jg = jf.fmm_gravity(_j(x), _j(y), _j(z), _j(m), _j(alive), jb, 1.0,
                        jf.FmmConfig(level=level, min_sep=min_sep), eps=EPS)
    tg = tf.fmm_gravity(_t(x), _t(y), _t(z), _t(m), _t(alive), tb, 1.0,
                        tf.FmmConfig(level=level, min_sep=min_sep), eps=EPS)
    return jg, tg, (x, y, z, m, alive)


@pytest.mark.parametrize("frame", ["uniform", "evrard"])
@pytest.mark.parametrize("level,min_sep", [(3, 2), (3, 3), (4, 2), (4, 3)])
def test_fmm_matches_jax(frame, level, min_sep):
    jg, tg, _ = _fmm_pair(frame, level, min_sep)
    _close(tg[:4], jg[:4], 1e-4, f"fmm {frame} L{level} s{min_sep}")
    assert int(tg.nf_truncated) == int(jg.nf_truncated) == 0


def test_fmm_truncation_counted_as_jax():
    """A frame whose central leaves overflow leaf_cap: nf_truncated is
    nonzero and equal, and the (truncated) fields still agree."""
    jg, tg, _ = _fmm_pair("clustered", 3, 2)
    assert int(jg.nf_truncated) > 0
    assert int(tg.nf_truncated) == int(jg.nf_truncated)
    assert tg.nf_truncated.dtype == torch.int32
    _close(tg[:4], jg[:4], 1e-4, "fmm truncated")


def test_fmm_against_direct_sum():
    """The port's FMM against the port's direct sum (the JAX package's
    tests/test_fmm.py bound: rms acceleration error < 3%, mean potential
    error < 0.6%, level 4, min_sep 3)."""
    x, y, z, m, alive = _uniform(4000, seed=3, dead=0)
    tb = TBox.cube(-1.0, 1.0, TBoundary.open)
    ref = td.direct_gravity(_t(x), _t(y), _t(z), _t(m), _t(alive), 1.0)
    out = tf.fmm_gravity(_t(x), _t(y), _t(z), _t(m), _t(alive), tb, 1.0,
                         tf.FmmConfig(level=4, leaf_cap=256))
    aref = torch.stack(ref[:3], 1).double()
    afmm = torch.stack(out[:3], 1).double()
    rms = float(torch.linalg.norm(afmm - aref, dim=1).square().mean().sqrt()
                / torch.linalg.norm(aref, dim=1).square().mean().sqrt())
    assert rms < 0.03, rms
    perr = float((out.pot - ref.pot).abs().mean() / ref.pot.abs().mean())
    assert perr < 0.006, perr


@pytest.mark.parametrize("min_sep", [2, 3])
def test_m2l_tables_equal(min_sep):
    """The numpy M2L tables: the unit kernel stack and the parity masks
    exactly, one matrix at 1e-12."""
    jfull, jmasks = jf._unit_kernel_stack(min_sep)
    tfull, tmasks = tf._unit_kernel_stack(min_sep)
    np.testing.assert_array_equal(tfull, jfull)
    assert list(tmasks) == list(jmasks)
    for p in jmasks:
        np.testing.assert_array_equal(tmasks[p], jmasks[p])
        assert tf._parity_offsets_exact(p, min_sep) == \
            jf._parity_offsets_exact(p, min_sep)
    R = np.array([2.0, -3.0, 1.0])
    np.testing.assert_allclose(tf._m2l_matrix(R), jf._m2l_matrix(R),
                               rtol=1e-12, atol=1e-15)
    for a, b in zip(tf._derivative_tensors(R), jf._derivative_tensors(R)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)
    assert tf.moment_grid_bytes(6) == jf.moment_grid_bytes(6)


@pytest.mark.parametrize("level", [3, 4])
def test_fmm_phases_match_jax(level):
    """P2M, the far field (M2M, M2L, L2L) and L2P one by one on the
    Evrard frame, each within 1e-4 of its rows' scale."""
    x, y, z, m, alive = _evrard()
    jb = JBox.cube(-1.0, 1.0, JBoundary.open)
    tb = TBox.cube(-1.0, 1.0, TBoundary.open)
    jfc, tfc = jf.FmmConfig(level=level), tf.FmmConfig(level=level)
    n = 1 << level
    jcid = jf._leaf_binning(jfc, jb, _j(x), _j(y), _j(z), _j(alive))
    tcid = tf._leaf_binning(tfc, tb, _t(x), _t(y), _t(z), _t(alive))
    np.testing.assert_array_equal(tcid.numpy(), np.asarray(jcid))
    jco = jf._box_centered(jb, _j(x), _j(y), _j(z))
    tco = tf._box_centered(tb, _t(x), _t(y), _t(z))
    jmom = jf._raw_leaf_moments(jco, _j(m), jcid, n)
    tmom = tf._raw_leaf_moments(tco, _t(m), tcid, n)
    _close(tmom.reshape(20, -1), np.asarray(jmom).reshape(20, -1), 1e-5,
           "P2M")
    jloc = jf._far_field(jmom, jb, jfc)
    tloc = tf._far_field(_t(jmom), tb, tfc)
    _close(tloc.reshape(20, -1), np.asarray(jloc).reshape(20, -1), 1e-4,
           "far field")
    _close(tf._l2p(_t(jloc), tco, tcid, tb, tfc),
           jf._l2p(jloc, jco, jcid, jb, jfc), 1e-5, "L2P")


# ---------------------------------------------------------------------------
# Ewald
# ---------------------------------------------------------------------------

def test_ewald_matches_jax():
    x, y, z, m, alive = _uniform(400, seed=5)
    x, y, z = (0.5 * (v + 1.0) for v in (x, y, z))
    jb = JBox.cube(0.0, 1.0, JBoundary.periodic)
    tb = TBox.cube(0.0, 1.0, TBoundary.periodic)
    jg = je.ewald_gravity(_j(x), _j(y), _j(z), _j(m), _j(alive), jb, 1.0,
                          eps=EPS)
    tg = te.ewald_gravity(_t(x), _t(y), _t(z), _t(m), _t(alive), tb, 1.0,
                          eps=EPS)
    _close(tg, jg, 1e-4, "ewald")


def test_ewald_madelung_constant():
    """tests/test_ewald.py's gold value on the port: the potential at a
    site of the +-1 NaCl lattice is -1.7475645946 / d."""
    n = 2
    a = 1.0 / (4 * n)
    g = np.arange(2 * n) * 2 * a + a
    I, J, K = np.meshgrid(*(np.arange(2 * n),) * 3, indexing="ij")
    pos = [_t(g[v].ravel().astype(np.float32)) for v in (I, J, K)]
    m = _t(np.where((I + J + K) % 2 == 0, 1.0, -1.0).ravel()
           .astype(np.float32))
    tb = TBox.cube(0.0, 1.0, TBoundary.periodic)
    out = te.ewald_gravity(*pos, m, torch.ones(m.shape, dtype=torch.bool),
                           tb, 1.0)
    got = out.pot.double().numpy() * (2 * a)
    signs = m.double().numpy()
    np.testing.assert_allclose(got * signs, got[0] * signs[0], rtol=1e-3)
    np.testing.assert_allclose(np.abs(got), 1.7475645946, rtol=1e-3)


def test_ewald_refuses_open_box():
    x, y, z, m, alive = (_t(v) for v in _uniform(16))
    with pytest.raises(ValueError, match="periodic"):
        te.ewald_gravity(x, y, z, m, alive,
                         TBox.cube(0.0, 1.0, TBoundary.open), 1.0)


# ---------------------------------------------------------------------------
# N-body step, Evrard initial conditions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("solver", ["fmm", "direct"])
def test_nbody_three_steps(solver):
    state, jb, cfg = j_init_evrard(10, JCfg(gravity_solver=solver,
                                            fmm_level=3), dt0=1e-3)
    host = ({f: np.asarray(getattr(state.p, f)) for f in _FIELDS},
            float(state.ttot), float(state.dt), float(state.dt_m1),
            int(state.iteration))
    tb = box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                         jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])
    jstep = j_nbody(jb, cfg)
    tstep = t_nbody(tb, config_from_dict(dataclasses.asdict(cfg)),
                    device="cpu")
    js, ts = state, state_from_numpy(*host, device="cpu")
    for _ in range(3):
        js, jdg = jstep(js)
        ts, tdg = tstep(ts)
        np.testing.assert_allclose(float(tdg.dt), float(jdg.dt), rtol=1e-5)
        for k in ("etot", "ecin", "egrav"):
            np.testing.assert_allclose(float(getattr(tdg, k)),
                                       float(getattr(jdg, k)), rtol=1e-5,
                                       err_msg=k)
        assert int(tdg.nf_truncated) == 0
    for c in ("x", "y", "z", "vx", "vy", "vz"):
        a = np.asarray(getattr(js.p, c))
        b = getattr(ts.p, c).numpy()
        assert np.abs(b - a).max() <= 1e-5 * np.abs(a).max(), c


@pytest.mark.parametrize("side", [10, 14])
def test_init_evrard_bit_equal(side):
    jstate, jb, jcfg = j_init_evrard(side, JCfg(), dt0=3e-5)
    tstate, tb, tcfg = t_init_evrard(side, SphConfig(), dt0=3e-5,
                                     device="cpu")
    for f in _FIELDS:
        np.testing.assert_array_equal(getattr(tstate.p, f).numpy(),
                                      np.asarray(getattr(jstate.p, f)),
                                      err_msg=f)
    for s in ("ttot", "dt", "dt_m1", "iteration"):
        assert float(getattr(tstate, s)) == float(getattr(jstate, s))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tb.xmin, tb.xmax, tb.bx.value) == (jb.xmin, jb.xmax, jb.bx.value)
    assert tb.periodic == jb.periodic
