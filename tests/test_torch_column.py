"""K11, the column launch (PairVE(kernel_mode="column")), against the JAX
package's column driver (PallasVE(kernel_mode="column"), interpret mode).

Frame: a perturbed Sedov 10^3 state (seeded numpy jitter of positions
and h, random velocities and alpha) on the planner's grid, the cubic
CMGrid(n=2, cap=128). Both packages get each stage's inputs from the
port's cell-mode pipeline on the CPU (plain versions), so the stages are
compared one at a time on interior valid slots, with the cell stages'
tolerances:

  - direct bodies (tests/test_torch_pair_ve.py): nc and nonconv exact;
    h, xm, kx, gradh, alpha, maxvsignal rtol 1e-5 (pair sums in another
    order); cij, divv, curlv, gradv, ax, ay, az, du within 1e-4 of the
    row's scale (cancelling sums);
  - mxu_moments + mxu_momentum (tests/test_torch_mm.py): K8's 14 rows
    within 1e-4 of scale, K10 within 1e-4 of scale and maxvsignal rtol
    1e-5; K9's alpha within 1e-4 of its scale, the bound of
    tests/test_torch_mm_engine.py (divv is an input here, so no sign
    flips and no slot is excluded, but graddivv cancels on these wide
    cells: 1.3e-5 relative at one slot, my CPU run);
  - av_clean (tests/test_torch_avclean.py): K7c as K7.

The JAX column driver zeroes the z-ghost lanes of its output column
(pallas_ve.py:307-309) and leaves the x-y ghost columns unwritten; the
port's column stages write zeros on every slot outside the interior.
A 2-step resident run with the column stages on each side holds the
resident engine's bounds (dt rtol 1e-5, eint rtol 1e-6, ecin rtol 1e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.init.sedov import init_sedov as j_init_sedov
from sphexa_tpu.ops import cellmajor as jcm
from sphexa_tpu.ops import pallas_ve as jpv
from sphexa_tpu.propagator.ve_pallas import ResidentVE as JResidentVE
from sphexa_tpu.state import _FIELDS
from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.interop import (box_from_numpy, config_from_dict,
                                      state_from_numpy)
from sphexa_tpu_torch.ops import cellmajor as tcm
from sphexa_tpu_torch.ops import pair_ve as tpv
from sphexa_tpu_torch.ops.cellmajor import CMGrid
from sphexa_tpu_torch.propagator.ve_cellmajor import ResidentVE, eta_crit
from sphexa_tpu_torch.sph.eos import eos_ve as t_eos_ve
from torch_threads import one_torch_thread  # noqa: F401

MM = dict(mxu_moments=True, mxu_momentum=True)


def _tgrid(g):
    return CMGrid(n=g.n, cap=g.cap, nzi=g.nzi, nxi=g.nxi)


def _tcfg(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


def _tbox(jb):
    return box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                           jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])


def _to_torch(a):
    if isinstance(a, (list, tuple)):
        return type(a)(_to_torch(v) for v in a)
    return torch.from_numpy(np.array(np.asarray(a)))


@pytest.fixture(scope="module")
def frame():
    """Stage inputs of the port's cell-mode pipeline on the CPU (plain
    versions), as numpy: {method: args}."""
    state, jb, cfg = j_init_sedov(10, JCfg(), dt0=1e-5)
    n = 1000
    r = np.random.default_rng(0)
    h0 = float(state.p.h[0])
    x, y, z = (np.asarray(getattr(state.p, c))
               + r.normal(0, 0.004, n).astype(np.float32) for c in "xyz")
    h = (h0 * (1.0 + 0.05 * r.normal(0, 1, n))).astype(np.float32)
    v = [r.normal(0, 0.3, n).astype(np.float32) for _ in range(3)]
    alpha = r.uniform(0.05, 0.5, n).astype(np.float32)
    _, grid = jcm.choose_cap_and_grid(jb, h0 * 1.2, n, x, y, z)
    assert (grid.n, grid.nz, grid.nx, grid.cap) == (2, 2, 2, 128)
    tg, tb, tc = _tgrid(grid), _tbox(jb), _tcfg(cfg)
    T = torch.from_numpy
    lay = tcm.build_layout(tg, tb, T(x), T(y), T(z))
    pve = tpv.PairVE(tg, tc)

    def refresh(rows):
        return tpv.ghost_refresh(torch.stack(rows), tg, tb)

    def cm(a, fill=0.0):
        return tcm.to_cm(lay, T(np.array(a)), fill)

    base = pve.base_rows(lay, T(x), T(y), T(z), T(h))
    m_cm, vx, vy, vz = cm(state.p.m), cm(v[0]), cm(v[1]), cm(v[2])
    args = {"xmass_h": (list(base), m_cm)}
    xm, hn, nc, _ = pve.xmass_h(base, m_cm)
    xm, hn = refresh([xm, hn])
    base = [base[0], base[1], base[2], hn, base[4]]
    args["gradh"] = (list(base), m_cm, xm)
    kx, gradh = refresh(list(pve.gradh(base, m_cm, xm)))
    rho, _, c, prho = t_eos_ve(cm(state.p.temp), m_cm, kx, xm, gradh,
                               cfg.mui, cfg.gamma)
    va = base[0] < 0.5 * tpv.FILL_POS
    rho, c = torch.where(va, rho, 1.0), torch.where(va, c, 1.0)
    prho = torch.where(va, prho, 0.0)
    args["iad_divv"] = (list(base), kx, xm, vx, vy, vz)
    cij, divv, curlv, gradv = pve.iad_divv(base, kx, xm, vx, vy, vz)
    st = refresh(list(cij) + [divv, curlv] + list(gradv))
    cij, divv, gradv = tuple(st[:6]), st[6], tuple(st[8:])
    alpha_cm = cm(alpha)
    args["av_switches"] = (list(base), c, kx, xm, divv, vx, vy, vz, cij,
                           alpha_cm, torch.tensor(1.3e-5))
    args["momentum"] = (list(base), vx, vy, vz, c, prho, rho, xm, alpha_cm,
                        m_cm, cij)
    kw = {"gradv": gradv, "eta_crit_cm": eta_crit(nc + 1.0)}
    validint = (lay.valid & tcm.interior_mask(tg, "cpu")).numpy()
    return dict(args=_to_numpy(args), kw=_to_numpy(kw), validint=validint,
                cfg=cfg, grid=grid)


def _to_numpy(a):
    if isinstance(a, dict):
        return {k: _to_numpy(v) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return type(a)(_to_numpy(v) for v in a)
    return a.numpy()


def _flat(out):
    rows = []
    for o in out if isinstance(out, tuple) else (out,):
        rows += list(o) if isinstance(o, tuple) else [o]
    return [np.asarray(r) for r in rows]


def _run_both(fr, method, cfg):
    """(JAX column rows, port column rows) of one stage method."""
    args = fr["args"][method]
    kw = fr["kw"] if method == "momentum" and cfg.av_clean else {}
    jpve = jpv.PallasVE(fr["grid"], cfg, interpret=True,
                        kernel_mode="column")
    tpve = tpv.PairVE(_tgrid(fr["grid"]), _tcfg(cfg), kernel_mode="column")
    assert all(k.column and k.name.endswith("_column")
               for k in tpve.kernels)
    jkw = {k: jax.tree.map(jnp.asarray, v) for k, v in kw.items()}
    tkw = {k: _to_torch(v) for k, v in kw.items()}
    jargs = jax.tree.map(jnp.asarray, list(args))
    return (_flat(getattr(jpve, method)(*jargs, **jkw)),
            _flat(getattr(tpve, method)(*_to_torch(list(args)), **tkw)))


def _scaled(a, b, mask, tol=1e-4):
    a, b = a[mask], b[mask]
    scale = max(np.abs(a).max(), 1e-30)
    assert np.abs(b - a).max() <= tol * scale, (np.abs(b - a).max(), scale)


def _rel(a, b, mask, rtol=1e-5):
    np.testing.assert_allclose(b[mask], a[mask], rtol=rtol)


# per method: rows held exactly, rows at rtol 1e-5 (the rest at 1e-4 of
# their scale)
ROWS = {"xmass_h": ((2, 3), (0, 1)), "gradh": ((), (0, 1)),
        "iad_divv": ((), ()), "av_switches": ((), (0,)),
        "momentum": ((), (4,))}


def _check(method, jout, tout, mask):
    exact, rel = ROWS[method]
    assert len(jout) == len(tout)
    for r, (a, b) in enumerate(zip(jout, tout)):
        if r in exact:
            np.testing.assert_array_equal(b[mask], a[mask])
        elif r in rel:
            _rel(a, b, mask)
        else:
            _scaled(a, b, mask)


@pytest.mark.parametrize("method", sorted(ROWS))
def test_column_direct_matches_jax(frame, method):
    jout, tout = _run_both(frame, method, frame["cfg"])
    _check(method, jout, tout, frame["validint"])
    if method == "xmass_h":
        assert jout[2][frame["validint"]].min() > 20   # real neighbourhoods


@pytest.mark.parametrize("method", ["iad_divv", "av_switches", "momentum"])
def test_column_mm_matches_jax(frame, method):
    jout, tout = _run_both(frame, method, frame["cfg"].replace(**MM))
    if method == "av_switches":
        # graddivv is a cancelling moment sum about the cell mean, and
        # the cells of n = 2 are wide against h: alpha follows its
        # summation order (1.3e-5 relative at one slot of 1000, |divv|
        # 3.4 there), so it is held as the mm engine test holds alpha
        _scaled(jout[0], tout[0], frame["validint"])
    else:
        _check(method, jout, tout, frame["validint"])


def test_column_avclean_momentum_matches_jax(frame):
    cfg = frame["cfg"].replace(av_clean=True)
    jout, tout = _run_both(frame, "momentum", cfg)
    _check("momentum", jout, tout, frame["validint"])
    assert jout[4][frame["validint"]].max() > 0


def test_column_zero_outside_interior(frame):
    """The z-ghost lanes of the interior columns are zero in both; the
    port's column stage writes zero on every non-interior slot."""
    jout, tout = _run_both(frame, "gradh", frame["cfg"])
    g = frame["grid"]
    shape = (g.npx, g.np_, g.npz, g.cap)
    zghost = np.zeros(shape, bool)
    zghost[1:-1, 1:-1, [0, -1]] = True
    interior = np.asarray(jcm.interior_mask(g)).reshape(shape)
    for a, b in zip(jout, tout):
        a, b = a.reshape(shape), b.reshape(shape)
        assert (a[zghost] == 0).all() and (b[zghost] == 0).all()
        assert (b[~interior] == 0).all()


@pytest.mark.parametrize("case", ["noncubic", "gated"])
def test_column_refusals_match_jax(frame, case):
    """Where PallasVE asserts (pallas_ve.py:286, :1422), PairVE raises."""
    cfg = frame["cfg"]
    grid = jcm.CMGrid(n=2, cap=128, nzi=4) if case == "noncubic" \
        else frame["grid"]
    kw = {"gated": True} if case == "gated" else {}
    with pytest.raises(AssertionError):
        jpv.PallasVE(grid, cfg, interpret=True, kernel_mode="column", **kw)
    with pytest.raises(ValueError):
        tpv.PairVE(_tgrid(grid), _tcfg(cfg), kernel_mode="column", **kw)


def test_column_mode_names_checked(frame):
    g = _tgrid(frame["grid"])
    with pytest.raises(ValueError):
        tpv.PairVE(g, _tcfg(frame["cfg"]), kernel_mode="columns")
    with pytest.raises(ValueError):            # cubic in y and z only
        tpv.PairVE(CMGrid(n=2, cap=128, nxi=3), _tcfg(frame["cfg"]),
                   kernel_mode="column")


@pytest.mark.parametrize("flags", [{}, MM, dict(MM, mxu_bf16=True),
                                   dict(av_clean=True)],
                         ids=["direct", "mm", "mm-bf16", "avclean"])
def test_column_selects_the_cell_bodies(flags):
    """"column" runs the bodies "cell" picks, through the column kernels
    (cell_pair.cu stage numbers equal)."""
    g = CMGrid(n=3, cap=64)
    cfg = SphConfig(**flags)
    cell = tpv.PairVE(g, cfg).kernels
    col = tpv.PairVE(g, cfg, kernel_mode="column").kernels
    assert [k.name + "_column" for k in cell] == [k.name for k in col]
    assert [k.stage for k in cell] == [k.stage for k in col]
    assert all(k.body is c.body for k, c in zip(cell, col))


def test_column_resident_two_steps_match_jax():
    """The resident engine with column stages on both sides, 2 steps
    from the same Sedov 10^3 state, a rebin forced before step 1."""
    state, jb, cfg = j_init_sedov(10, JCfg(), dt0=2e-4)
    alive = np.asarray(state.p.alive)
    _, grid = jcm.choose_cap_and_grid(
        jb, float(state.p.h[0]) * 1.2, 1000,
        *(np.asarray(getattr(state.p, c))[alive] for c in "xyz"))
    host = ({f: np.asarray(getattr(state.p, f)) for f in _FIELDS},
            float(state.ttot), float(state.dt), float(state.dt_m1),
            int(state.iteration))
    jeng = JResidentVE(jb, grid, cfg, interpret=True)
    jeng.pve = jpv.PallasVE(grid, cfg, interpret=True, kernel_mode="column")
    teng = ResidentVE(_tbox(jb), _tgrid(grid), _tcfg(cfg), device="cpu")
    teng.pve = tpv.PairVE(teng.grid, teng.cfg, kernel_mode="column")
    jr, tr = jeng.bind(state), teng.bind(state_from_numpy(*host,
                                                          device="cpu"))
    for i in range(2):
        if i == 1:
            jr = jr.replace(drift=jnp.float32(1e9))
            tr = tr.replace(drift=tr.drift.new_tensor(1e9))
        jr, a = jeng.step(jr)
        tr, b = teng.step(tr)
        assert int(a.overflow) == int(b.overflow) == 0
        assert bool(a.rebinned) == bool(b.rebinned) == (i == 1)
        np.testing.assert_allclose(float(b.dt), float(a.dt), rtol=1e-5)
        np.testing.assert_allclose(float(b.eint), float(a.eint), rtol=1e-6)
        np.testing.assert_allclose(float(b.ecin), float(a.ecin), rtol=1e-3,
                                   atol=1e-12)
