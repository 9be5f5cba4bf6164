"""The port's moment-matmul stages K8 (pair_iad_mm), K9 (pair_av_mm) and
K10 (pair_momentum_mm, float32 and mxu_bf16) against the JAX package's
PallasVE under the same options (interpret mode), one stage at a time
on identical inputs; their gated forms (K2g) against PallasVE(gated=
True); and the factorization against the port's direct stages.

Frames: the JAX direct pipeline's inputs of a perturbed Sedov state
(seeded numpy jitter of positions and h, random velocities and alpha)
on two grids: Sedov 12^3 on CMGrid(n=4, cap=64) (even Z and nz, so the
Pallas driver reads its parity-4 windows) and Sedov 10^3 on
CMGrid(n=4, cap=128) (Z = 6: the gate unit of the gated tests).
Compared on interior valid slots. Tolerances, and why:

  - K8: all 14 rows within 1e-4 of the row's max |value| (cij, divv,
    curlv, gradv). The moment sums cancel (centred moments, antisymmetric
    pair terms), so a change of summation order shows relative to the
    row's scale; measured up to 6e-6.
  - K9: alpha rtol 1e-5, K6's bound: divv is an input here, so no sign
    can flip; measured up to 6e-6.
  - K10 float32: ax, ay, az, du within 1e-4 of their row's scale,
    maxvsignal rtol 1e-5 (a max of per-pair terms).
  - K10 mxu_bf16 against JAX's bf16: 5e-4 of the row's scale (measured
    up to 3e-5; an operand one float32 ulp apart in the two packages can
    round to bf16 values 2^-8 apart); against the port's float32 K10:
    apart by more than 1e-6 of scale (the rounding is applied) and
    within 3.8e-2 (the spread of vx between the bf16 and float32 JAX
    engines after 3 steps at Sedov 10^3).
  - gated: the slots of active z-supercells as above; the interior slots
    of inactive ones bit-equal to prev.
  - mm against direct (the port alone): K8 against K5 and K10 against K7
    with uniform_mass off (K10's Atwood ramp), within 1e-4 of scale.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.init.sedov import init_sedov as j_init_sedov
from sphexa_tpu.ops import cellmajor as jcm
from sphexa_tpu.ops import pallas_ve as jpv
from sphexa_tpu.sph.eos import eos_ve as j_eos_ve
from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.interop import config_from_dict
from sphexa_tpu_torch.ops import pair_ve as tpv
from sphexa_tpu_torch.ops.cellmajor import CMGrid
from torch_threads import one_torch_thread  # noqa: F401

MM = dict(mxu_moments=True, mxu_momentum=True)
FRAMES = {"cap64": (12, jcm.CMGrid(n=4, cap=64)),
          "cap128": (10, jcm.CMGrid(n=4, cap=128))}


def _tgrid(g):
    return CMGrid(n=g.n, cap=g.cap, nzi=g.nzi, nxi=g.nxi)


def _tcfg(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


def _to_torch(a):
    if isinstance(a, (list, tuple)):
        return type(a)(_to_torch(v) for v in a)
    return torch.from_numpy(np.array(np.asarray(a)))


def _frame(side, grid):
    """Stage inputs of the JAX direct pipeline on a perturbed Sedov
    frame: {method: args}, the interior valid mask, the base config."""
    state, jb, cfg = j_init_sedov(side, JCfg(), dt0=1e-5)
    n = side ** 3
    r = np.random.default_rng(0)
    h0 = float(state.p.h[0])
    x, y, z = (np.asarray(getattr(state.p, c))
               + r.normal(0, 0.03 * h0, n).astype(np.float32) for c in "xyz")
    h = (h0 * (1.0 + 0.05 * r.normal(0, 1, n))).astype(np.float32)
    m = np.asarray(state.p.m)
    v = [r.normal(0, 0.3, n).astype(np.float32) for _ in range(3)]
    alpha = r.uniform(0.05, 0.5, n).astype(np.float32)
    J = jnp.asarray
    lay = jcm.build_layout(grid, jb, J(x), J(y), J(z))
    assert int(lay.overflow) == 0
    pve = jpv.PallasVE(grid, cfg, interpret=True)

    def refresh(st):
        return jpv.make_ghost_refresh(grid, jb, st.shape[0],
                                      interpret=True)(st)

    def cm(a, fill=0.0):
        return jcm.to_cm(lay, J(a), fill)

    base = pve.base_rows(lay, J(x), J(y), J(z), J(h))
    m_cm, vx, vy, vz = cm(m), cm(v[0]), cm(v[1]), cm(v[2])
    xm, hn, _, _ = pve.xmass_h(base, m_cm)
    st = refresh(jnp.stack([xm, hn]))
    xm, hn = st[0], st[1]
    base = [base[0], base[1], base[2], hn, base[4]]
    st = refresh(jnp.stack(pve.gradh(base, m_cm, xm)))
    kx, gradh = st[0], st[1]
    rho, _, c, prho = j_eos_ve(cm(np.asarray(state.p.temp)), m_cm, kx, xm,
                               gradh, cfg.mui, cfg.gamma)
    va = base[0] < 0.5 * jpv.FILL_POS
    rho, c = jnp.where(va, rho, 1.0), jnp.where(va, c, 1.0)
    prho = jnp.where(va, prho, 0.0)
    args = {"iad_divv": (list(base), kx, xm, vx, vy, vz)}
    cij, divv, curlv, _ = pve.iad_divv(base, kx, xm, vx, vy, vz)
    st = refresh(jnp.stack(list(cij) + [divv, curlv]))
    cij, divv = tuple(st[i] for i in range(6)), st[6]
    alpha_cm = cm(alpha)
    args["av_switches"] = (list(base), c, kx, xm, divv, vx, vy, vz, cij,
                           alpha_cm, jnp.float32(1.3e-5))
    args["momentum"] = (list(base), vx, vy, vz, c, prho, rho, xm, alpha_cm,
                        m_cm, cij)
    validint = np.asarray(lay.valid & jcm.interior_mask(grid))
    return dict(args=args, validint=validint, cfg=cfg, grid=grid)


@pytest.fixture(scope="module")
def frames():
    return {k: _frame(*v) for k, v in FRAMES.items()}


def _flat(out):
    rows = []
    for o in out if isinstance(out, tuple) else (out,):
        rows += list(o) if isinstance(o, tuple) else [o]
    return [np.asarray(r) for r in rows]


def _scaled(a, b, mask, tol=1e-4):
    a, b = a[mask], b[mask]
    scale = max(np.abs(a).max(), 1e-30)
    err = np.abs(b - a).max()
    assert err <= tol * scale, (err, scale)
    return err / scale


def _rel(a, b, mask, rtol=1e-5):
    np.testing.assert_allclose(b[mask], a[mask], rtol=rtol)


def _run_both(fr, method, cfg, **pve_kw):
    """(JAX rows, port rows) of one stage method on the frame's inputs."""
    args = fr["args"][method]
    jpve = jpv.PallasVE(fr["grid"], cfg, interpret=True, **pve_kw)
    tpve = tpv.PairVE(_tgrid(fr["grid"]), _tcfg(cfg), **pve_kw)
    return (_flat(getattr(jpve, method)(*args)),
            _flat(getattr(tpve, method)(*_to_torch(list(args)))))


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_k8_iad_mm_matches_jax(frames, frame):
    fr = frames[frame]
    jout, tout = _run_both(fr, "iad_divv", fr["cfg"].replace(**MM))
    assert len(tout) == 14
    for a, b in zip(jout, tout):
        _scaled(a, b, fr["validint"])
    assert np.abs(jout[6][fr["validint"]]).max() > 0


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_k9_av_mm_matches_jax(frames, frame):
    fr = frames[frame]
    jout, tout = _run_both(fr, "av_switches", fr["cfg"].replace(**MM))
    _rel(jout[0], tout[0], fr["validint"])


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_k10_momentum_mm_matches_jax(frames, frame, bf16):
    fr = frames[frame]
    cfg = fr["cfg"].replace(**MM, mxu_bf16=bf16)
    jout, tout = _run_both(fr, "momentum", cfg)
    mask = fr["validint"]
    for a, b in zip(jout[:4], tout[:4]):
        _scaled(a, b, mask, 5e-4 if bf16 else 1e-4)
    _rel(jout[4], tout[4], mask)
    assert jout[4][mask].max() > 0


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_k10_bf16_rounds_within_the_engine_spread(frames, frame):
    fr = frames[frame]
    args = _to_torch(list(fr["args"]["momentum"]))
    g = _tgrid(fr["grid"])
    fp32 = tpv.PairVE(g, _tcfg(fr["cfg"].replace(**MM))).momentum(*args)
    bf16 = tpv.PairVE(g, _tcfg(fr["cfg"].replace(**MM, mxu_bf16=True))
                      ).momentum(*args)
    mask = torch.from_numpy(fr["validint"].copy())
    for a, b in zip(fp32[:4], bf16[:4]):
        a, b = a[mask], b[mask]
        rel = float((b - a).abs().max() / a.abs().max())
        assert 1e-6 < rel <= 3.8e-2, rel


GATED = {"iad_divv": 14, "av_switches": 1, "momentum": 5}


@pytest.mark.parametrize("method", sorted(GATED))
def test_gated_mm_matches_jax(frames, method):
    """K2g forms of K8-K10 at Z = 6, on an activity pattern with wholly
    active, wholly inactive and mixed columns."""
    fr = frames["cap128"]
    grid = fr["grid"]
    shape = (grid.npx, grid.np_, grid.npz, grid.cap)
    vi = fr["validint"].reshape(shape)
    act = np.zeros(shape, np.float32)
    for cx in range(1, grid.nx + 1):
        for cy in range(1, grid.n + 1):
            kind = (cx + 2 * cy) % 3
            if kind == 0:
                act[cx, cy] = vi[cx, cy]
            elif kind == 2:
                cz = 1 + (cx + cy) % grid.nz
                act[cx, cy, cz, int(np.flatnonzero(vi[cx, cy, cz])[0])] = 1.0
    act = act.reshape(-1)
    fo = GATED[method]
    prev = np.random.default_rng(11).normal(
        0, 1, (fo, grid.n_slots)).astype(np.float32)
    cfg = fr["cfg"].replace(**MM)
    args = fr["args"][method]
    jpve = jpv.PallasVE(grid, cfg, interpret=True, gated=True)
    jout = _flat(getattr(jpve, method)(
        *args, gate=(jnp.asarray(act), [jnp.asarray(p) for p in prev])))
    tpve = tpv.PairVE(_tgrid(grid), _tcfg(cfg), gated=True)
    assert tpve.zgroup == 6
    tout = _flat(getattr(tpve, method)(
        *_to_torch(list(args)),
        gate=(torch.from_numpy(act), [torch.from_numpy(p) for p in prev])))
    on = tpv.supercell_active(torch.from_numpy(act), _tgrid(grid),
                              6).repeat_interleave(grid.cap).numpy()
    interior = np.asarray(jcm.interior_mask(grid))
    keep = interior & ~on
    assert keep.any() and (on & fr["validint"]).any()
    mask = fr["validint"] & on
    for r, (a, b) in enumerate(zip(jout, tout)):
        np.testing.assert_array_equal(b[keep], prev[r][keep])
        if method == "av_switches" or (method == "momentum" and r == 4):
            _rel(a, b, mask)
        else:
            _scaled(a, b, mask)


def test_mm_factorization_against_direct(frames):
    """The port's K8 against its K5 and K10 against K7 (uniform_mass
    off: K10 always takes K7's exp form of the Atwood ramp) on the same
    inputs, as a check of the factorization that does not go through
    JAX."""
    fr = frames["cap64"]
    g = _tgrid(fr["grid"])
    mask = fr["validint"]
    base = fr["cfg"].replace(uniform_mass=False)
    direct = tpv.PairVE(g, _tcfg(base))
    mm = tpv.PairVE(g, _tcfg(base.replace(**MM)))
    for method in ("iad_divv", "momentum"):
        args = _to_torch(list(fr["args"][method]))
        a = _flat(getattr(direct, method)(*args))
        b = _flat(getattr(mm, method)(*args))
        for r, (x, y) in enumerate(zip(a, b)):
            if method == "momentum" and r == 4:
                _rel(x, y, mask)
            else:
                _scaled(x, y, mask)


@pytest.mark.parametrize("stage", ["pair_iad_mm", "pair_av_mm",
                                   "pair_momentum_mm"])
def test_mm_invalid_slots_zero_and_finite(frames, stage):
    """Every output is finite, and the interior slots that hold no
    particle come out zero."""
    fr = frames["cap128"]
    cfg = fr["cfg"].replace(**MM)
    pve = tpv.PairVE(_tgrid(fr["grid"]), _tcfg(cfg))
    method = {"pair_iad_mm": "iad_divv", "pair_av_mm": "av_switches",
              "pair_momentum_mm": "momentum"}[stage]
    assert any(k.name == stage for k in pve.kernels)
    out = np.stack(_flat(getattr(pve, method)(
        *_to_torch(list(fr["args"][method])))))
    assert np.isfinite(out).all()
    interior = np.asarray(jcm.interior_mask(fr["grid"]))
    empty = interior & ~fr["validint"]
    assert empty.any()
    assert (out[:, empty] == 0).all()


@pytest.mark.parametrize("flags,names", [
    ({}, ("pair_iad", "pair_av", "pair_momentum")),
    (dict(mxu_moments=True), ("pair_iad_mm", "pair_av_mm", "pair_momentum")),
    (dict(mxu_momentum=True), ("pair_iad", "pair_av", "pair_momentum_mm")),
    (MM, ("pair_iad_mm", "pair_av_mm", "pair_momentum_mm")),
    (dict(MM, mxu_bf16=True), ("pair_iad_mm", "pair_av_mm",
                               "pair_momentum_mm")),
], ids=["direct", "moments", "momentum", "mm", "mm-bf16"])
@pytest.mark.parametrize("gated", [False, True], ids=["K2", "K2g"])
def test_body_selection(flags, names, gated):
    """PairVE picks the bodies as PallasVE.__init__ (pallas_ve.py:
    1427-1436); the gated engine their K2g forms."""
    pve = tpv.PairVE(CMGrid(n=2, cap=64), SphConfig(**flags),
                     gated=gated)
    want = ("pair_xh", "pair_gradh") + names
    if gated:
        want = tuple(w + "_gated" for w in want)
    assert tuple(k.name for k in pve.kernels) == want
