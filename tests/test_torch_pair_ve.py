"""The port's pair stages (K3-K7) and ghost refresh (K1) against the
Pallas kernels of the JAX package, run in interpret mode.

Inputs are the cm frame of a perturbed Sedov 10^3 state (seeded numpy
jitter of positions and h, random velocities and alpha), built by the
JAX layout and base rows and carried across as numpy. Each stage gets
the JAX pipeline's own inputs, so the stages are compared one at a
time, on interior valid slots (the Pallas driver writes garbage into
z-ghost slots). Tolerances, and why:

  - nc, nonconv: exact. Squared distances, the support test and the h
    controller are the same float32 operations in both packages.
  - h, xm, kx, gradh, alpha: rtol 1e-5. The pair sums are reduced in
    another order (the Pallas body folds nine z-run windows, the plain
    version sums one 27-cell row).
  - c11..c33, divv, curlv, gradv, ax, ay, az, du: atol 1e-4 x the row's
    max |value|. These sums cancel (antisymmetric pair terms), so an
    order change shows relative to the row's scale, not to each entry.
  - maxvsignal: rtol 1e-5 (a max of per-pair terms with one rsqrt).
K1 is a copy plus an exact shift, so it is bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.init.sedov import init_sedov as j_init_sedov
from sphexa_tpu.ops import cellmajor as jcm
from sphexa_tpu.ops import pallas_ve as jpv
from sphexa_tpu.sfc.box import Box as JBox, Boundary as JBoundary
from sphexa_tpu.sph.eos import eos_ve as j_eos_ve
from sphexa_tpu_torch.interop import box_from_numpy, config_from_dict
from sphexa_tpu_torch.ops import cellmajor as tcm
from sphexa_tpu_torch.ops import pair_ve as tpv
from torch_threads import one_torch_thread  # noqa: F401


def _tbox(jb):
    return box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                           jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])


def _tgrid(g):
    return tcm.CMGrid(n=g.n, cap=g.cap, nzi=g.nzi, nxi=g.nxi)


def _cfg_dict(cfg):
    import dataclasses
    return dataclasses.asdict(cfg)


@pytest.fixture(scope="module")
def frame():
    """JAX stage inputs and outputs on a perturbed Sedov 10^3 frame."""
    state, jb, cfg = j_init_sedov(10, JCfg(), dt0=1e-5)
    n = 1000
    r = np.random.default_rng(0)
    h0 = float(state.p.h[0])
    x, y, z = (np.asarray(getattr(state.p, c))
               + r.normal(0, 0.004, n).astype(np.float32) for c in "xyz")
    h = (h0 * (1.0 + 0.05 * r.normal(0, 1, n))).astype(np.float32)
    m = np.asarray(state.p.m)
    v = [r.normal(0, 0.3, n).astype(np.float32) for _ in range(3)]
    temp = np.asarray(state.p.temp)
    alpha = r.uniform(0.05, 0.5, n).astype(np.float32)
    cap, grid = jcm.choose_cap_and_grid(jb, h0 * 1.2, n, x, y, z)

    J = jnp.asarray
    lay = jcm.build_layout(grid, jb, J(x), J(y), J(z))
    pve = jpv.PallasVE(grid, cfg, interpret=True)

    def refresh(st):
        return jpv.make_ghost_refresh(grid, jb, st.shape[0],
                                      interpret=True)(st)

    def cm(a, fill=0.0):
        return jcm.to_cm(lay, J(a), fill)

    base = pve.base_rows(lay, J(x), J(y), J(z), J(h))
    m_cm, vx, vy, vz = cm(m), cm(v[0]), cm(v[1]), cm(v[2])
    io = {}
    io["xh"] = ((list(base), m_cm), pve.xmass_h(base, m_cm))
    xm, hn, _, _ = io["xh"][1]
    st = refresh(jnp.stack([xm, hn]))
    xm, hn = st[0], st[1]
    base = [base[0], base[1], base[2], hn, base[4]]
    io["gradh"] = ((list(base), m_cm, xm), pve.gradh(base, m_cm, xm))
    st = refresh(jnp.stack(io["gradh"][1]))
    kx, gradh = st[0], st[1]
    rho, _, c, prho = j_eos_ve(cm(temp), m_cm, kx, xm, gradh, cfg.mui,
                               cfg.gamma)
    va = base[0] < 0.5 * jpv.FILL_POS
    rho, c = jnp.where(va, rho, 1.0), jnp.where(va, c, 1.0)
    prho = jnp.where(va, prho, 0.0)
    io["iad"] = ((list(base), kx, xm, vx, vy, vz),
                 pve.iad_divv(base, kx, xm, vx, vy, vz))
    cij, divv, curlv, _ = io["iad"][1]
    st = refresh(jnp.stack(list(cij) + [divv, curlv]))
    cij, divv = tuple(st[i] for i in range(6)), st[6]
    dt = jnp.float32(1.3e-5)
    alpha_cm = cm(alpha)
    io["av"] = ((list(base), c, kx, xm, divv, vx, vy, vz, cij, alpha_cm, dt),
                pve.av_switches(base, c, kx, xm, divv, vx, vy, vz, cij,
                                alpha_cm, dt))
    io["momentum"] = ((list(base), vx, vy, vz, c, prho, rho, xm, alpha_cm,
                       m_cm, cij),
                      pve.momentum(base, vx, vy, vz, c, prho, rho, xm,
                                   alpha_cm, m_cm, cij))
    mask = np.asarray(lay.valid & jcm.interior_mask(grid))
    tpve = tpv.PairVE(_tgrid(grid), config_from_dict(_cfg_dict(cfg)))
    return io, mask, tpve


def _to_torch(a):
    if isinstance(a, (list, tuple)):
        return type(a)(_to_torch(v) for v in a)
    return torch.from_numpy(np.array(np.asarray(a)))


def _run(frame, stage, method):
    io, mask, tpve = frame
    args, jout = io[stage]
    tout = getattr(tpve, method)(*_to_torch(list(args)))
    return jout, tout, mask


def _exact(a, b, mask):
    np.testing.assert_array_equal(np.asarray(b)[mask], np.asarray(a)[mask])


def _rel(a, b, mask, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(b)[mask], np.asarray(a)[mask],
                               rtol=rtol)


def _scaled(a, b, mask, tol=1e-4):
    a, b = np.asarray(a)[mask], np.asarray(b)[mask]
    scale = max(np.abs(a).max(), 1e-30)
    assert np.abs(b - a).max() <= tol * scale, (np.abs(b - a).max(), scale)


def test_k3_xmass_h(frame):
    (jxm, jh, jnc, jnon), (txm, th, tnc, tnon), mask = _run(
        frame, "xh", "xmass_h")
    _exact(jnc, tnc, mask)
    _exact(jnon, tnon, mask)
    _rel(jh, th, mask)
    _rel(jxm, txm, mask)
    assert np.asarray(jnc)[mask].min() > 20     # a real neighbourhood


def test_k4_gradh(frame):
    (jkx, jg), (tkx, tg), mask = _run(frame, "gradh", "gradh")
    _rel(jkx, tkx, mask)
    _rel(jg, tg, mask)


def test_k5_iad_divv(frame):
    jout, tout, mask = _run(frame, "iad", "iad_divv")
    (jcij, jdivv, jcurl, jgv), (tcij, tdivv, tcurl, tgv) = jout, tout
    for a, b in zip(jcij + (jdivv, jcurl) + jgv, tcij + (tdivv, tcurl) + tgv):
        _scaled(a, b, mask)
    assert np.abs(np.asarray(jdivv)[mask]).max() > 0


def test_k6_av_switches(frame):
    jal, tal, mask = _run(frame, "av", "av_switches")
    _rel(jal, tal, mask)


def test_k7_momentum(frame):
    jout, tout, mask = _run(frame, "momentum", "momentum")
    for a, b in zip(jout[:4], tout[:4]):
        _scaled(a, b, mask)
    _rel(jout[4], tout[4], mask)
    assert np.asarray(jout[4])[mask].max() > 0


@pytest.mark.parametrize("h_scale", [1.0, 1.15])
def test_k3_parity4_windows(h_scale):
    """Cap 64 with an even z-group: the Pallas driver reads four z-cells
    per window (pallas_ve.py:199-223), the port's stencil three. The sums
    agree while 2h stays near the cell edge; h_scale 1.15 puts 2h of
    most particles past the edge (0.276 vs 0.25), beyond what the
    resident engine's rebin margin allows."""
    state, jb, cfg = j_init_sedov(12, JCfg(), dt0=1e-5)
    n = 12 ** 3
    r = np.random.default_rng(3)
    h0 = float(state.p.h[0])
    xyz = [np.asarray(getattr(state.p, c))
           + r.normal(0, 0.04 * h0, n).astype(np.float32) for c in "xyz"]
    h = (h_scale * h0 * (1.0 + 0.05 * r.normal(0, 1, n))).astype(np.float32)
    grid = jcm.CMGrid(n=4, cap=64)
    assert jcm.legal_zgroup(grid.npz, grid.cap) % 2 == 0   # parity-4 path
    lay = jcm.build_layout(grid, jb, *map(jnp.asarray, xyz))
    pve = jpv.PallasVE(grid, cfg, interpret=True)
    base = pve.base_rows(lay, *map(jnp.asarray, xyz), jnp.asarray(h))
    m = jcm.to_cm(lay, state.p.m)
    jout = pve.xmass_h(base, m)
    tpve = tpv.PairVE(_tgrid(grid), config_from_dict(_cfg_dict(cfg)))
    tout = tpve.xmass_h(_to_torch(list(base)), _to_torch(m))
    mask = np.asarray(lay.valid & jcm.interior_mask(grid))
    _exact(jout[2], tout[2], mask)
    _exact(jout[3], tout[3], mask)
    _rel(jout[1], tout[1], mask)
    _rel(jout[0], tout[0], mask)


BOXES = {
    "periodic": (JBoundary.periodic,) * 3,
    "open": (JBoundary.open,) * 3,
    "mixed": (JBoundary.periodic, JBoundary.open, JBoundary.periodic),
}


@pytest.mark.parametrize("boxname", sorted(BOXES))
@pytest.mark.parametrize("grid", [jcm.CMGrid(n=2, cap=128),
                                  jcm.CMGrid(n=2, cap=32, nzi=4, nxi=3)],
                         ids=["sedov10", "noncubic"])
@pytest.mark.parametrize("xyz_rows", [(0, 1, 2), None], ids=["xyz", "copy"])
def test_k1_ghost_refresh_bit_equal(boxname, grid, xyz_rows):
    jb = JBox(-0.5, 0.5, -0.5, 0.5, -0.5, 0.5, *BOXES[boxname])
    nrows = 12 if xyz_rows else 8
    r = np.random.default_rng(5)
    stack = r.normal(0, 1, (nrows, grid.n_slots)).astype(np.float32)
    a = jpv.make_ghost_refresh(grid, jb, nrows, xyz_rows=xyz_rows,
                               interpret=True)(jnp.asarray(stack))
    t = torch.from_numpy(stack.copy())
    b = tpv.ghost_refresh(t, _tgrid(grid), _tbox(jb), xyz_rows)
    assert b is t                         # refreshed in place
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    if boxname != "periodic" and xyz_rows:
        assert (b.numpy() == np.float32(tpv.FILL_POS)).any()
