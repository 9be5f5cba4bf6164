"""The port's pair stages K3-K6 at cap 1152, past the former ceiling of
1024, against the Pallas kernels of the JAX package in interpret mode
(PallasVE(interpret=True) at the same cap, which splits each cell into
128-slot i-blocks).

The frame (clump_frame, also chip_smoke.py's phase (s)): CMGrid(n=2,
cap=1152) on the open cube [-1, 1]^3 and a clump with Evrard's 1/r
density profile (init/evrard.py's construction: a lattice sphere with
its radii contracted), radius 0.8, centred at (0.3, 0.3, 0.3), its
points jittered by a seeded 3% of the lattice spacing, so the densest
cell, (+, +, +), holds 1,120 rows and its neighbours 17-274; h midway
between the distances to the 100th and 101st neighbours (a relaxed h,
no pair on the support's edge), and temperatures giving sound speeds
near 1 against velocities of sigma 0.3. Each stage gets the JAX
pipeline's own inputs (K3 -> ghost refresh -> K4 -> EOS -> K5 -> K6),
and the stages are compared one at a time on interior valid slots, at
the tolerances of tests/test_torch_pair_ve.py:

  - nc, nonconv: exact (the same float32 distance and support test).
  - h, xm, kx, gradh, alpha: rtol 1e-5 (sums in another order).
  - c11..c33, divv, curlv, gradv: atol 1e-4 x the row's max |value|
    (cancelling sums).

K7 (momentum), whose JAX side takes about half a minute at this cap, is
held in tests/test_torch_bigcap_momentum.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.ops import cellmajor as jcm
from sphexa_tpu.ops import pallas_ve as jpv
from sphexa_tpu.sfc.box import Box as JBox, Boundary as JB
from sphexa_tpu.sph.eos import eos_ve as j_eos_ve, ideal_gas_cv
from sphexa_tpu_torch.interop import config_from_dict
from sphexa_tpu_torch.ops import cellmajor as tcm
from sphexa_tpu_torch.ops import pair_ve as tpv
from torch_threads import two_torch_threads  # noqa: F401

CAP = 1152


def clump_frame(side=16, radius=0.8, seed=7, ng=100):
    """(x, y, z, h) of the clump frame as float32 numpy arrays, the JAX
    box and grid: the side^3 lattice on [-1, 1)^3 cut to the unit
    sphere, radii r -> radius sqrt(r) r (rho ~ 1/r), centred at (0.3,
    0.3, 0.3), jittered (sigma 3% of the spacing); h the mean of the
    distances to the ng-th and (ng + 1)-th neighbours over 2, at most
    0.45 (2 h within the cell edge)."""
    from scipy.spatial import cKDTree
    r = np.random.default_rng(seed)
    g = (np.arange(side) + 0.5) / side * 2.0 - 1.0
    p = np.stack([a.ravel() for a in np.meshgrid(g, g, g, indexing="ij")],
                 axis=1)
    rad = np.sqrt((p ** 2).sum(1))
    p, rad = p[rad <= 1.0], rad[rad <= 1.0]
    p = p * (radius * np.sqrt(rad))[:, None] + 0.3
    p = (p + r.normal(0.0, 0.03 * 2.0 / side * radius, p.shape)).clip(
        -0.999, 0.999)
    d = cKDTree(p).query(p, ng + 2)[0]
    h = np.minimum(0.25 * (d[:, -2] + d[:, -1]), 0.45)
    jb = JBox(-1.0, 1.0, -1.0, 1.0, -1.0, 1.0, JB.open, JB.open, JB.open)
    return ([p[:, k].astype(np.float32) for k in range(3)],
            h.astype(np.float32), jb, jcm.CMGrid(n=2, cap=CAP))


def to_torch(a):
    if isinstance(a, (list, tuple)):
        return type(a)(to_torch(v) for v in a)
    return torch.from_numpy(np.array(np.asarray(a)))


def port_stages(grid, cfg):
    return tpv.PairVE(tcm.CMGrid(n=grid.n, cap=grid.cap),
                      config_from_dict(dataclasses.asdict(cfg)))


def jax_pipeline():
    """The JAX pipeline's inputs and outputs of K3-K6 on the clump."""
    (x, y, z), h, jb, grid = clump_frame()
    n = x.size
    r = np.random.default_rng(8)
    m = np.full(n, 1.0 / n, np.float32)
    v = [r.normal(0, 0.3, n).astype(np.float32) for _ in range(3)]
    cfg = JCfg()
    # u = cv T in [0.5, 1.5]: sound speeds near 1
    temp = (r.uniform(0.5, 1.5, n) / ideal_gas_cv(cfg.mui, cfg.gamma)
            ).astype(np.float32)
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
    io = {}
    io["xh"] = ((list(base), m_cm), pve.xmass_h(base, m_cm))
    xm, hn, _, _ = io["xh"][1]
    st = refresh(jnp.stack([xm, hn]))
    xm, hn = st[0], st[1]
    base = [base[0], base[1], base[2], hn, base[4]]
    io["gradh"] = ((list(base), m_cm, xm), pve.gradh(base, m_cm, xm))
    st = refresh(jnp.stack(io["gradh"][1]))
    kx, gradh = st[0], st[1]
    rho, _, c, _ = j_eos_ve(cm(temp), m_cm, kx, xm, gradh, cfg.mui,
                            cfg.gamma)
    va = base[0] < 0.5 * jpv.FILL_POS
    c = jnp.where(va, c, 1.0)
    io["iad"] = ((list(base), kx, xm, vx, vy, vz),
                 pve.iad_divv(base, kx, xm, vx, vy, vz))
    cij, divv, _, _ = io["iad"][1]
    st = refresh(jnp.stack(list(cij) + [divv]))
    cij, divv = tuple(st[i] for i in range(6)), st[6]
    dt = jnp.float32(1.3e-5)
    io["av"] = ((list(base), c, kx, xm, divv, vx, vy, vz, cij, cm(alpha),
                 dt),
                pve.av_switches(base, c, kx, xm, divv, vx, vy, vz, cij,
                                cm(alpha), dt))
    mask = np.asarray(lay.valid & jcm.interior_mask(grid))
    cnt = mask.reshape(-1, grid.cap).sum(1)
    return io, mask, port_stages(grid, cfg), int(cnt.max())


@pytest.fixture(scope="module")
def frame():
    return jax_pipeline()


def _run(frame, stage, method):
    io, mask, tpve, _ = frame
    args, jout = io[stage]
    tout = getattr(tpve, method)(*to_torch(list(args)))
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


def test_frame_is_past_1024(frame):
    assert 1024 < frame[3] <= CAP


def test_k3_xmass_h_cap1152(frame):
    (jxm, jh, jnc, jnon), (txm, th, tnc, tnon), mask = _run(
        frame, "xh", "xmass_h")
    _exact(jnc, tnc, mask)
    _exact(jnon, tnon, mask)
    _rel(jh, th, mask)
    _rel(jxm, txm, mask)
    assert np.asarray(jnc)[mask].min() > 10


def test_k4_gradh_cap1152(frame):
    (jkx, jg), (tkx, tg), mask = _run(frame, "gradh", "gradh")
    _rel(jkx, tkx, mask)
    _rel(jg, tg, mask)


def test_k5_iad_divv_cap1152(frame):
    jout, tout, mask = _run(frame, "iad", "iad_divv")
    (jcij, jdivv, jcurl, jgv), (tcij, tdivv, tcurl, tgv) = jout, tout
    for a, b in zip(jcij + (jdivv, jcurl) + jgv, tcij + (tdivv, tcurl) + tgv):
        _scaled(a, b, mask)
    assert np.abs(np.asarray(jdivv)[mask]).max() > 0


def test_k6_av_switches_cap1152(frame):
    jal, tal, mask = _run(frame, "av", "av_switches")
    _rel(jal, tal, mask)
