"""The port's avClean momentum stage K7c (pair_momentum_avclean) and the
resident engine under SphConfig(av_clean=True) against the JAX package
(Pallas in interpret mode).

  - K7c against PallasVE(av_clean).momentum on the JAX pipeline's own
    inputs of a perturbed Sedov 10^3 frame on CMGrid(n=4, cap=64): the
    six gradv rows of the IAD stage (ghost-refreshed) and eta_crit =
    cbrt(32 pi / 3 / max(nc_sph, 1)) ride after cij. ax, ay, az, du
    within 1e-4 of their row's scale (cancelling pair sums; measured
    below 1e-6), maxvsignal rtol 1e-5.
  - mxu_momentum together with av_clean runs the avClean direct body,
    as PallasVE does (pallas_ve.py:1432-1435): the port's stage is K7c
    and gives K7c's result bit for bit (so the comparison above holds
    for it too).
  - The engine, 3 steps from the same Sedov 10^3 state with a forced
    rebin, against the JAX ResidentVE(av_clean): the bounds of
    tests/test_torch_resident.py (dt rtol 1e-5, eint rtol 1e-6, ecin
    rtol 1e-3, unbound fields within 2e-3 of scale), and alpha within
    1e-4 of its scale (the direct AV body: no moment cancellation).
The JAX reference is computed once per module.
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
from sphexa_tpu.ops.cellmajor import choose_cap_and_grid
from sphexa_tpu.propagator.ve_pallas import ResidentVE as JResidentVE
from sphexa_tpu.sph.eos import eos_ve as j_eos_ve
from sphexa_tpu.state import _FIELDS
from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.interop import (box_from_numpy, config_from_dict,
                                      state_from_numpy)
from sphexa_tpu_torch.ops import pair_ve as tpv
from sphexa_tpu_torch.ops.cellmajor import CMGrid
from sphexa_tpu_torch.propagator.ve_bdt import BdtVE
from sphexa_tpu_torch.propagator.ve_cellmajor import ResidentVE, eta_crit
from torch_threads import one_torch_thread  # noqa: F401

N_STEPS = 3
FORCE_REBIN_AT = 1


def _tbox(jb):
    return box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                           jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])


def _tcfg(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


def _to_torch(a):
    if isinstance(a, (list, tuple)):
        return type(a)(_to_torch(v) for v in a)
    return torch.from_numpy(np.array(np.asarray(a)))


@pytest.fixture(scope="module")
def frame():
    """The momentum stage's inputs of the JAX avClean pipeline."""
    state, jb, cfg = j_init_sedov(10, JCfg(), dt0=1e-5)
    cfg = cfg.replace(av_clean=True)
    n = 1000
    r = np.random.default_rng(0)
    h0 = float(state.p.h[0])
    x, y, z = (np.asarray(getattr(state.p, c))
               + r.normal(0, 0.004, n).astype(np.float32) for c in "xyz")
    h = (h0 * (1.0 + 0.05 * r.normal(0, 1, n))).astype(np.float32)
    v = [r.normal(0, 0.3, n).astype(np.float32) for _ in range(3)]
    alpha = r.uniform(0.05, 0.5, n).astype(np.float32)
    grid = jcm.CMGrid(n=4, cap=64)
    J = jnp.asarray
    lay = jcm.build_layout(grid, jb, J(x), J(y), J(z))
    pve = jpv.PallasVE(grid, cfg, interpret=True)

    def refresh(st):
        return jpv.make_ghost_refresh(grid, jb, st.shape[0],
                                      interpret=True)(st)

    def cm(a, fill=0.0):
        return jcm.to_cm(lay, J(a), fill)

    base = pve.base_rows(lay, J(x), J(y), J(z), J(h))
    m_cm, vx, vy, vz = cm(np.asarray(state.p.m)), cm(v[0]), cm(v[1]), cm(v[2])
    xm, hn, nc, _ = pve.xmass_h(base, m_cm)
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
    cij, divv, curlv, gradv = pve.iad_divv(base, kx, xm, vx, vy, vz)
    st = refresh(jnp.stack(list(cij) + [divv, curlv] + list(gradv)))
    cij = tuple(st[i] for i in range(6))
    gradv = tuple(st[8 + i] for i in range(6))
    eta = jnp.cbrt(32.0 * jnp.pi / 3.0 / jnp.maximum(nc + 1.0, 1.0))
    args = (list(base), vx, vy, vz, c, prho, rho, xm, cm(alpha), m_cm, cij)
    jout = pve.momentum(*args, gradv=gradv, eta_crit_cm=eta)
    mask = np.asarray(lay.valid & jcm.interior_mask(grid))
    return dict(args=args, gradv=gradv, eta=eta, jout=jout, mask=mask,
                cfg=cfg, grid=grid)


def _port_momentum(frame, cfg):
    g = frame["grid"]
    pve = tpv.PairVE(CMGrid(n=g.n, cap=g.cap), _tcfg(cfg))
    out = pve.momentum(*_to_torch(list(frame["args"])),
                       gradv=_to_torch(frame["gradv"]),
                       eta_crit_cm=_to_torch(frame["eta"]))
    return pve, [o.numpy() for o in out]


def test_k7c_momentum_matches_jax(frame):
    pve, tout = _port_momentum(frame, frame["cfg"])
    assert pve.kernels[-1].name == "pair_momentum_avclean"
    mask = frame["mask"]
    jout = [np.asarray(o) for o in frame["jout"]]
    for a, b in zip(jout[:4], tout[:4]):
        a, b = a[mask], b[mask]
        assert np.abs(b - a).max() <= 1e-4 * np.abs(a).max()
    np.testing.assert_allclose(tout[4][mask], jout[4][mask], rtol=1e-5)
    assert jout[4][mask].max() > 0


def test_avclean_correction_is_applied(frame):
    """The rv correction moves the momentum stage (K7c is not K7)."""
    _, clean = _port_momentum(frame, frame["cfg"])
    g = frame["grid"]
    plain = tpv.PairVE(CMGrid(n=g.n, cap=g.cap),
                       _tcfg(frame["cfg"].replace(av_clean=False)))
    off = [o.numpy() for o in plain.momentum(*_to_torch(list(frame["args"])))]
    mask = frame["mask"]
    assert np.abs(clean[3] - off[3])[mask].max() > 1e-3 * np.abs(
        off[3][mask]).max()


def test_mxu_momentum_with_av_clean_takes_the_direct_body(frame):
    cfg = frame["cfg"].replace(mxu_momentum=True)
    pve, both = _port_momentum(frame, cfg)
    assert pve.kernels[-1] is tpv.pair_momentum_avclean
    _, clean = _port_momentum(frame, frame["cfg"])
    for a, b in zip(clean, both):
        np.testing.assert_array_equal(b, a)


def test_avclean_refused_where_the_jax_package_refuses():
    cfg = SphConfig(av_clean=True)
    grid = CMGrid(n=2, cap=64)
    with pytest.raises(NotImplementedError):
        tpv.PairVE(grid, cfg, gated=True)
    box = box_from_numpy([-0.5, 0.5] * 3, [1, 1, 1])
    with pytest.raises(NotImplementedError):
        BdtVE(box, grid, cfg, device="cpu")
    with pytest.raises(ValueError):
        tpv.PairVE(grid, cfg).momentum([], *([None] * 9), ())


def test_config_roundtrip_of_the_body_options():
    for flags in (dict(mxu_moments=True), dict(mxu_momentum=True),
                  dict(mxu_bf16=True), dict(av_clean=True)):
        jc = JCfg(**flags)
        tc = config_from_dict(dataclasses.asdict(jc))
        for k in ("mxu_moments", "mxu_momentum", "mxu_bf16", "av_clean"):
            assert getattr(tc, k) == getattr(jc, k) == flags.get(k, False)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs():
    state, jb, cfg = j_init_sedov(10, JCfg(), dt0=2e-4)
    cfg = cfg.replace(av_clean=True)
    alive = np.asarray(state.p.alive)
    _, grid = choose_cap_and_grid(
        jb, float(state.p.h[0]) * 1.2, 1000,
        *(np.asarray(getattr(state.p, c))[alive] for c in "xyz"))
    host = ({f: np.asarray(getattr(state.p, f)) for f in _FIELDS},
            float(state.ttot), float(state.dt), float(state.dt_m1),
            int(state.iteration))
    jeng = JResidentVE(jb, grid, cfg, interpret=True)
    jr = jeng.bind(state)
    jd = []
    for i in range(N_STEPS):
        if i == FORCE_REBIN_AT:
            jr = jr.replace(drift=jnp.float32(1e9))
        jr, d = jeng.step(jr)
        jd.append({k: np.asarray(v) for k, v in d._asdict().items()})
    jout = jeng.unbind(jr, state.p.n)
    teng = ResidentVE(_tbox(jb), CMGrid(n=grid.n, cap=grid.cap), _tcfg(cfg),
                      device="cpu")
    ts = state_from_numpy(*host, device="cpu")
    tr = teng.bind(ts)
    td = []
    for i in range(N_STEPS):
        if i == FORCE_REBIN_AT:
            tr = tr.replace(drift=tr.drift.new_tensor(1e9))
        tr, d = teng.step(tr)
        td.append({k: np.asarray(v) for k, v in d._asdict().items()})
    tout = teng.unbind(tr, ts.p.n)
    return dict(jd=jd, td=td,
                jf={f: np.asarray(getattr(jout.p, f)) for f in _FIELDS},
                tf={f: getattr(tout.p, f).numpy() for f in _FIELDS})


@pytest.mark.parametrize("step", range(N_STEPS))
def test_engine_step_diagnostics(runs, step):
    a, b = runs["jd"][step], runs["td"][step]
    assert int(b["overflow"]) == int(a["overflow"]) == 0
    assert bool(b["rebinned"]) == bool(a["rebinned"])
    np.testing.assert_allclose(b["dt"], a["dt"], rtol=1e-5)
    np.testing.assert_allclose(b["eint"], a["eint"], rtol=1e-6)
    np.testing.assert_allclose(b["ecin"], a["ecin"], rtol=1e-3, atol=1e-12)
    np.testing.assert_allclose(b["h_max"], a["h_max"], rtol=1e-5)


def test_engine_unbound_fields(runs):
    a, b = runs["jf"], runs["tf"]
    np.testing.assert_array_equal(b["alive"], a["alive"])
    for f in ("x", "y", "z", "vx", "temp", "h", "alpha"):
        scale = max(np.abs(a[f]).max(), 1e-12)
        tol = 1e-4 if f == "alpha" else 2e-3
        assert np.abs(b[f] - a[f]).max() / scale < tol, f


def test_eta_crit_matches_jax():
    """eta_crit of the pipeline against the JAX pipeline's formula
    (ve_pallas.py:119), rtol 1e-6 (pow(x, 1/3) against cbrt)."""
    nc = np.array([0.0, 1.0, 7.0, 57.0, 100.0, 513.0], np.float32)
    want = np.asarray(jnp.cbrt(32.0 * jnp.pi / 3.0
                               / jnp.maximum(jnp.asarray(nc), 1.0)))
    np.testing.assert_allclose(eta_crit(torch.from_numpy(nc)).numpy(), want,
                               rtol=1e-6)
