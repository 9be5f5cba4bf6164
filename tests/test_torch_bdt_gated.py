"""The port's gated pair stages K2g against the JAX package's gated
PallasVE (Pallas in interpret mode), one stage at a time, on the inputs
of the ungated JAX pipeline. The engine over two rung cycles is in
tests/test_torch_bdt.py.

Grid CMGrid(n=4, cap=128): npz = 6, so the JAX gate unit (legal_zgroup)
is a z-supercell of Z = 6 cells, one per (x, y) column. The gated stage
tests run with zgroup 0 (Z = 6) and 1 (one cell), so the gate unit
itself is tested: in a mixed column the inactive cells are recomputed
with Z = 6 and keep their previous outputs with Z = 1.

Tolerances, and why: those of tests/test_torch_pair_ve.py on the slots
of active supercells (nc, nonconv exact; h, xm, kx, gradh, alpha,
maxvsignal rtol 1e-5; cancelling sums 1e-4 of the row's scale); interior
slots of inactive supercells bit-equal to prev.
The JAX inputs are computed once per module.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.init.sedov import init_sedov as j_init_sedov
from sphexa_tpu.ops import cellmajor as jcm
from sphexa_tpu.ops import pallas_ve as jpv
from sphexa_tpu.sph.eos import eos_ve as j_eos_ve
from sphexa_tpu_torch.ops import pair_ve as tpv

from test_torch_bdt import GRID, _tcfg, _tgrid
from torch_threads import one_torch_thread  # noqa: F401


def _to_torch(a):
    if isinstance(a, (list, tuple)):
        return type(a)(_to_torch(v) for v in a)
    return torch.from_numpy(np.array(np.asarray(a)))


def _supercell_slots(act, grid, Z):
    """Per slot: its z-supercell holds an active slot (numpy)."""
    sc = act.reshape(grid.npx, grid.np_, grid.npz // Z, Z * grid.cap)
    on = (sc > 0.5).any(-1)
    return np.repeat(np.repeat(on, Z, axis=2).reshape(-1), grid.cap)


# ---------------------------------------------------------------------------
# gated stages (K2g)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gframe():
    """Ungated JAX pipeline inputs of a perturbed Sedov 10^3 frame, an
    activity pattern with wholly active, wholly inactive and mixed
    columns, and seeded prev rows."""
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
    grid = GRID

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
    args = {"xmass_h": (list(base), m_cm)}
    xm, hn, _, _ = pve.xmass_h(base, m_cm)
    st = refresh(jnp.stack([xm, hn]))
    xm, hn = st[0], st[1]
    base = [base[0], base[1], base[2], hn, base[4]]
    args["gradh"] = (list(base), m_cm, xm)
    st = refresh(jnp.stack(pve.gradh(base, m_cm, xm)))
    kx, gradh = st[0], st[1]
    rho, _, c, prho = j_eos_ve(cm(temp), m_cm, kx, xm, gradh, cfg.mui,
                               cfg.gamma)
    va = base[0] < 0.5 * jpv.FILL_POS
    rho, c = jnp.where(va, rho, 1.0), jnp.where(va, c, 1.0)
    prho = jnp.where(va, prho, 0.0)
    args["iad_divv"] = (list(base), kx, xm, vx, vy, vz)
    cij, divv, curlv, _ = pve.iad_divv(base, kx, xm, vx, vy, vz)
    st = refresh(jnp.stack(list(cij) + [divv, curlv]))
    cij, divv = tuple(st[i] for i in range(6)), st[6]
    alpha_cm = cm(alpha)
    args["av_switches"] = (list(base), c, kx, xm, divv, vx, vy, vz, cij,
                           alpha_cm, jnp.float32(1.3e-5))
    args["momentum"] = (list(base), vx, vy, vz, c, prho, rho, xm, alpha_cm,
                        m_cm, cij)

    # activity: per interior column one of active / inactive / mixed
    # (one slot of one z-cell active); only valid interior slots count
    validint = np.asarray(lay.valid & jcm.interior_mask(grid))
    act = np.zeros(grid.n_slots, np.float32)
    shape = (grid.npx, grid.np_, grid.npz, grid.cap)
    av = act.reshape(shape)
    vi = validint.reshape(shape)
    kinds = {}
    for cx in range(1, grid.nx + 1):
        for cy in range(1, grid.n + 1):
            kind = ("active", "inactive", "mixed")[(cx + 2 * cy) % 3]
            kinds[cx, cy] = kind
            if kind == "active":
                av[cx, cy] = vi[cx, cy]
            elif kind == "mixed":
                cz = 1 + (cx + cy) % grid.nz
                lane = int(np.flatnonzero(vi[cx, cy, cz])[0])
                av[cx, cy, cz, lane] = 1.0
    assert set(kinds.values()) == {"active", "inactive", "mixed"}
    interior = np.asarray(jcm.interior_mask(grid))
    tpve_cfg = _tcfg(cfg)
    return dict(args=args, act=act, validint=validint, interior=interior,
                cfg=cfg, tcfg=tpve_cfg)


STAGES = {   # method: the check of each output row (fo rows)
    "xmass_h": ("rel", "rel", "exact", "exact"),
    "gradh": ("rel", "rel"),
    "iad_divv": ("scaled",) * 14,
    "av_switches": ("rel",),
    "momentum": ("scaled",) * 4 + ("rel",),
}


def _flat(out):
    """Stage method outputs as a list of rows (iad returns tuples)."""
    rows = []
    for o in out if isinstance(out, tuple) else (out,):
        rows += list(o) if isinstance(o, tuple) else [o]
    return [np.asarray(r) for r in rows]


@pytest.mark.parametrize("zgroup", [0, 1], ids=["Z6", "Z1"])
@pytest.mark.parametrize("method", sorted(STAGES))
def test_gated_stage_matches_jax(gframe, method, zgroup):
    checks = STAGES[method]
    fo = len(checks)
    grid = GRID
    act = gframe["act"]
    prev = np.random.default_rng(11).normal(
        0, 1, (fo, grid.n_slots)).astype(np.float32)
    jpve = jpv.PallasVE(grid, gframe["cfg"], interpret=True, gated=True,
                        zgroup=zgroup)
    args = gframe["args"][method]
    jout = _flat(getattr(jpve, method)(
        *args, gate=(jnp.asarray(act), [jnp.asarray(p) for p in prev])))
    tpve = tpv.PairVE(_tgrid(grid), gframe["tcfg"], gated=True,
                      zgroup=zgroup)
    Z = tpve.zgroup
    assert Z == (6 if zgroup == 0 else 1)
    tout = _flat(getattr(tpve, method)(
        *_to_torch(list(args)),
        gate=(torch.from_numpy(act), list(torch.from_numpy(prev)))))
    assert len(tout) == len(jout) == fo

    on = _supercell_slots(act, grid, Z)
    keep = gframe["interior"] & ~on
    live = gframe["validint"] & on
    assert keep.any() and live.any()
    # an occupied cell left inactive inside an active supercell exists
    # exactly when Z > 1: the gate unit shows in the outputs
    cell_act = (act.reshape(-1, grid.cap) > 0.5).any(1)
    cell_occ = gframe["validint"].reshape(-1, grid.cap).any(1)
    on_cell = on.reshape(-1, grid.cap)[:, 0]
    assert ((on_cell & ~cell_act & cell_occ).any()) == (Z > 1)
    for r, (a, b, kind) in enumerate(zip(jout, tout, checks)):
        np.testing.assert_array_equal(b[keep], prev[r][keep], err_msg=r)
        np.testing.assert_array_equal(a[keep], prev[r][keep], err_msg=r)
        a, b = a[live], b[live]
        if kind == "exact":
            np.testing.assert_array_equal(b, a, err_msg=r)
        elif kind == "rel":
            np.testing.assert_allclose(b, a, rtol=1e-5, err_msg=r)
        else:
            scale = max(np.abs(a).max(), 1e-30)
            assert np.abs(b - a).max() <= 1e-4 * scale, (r, scale)


def test_gated_stage_needs_gate(gframe):
    """A gated stage refuses a call without gate=, an ungated one a call
    with it; a zgroup that does not divide npz is refused."""
    tg = _tgrid(GRID)
    J = torch.zeros((tpv.NBASE + 1, tg.n_slots))
    with pytest.raises(ValueError):
        tpv.pair_xh_gated(J, None, tg, gframe["tcfg"])
    gate = (torch.zeros(tg.n_slots), torch.zeros((4, tg.n_slots)))
    with pytest.raises(ValueError):
        tpv.pair_xh(J, None, tg, gframe["tcfg"], gate)
    with pytest.raises(ValueError):
        tpv.PairVE(tg, gframe["tcfg"], gated=True, zgroup=4)
