"""The walk schedule of the K3 kernel (csrc/cell_pair.cu, xh::xh_cell),
emulated in torch, against the JAX package's _xh_body (PallasVE in
interpret mode) and against the port's plain version pair_xh.plain.

The kernel computes a slot's neighbour count and xmass sum together, in
one walk over its candidates at its current h, and walks again only
after a controller round that changed the bits of its h; its final
count and sum are those of its last walk. The candidates are the
occupied 32-slot groups of the 27 neighbour cells packed into one run,
in neighbour-then-slot order, and the xmass sum adds the in-support
terms in that order. An invalid i-slot walks nothing: every invalid
slot sits at FILL_POS, so it counts the invalid slots of its 27 cells
at any h. `xh_schedule` below follows that schedule with the plain
version's float32 expressions, so it differs from pair_xh.plain only in
what the schedule changes: the order of the xmass sum.

Inputs: Sedov 10^3 with seeded jitter of positions (4e-3) and h (5%),
on CMGrid(n=2, cap=256) (about 125 particles a cell, so the run holds
four of each cell's eight slot groups), under h_iter 2 (the default),
3, and 3 with h capped at about the median h. Tolerances, and why:

  - nc, nonconv: exact against the JAX package on the valid interior
    slots (the same float32 operations).
  - h, xm: rtol 1e-5 against the JAX package, as in
    tests/test_torch_pair_ve.py: jnp.power and torch.pow differ in the
    last place on some inputs (one slot here), and the xmass sum's order
    differs (the run's k order here, nine z-run windows in the Pallas
    body).
  - nc, nonconv, h: exact against the plain version on every interior
    slot (the same torch operations; the invalid slots' count is the
    kernel's rule, here held against the walk over all 27 * cap
    candidates that the plain version makes); xm rtol 1e-5 (pairwise
    summation in torch).
  - walks: exact. One a valid interior slot, one more a round that moved
    its h (read off the plain version run with 1..h_iter rounds); none
    on invalid slots.
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
from sphexa_tpu_torch.interop import config_from_dict
from sphexa_tpu_torch.ops import pair_ve as tpv
from sphexa_tpu_torch.ops.cellmajor import CMGrid, _interior_cells_np
from sphexa_tpu_torch.sph.kernels import kernel_3d_k
from sphexa_tpu_torch.util.fp import rdiv
from torch_threads import one_torch_thread  # noqa: F401

GRID = dict(n=2, cap=256)
CASES = {"it2": dict(), "it3": dict(h_iter=3),
         "it3_hcap": dict(h_iter=3, h_cap=0.145)}
CELLS_AT_ONCE = 16


def xh_schedule(J, grid, cfg):
    """K3's schedule in torch. Returns ([xm, h, nc, nonconv] rows, zero
    outside the interior cells, and the walks each slot ran)."""
    cap, G = grid.cap, grid.cap // 32
    n_w = int(cfg.sinc_index)
    K3d = kernel_3d_k(cfg.sinc_index)
    ngmin, ngmax = float(cfg.ng0 // 4), float(cfg.ngmax)
    valid = J[tpv.RX] < 0.5 * tpv.FILL_POS
    out = torch.zeros((4, grid.n_slots), dtype=torch.float32)
    walks = torch.zeros(grid.n_slots, dtype=torch.int64)
    cells = torch.tensor(tpv.interior_cells(grid))
    offs = torch.tensor(tpv._nbr_offsets(grid))
    lane = torch.arange(cap)
    for c0 in range(0, len(cells), CELLS_AT_ONCE):
        cc = cells[c0:c0 + CELLS_AT_ONCE]
        C = len(cc)
        # the 27 cells' 32-slot groups in nb-then-slot order; the run
        # packs the occupied ones, in order, padded by dead entries
        groups = ((cc[:, None] + offs)[:, :, None] * cap + lane).view(
            C, 27 * G, 32)
        occ = valid[groups].any(-1)
        nrun = 32 * int(occ.sum(1).max())
        order = torch.argsort((~occ).to(torch.int8), dim=1, stable=True)
        run = groups.gather(1, order[..., None].expand(-1, -1, 32)).view(
            C, 1, -1)[..., :nrun]
        live = (torch.arange(nrun) < 32 * occ.sum(1)[:, None])[:, None]
        ninv = (27 * cap - valid[groups].sum((1, 2))).float()[:, None]

        own = cc[:, None] * cap + lane                        # [C, cap]
        ok = valid[own]
        rx, ry, rz = (J[r][own][..., None] - J[r][run]
                      for r in (tpv.RX, tpv.RY, tpv.RZ))
        d2 = rx * rx + ry * ry + rz * rz                      # [C, cap, R]
        mj = J[tpv.NBASE][run]

        nc_last = ninv.expand(C, cap).clone()
        acc_last = torch.zeros((C, cap))
        nwalk = torch.zeros((C, cap), dtype=torch.int64)
        stale = ok.clone()

        def walk(hinv):
            v2 = d2 * (hinv * hinv)[..., None]
            inside = live & (v2 < 4.0)
            w = tpv._w_v2(v2, n_w) * mj
            acc = torch.zeros((C, cap))
            for k in range(v2.shape[-1]):         # the run's k order
                acc = torch.where(inside[..., k], acc + w[..., k], acc)
            nc = inside.sum(-1).float()
            nc_last[stale] = nc[stale]
            acc_last[stale] = acc[stale]
            nwalk[stale] += 1
            stale[:] = False

        hi = J[tpv.RH][own]
        hinv = 1.0 / hi
        walk(hinv)
        nc_sph = nc_last.clone()
        for it in range(cfg.h_iter):
            need = (nc_sph < ngmin) | (nc_sph - 1.0 > ngmax)
            h_new = hi * 0.5 * torch.pow(
                1.0 + rdiv(1023.0 * float(cfg.ng0),
                           torch.clamp_min(nc_sph, 1.0)), 0.1)
            if cfg.h_cap > 0.0:
                h_new = torch.clamp_max(h_new, float(np.float32(cfg.h_cap)))
            h_old = hi
            hi = torch.where(need, h_new, hi)
            hinv = 1.0 / hi
            stale |= ok & (hi.view(torch.int32) != h_old.view(torch.int32))
            if it < cfg.h_iter - 1:
                walk(hinv)
                nc_sph = nc_last.clone()
        walk(hinv)
        nc = nc_last - 1.0
        xm = J[tpv.NBASE][own] * (hi * hi * hi) / (K3d * acc_last)
        nonconv = ((nc + 1.0 < ngmin) | (nc > ngmax)).float()
        rows = (torch.where(ok, xm, 1.0), hi, torch.where(ok, nc, 0.0),
                torch.where(ok, nonconv, 0.0))
        for r, v in enumerate(rows):
            out[r, own.reshape(-1)] = v.reshape(-1)
        walks[own.reshape(-1)] = nwalk.reshape(-1)
    return out, walks


@pytest.fixture(scope="module")
def frame():
    """The JAX layout's base rows and m of the jittered Sedov 10^3 frame
    (numpy), the grid, the port's config and the masks."""
    state, jb, cfg = j_init_sedov(10, JCfg(), dt0=1e-5)
    n = 1000
    r = np.random.default_rng(0)
    h0 = float(state.p.h[0])
    x, y, z = (np.asarray(getattr(state.p, c))
               + r.normal(0, 0.004, n).astype(np.float32) for c in "xyz")
    h = (h0 * (1.0 + 0.05 * r.normal(0, 1, n))).astype(np.float32)
    grid = jcm.CMGrid(**GRID)
    lay = jcm.build_layout(grid, jb, jnp.asarray(x), jnp.asarray(y),
                           jnp.asarray(z))
    base = jpv.PallasVE(grid, cfg, interpret=True).base_rows(
        lay, jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), jnp.asarray(h))
    m_cm = jcm.to_cm(lay, jnp.asarray(state.p.m), 0.0)
    J = np.stack([np.asarray(b) for b in base] + [np.asarray(m_cm)])
    inside = np.repeat(_interior_cells_np(CMGrid(**GRID)), GRID["cap"])
    valid = np.asarray(lay.valid) & inside
    return dict(J=J, jbase=base, jm=m_cm, jcfg=cfg, inside=inside,
                valid=valid, cfg=config_from_dict(dataclasses.asdict(cfg)),
                cache={})


def _run(frame, case):
    """(JAX outputs, schedule outputs and walks, plain outputs) of one
    case, each computed once."""
    if case not in frame["cache"]:
        jcfg = dataclasses.replace(frame["jcfg"], **CASES[case])
        jout = jpv.PallasVE(jcm.CMGrid(**GRID), jcfg,
                            interpret=True).xmass_h(frame["jbase"],
                                                    frame["jm"])
        cfg = frame["cfg"].replace(**CASES[case])
        J = torch.from_numpy(frame["J"])
        sched, walks = xh_schedule(J, CMGrid(**GRID), cfg)
        plain = tpv.pair_xh.plain(J, None, CMGrid(**GRID), cfg)
        frame["cache"][case] = (np.stack([np.asarray(o) for o in jout]),
                                sched.numpy(), walks.numpy(), plain, cfg)
    return frame["cache"][case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_matches_jax(frame, case):
    jout, sched, _, _, _ = _run(frame, case)
    v = frame["valid"]
    for r in (2, 3):                             # nc, nonconv
        np.testing.assert_array_equal(sched[r, v], jout[r, v])
    for r in (0, 1):                             # xm, h
        np.testing.assert_allclose(sched[r, v], jout[r, v], rtol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_matches_plain(frame, case):
    _, sched, _, plain, _ = _run(frame, case)
    plain = plain.numpy()
    inside, v = frame["inside"], frame["valid"]
    np.testing.assert_array_equal(sched[1:, inside], plain[1:, inside])
    np.testing.assert_array_equal(sched[0, inside & ~v],
                                  plain[0, inside & ~v])
    np.testing.assert_allclose(sched[0, v], plain[0, v], rtol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_walks(frame, case):
    """One walk a valid interior slot and one more a round that moved
    its h; the inputs hold slots whose h moves and slots whose h holds,
    and the schedule skips the walks of the latter."""
    _, _, walks, _, cfg = _run(frame, case)
    J = torch.from_numpy(frame["J"])
    hs = [J[tpv.RH]] + [
        tpv.pair_xh.plain(J, None, CMGrid(**GRID), cfg.replace(h_iter=t))[1]
        for t in range(1, cfg.h_iter + 1)]
    rounds = sum((a != b).long() for a, b in zip(hs, hs[1:])).numpy()
    v = frame["valid"]
    np.testing.assert_array_equal(walks[v], 1 + rounds[v])
    assert not walks[~v].any()
    assert (rounds[v] == 0).any() and (rounds[v] > 0).any()
    assert walks[v].sum() < (1 + cfg.h_iter) * v.sum()


def test_schedule_walks_once_when_h_holds(frame):
    """With every count inside [ng0/4, ngmax] no h moves (as on the
    Sedov 100^3 main path): one walk a slot, and the outputs equal the
    plain version's (which counts 1 + h_iter times)."""
    cfg = frame["cfg"].replace(ng0=4, ngmax=10 ** 6, h_iter=3)
    J = torch.from_numpy(frame["J"])
    sched, walks = xh_schedule(J, CMGrid(**GRID), cfg)
    plain = tpv.pair_xh.plain(J, None, CMGrid(**GRID), cfg)
    inside, v = frame["inside"], frame["valid"]
    assert (walks.numpy()[v] == 1).all() and not walks.numpy()[~v].any()
    assert torch.equal(sched[1:, inside], plain[1:, inside])
    np.testing.assert_allclose(sched[0, v], plain[0, v], rtol=1e-5)
