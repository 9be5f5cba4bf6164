"""The schedules of the K10 and K8 kernels (csrc/cell_pair.cu), emulated
in torch, against the JAX package's _momentum_mm_body and
_iad_hybrid_body (PallasVE in interpret mode, jitted once a frame and
configuration) and against the port's plain versions. This file holds
the emulations, the checks and the cap-64 frame's cases; the cap-128
frame's are in tests/test_torch_mm_schedule_cap128.py, so that a run
spread over workers by file spreads the JAX work too.

K10 (mm::mm_cell) contracts the five pair-weight families with the 49
moment columns on the tensor cores. Its i-slots are cut into 16-row
i-tiles; its j-slots are the occupied 32-slot groups of the 27
neighbour cells in neighbour-then-slot order, cut into k-steps of 8
(float32) or 16 (mxu_bf16) slots. For each (i-tile, k-step, family)
block whose weights are not all zero, float32 adds, in k-step order,
the sum of the three TF32 products of the 3xTF32 split (a = a_hi +
a_lo, each part rounded to TF32 nearest-away, as cvt.rna.tf32.f32:
a_lo b_hi, a_hi b_lo, a_hi b_hi, in that order, m16n8k8, from zero),
and mxu_bf16 the one product of the bf16-rounded operands (m16n8k16,
into the sums); an all-zero block is skipped.
`k10_schedule` below runs the plain body on the packed run of occupied
groups with its contraction replaced by that schedule; the blocks it
skips are chip_smoke.py's mm_nonzero_blocks, the helper whose count
(mm_block_counts) the card's count is held to.

K8 (tile::IadMmStage) walks the same occupied groups, and each lane adds
its in-support pairs one at a time in run order: the six tau sums and
the 16 moment sums w_ij * column_k(j). `k8_schedule` runs the plain body
on the packed run with its sums and its contraction taken one pair at a
time in that order.

Frames: tests/test_torch_mm.py's, the JAX direct pipeline's inputs of a
perturbed Sedov state: Sedov 12^3 on CMGrid(n=4, cap=64) and Sedov 10^3
on CMGrid(n=4, cap=128). Compared on interior valid slots, with
tests/test_torch_mm.py's tolerances:

  - K10 float32: ax, ay, az and du within 1e-4 of their row's scale
    (centred moment sums cancel), maxvsignal rtol 1e-5 (a max of
    per-pair terms), against JAX and against the plain version.
  - K10 mxu_bf16: against JAX's bf16 at 5e-4 of the row's scale; against
    the plain version as tests/test_torch_cuda.py's _check_bf16 (within
    a quarter of the plain version's own bf16-to-float32 distance, and
    at least half that distance from float32); maxvsignal rtol 1e-5.
  - K8: its 14 rows within 1e-4 of their row's scale, against JAX and
    against the plain version.
"""

import functools
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_mm as tmm
from sphexa_tpu.ops import cellmajor as jcm
from sphexa_tpu.ops import pallas_ve as jpv
from sphexa_tpu_torch.ops import pair_ve as tpv
from torch_threads import one_torch_thread  # noqa: F401

CELLS_AT_ONCE = 16
STEPS_AT_ONCE = 64          # k-steps whose products are formed at once
UNIT = 32                   # j-slots a staged group
# configuration: (PallasVE method, flags)
CONFIGS = {"k10": ("momentum", tmm.MM),
           "k10_bf16": ("momentum", dict(tmm.MM, mxu_bf16=True)),
           "k8": ("iad_divv", tmm.MM)}


def tf32_rna(x):
    """x rounded to TF32 (10 mantissa bits), nearest with ties away from
    zero, as cvt.rna.tf32.f32: add half a TF32 ulp to the magnitude's
    bits and clear the 13 low bits."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _occupied_run(J, grid, cc):
    """The occupied 32-slot groups of the 27 neighbour cells of cells cc
    in neighbour-then-slot order, each cell's run padded to the longest
    with unoccupied groups (every slot invalid: zero weights)."""
    cap = grid.cap
    valid = J[tpv.RX] < 0.5 * tpv.FILL_POS
    offs = torch.tensor(tpv._nbr_offsets(grid))
    lane = torch.arange(cap)
    C = cc.shape[0]
    groups = ((cc[:, None] + offs)[:, :, None] * cap + lane).view(
        C, 27 * cap // UNIT, UNIT)
    occ = valid[groups].any(-1)
    order = torch.argsort((~occ).to(torch.int8), dim=1, stable=True)
    nrun = UNIT * int(occ.sum(1).max())
    return groups.gather(1, order[..., None].expand(-1, -1, UNIT)).view(
        C, -1)[:, :nrun]


def _schedule(k, J, grid, cfg, patches):
    """k's plain body over the occupied runs of every interior cell, with
    the module functions in `patches` replaced."""
    cap = grid.cap
    out = torch.zeros((k.fo, grid.n_slots), dtype=torch.float32)
    cells = torch.tensor(tpv.interior_cells(grid))
    lane = torch.arange(cap)
    for c0 in range(0, len(cells), CELLS_AT_ONCE):
        cc = cells[c0:c0 + CELLS_AT_ONCE]
        C = cc.shape[0]
        run = _occupied_run(J, grid, cc)
        own = cc[:, None] * cap + lane
        I = J[:, own].reshape(J.shape[0], C, cap, 1)
        Jn = J[:, run].reshape(J.shape[0], C, 1, run.shape[1])
        with mock.patch.multiple(tpv, **patches):
            res = k.body(I, Jn, None, **k._body_kw(cfg))
        for r, v in enumerate(res):
            out[r, own.reshape(-1)] = v.reshape(-1)
    return out


def k10_schedule(J, grid, cfg):
    """K10's outputs under the kernel's block schedule."""
    ks = 16 if cfg.mxu_bf16 else 8

    def contract(w, cols):
        C, R, W = w.shape
        M = torch.cat(cols, dim=1)                           # [C, K, W]
        A = w.view(C, R // 16, 16, W // ks, ks)
        B = M.view(C, M.shape[1], W // ks, ks)
        nz = chip_smoke.mm_nonzero_blocks(w, ks)             # [C, it, step]

        def mma(a, b):                     # [C, it, 16, step, K]
            return torch.einsum("citsk,cnsk->citsn", a, b)
        if not cfg.mxu_bf16:
            a_hi = tf32_rna(A)
            a_lo = tf32_rna(A - a_hi)
            b_hi = tf32_rna(B)
            b_lo = tf32_rna(B - b_hi)
        acc = torch.zeros((C, R // 16, 16, M.shape[1]))
        for s0 in range(0, W // ks, STEPS_AT_ONCE):
            sl = slice(s0, s0 + STEPS_AT_ONCE)
            if cfg.mxu_bf16:
                terms = [mma(A[:, :, :, sl], B[:, :, sl])]
            else:
                terms = [mma(a_lo[:, :, :, sl], b_hi[:, :, sl]),
                         mma(a_hi[:, :, :, sl], b_lo[:, :, sl]),
                         mma(a_hi[:, :, :, sl], b_hi[:, :, sl])]
            for s in range(terms[0].shape[3]):
                on = nz[:, :, s0 + s, None, None]
                blk = terms[0][:, :, :, s]
                for t in terms[1:]:
                    blk = blk + t[:, :, :, s]
                acc = torch.where(on, acc + blk, acc)
        return acc.view(C, R, M.shape[1])

    return _schedule(tpv.pair_momentum_mm, J, grid, cfg,
                     {"_contract": contract})


def k8_schedule(J, grid, cfg):
    """K8's outputs with each lane's sums taken one pair at a time in
    run order."""
    def seq_sum(t):
        acc = torch.zeros_like(t[..., :1])
        for j in range(t.shape[-1]):
            acc = acc + t[..., j:j + 1]
        return acc

    def seq_contract(w, cols):
        M = torch.cat(cols, dim=1)                           # [C, 16, W]
        acc = torch.zeros((w.shape[0], w.shape[1], M.shape[1]))
        for j in range(w.shape[2]):
            acc = acc + w[:, :, j:j + 1] * M[:, None, :, j]
        return acc

    return _schedule(tpv.pair_iad_mm, J, grid, cfg,
                     {"_sum": seq_sum, "_contract": seq_contract})


@functools.lru_cache(maxsize=None)
def _frame(frame):
    return tmm._frame(*tmm.FRAMES[frame])


def jax_rows(frame, key):
    """The JAX rows of configuration key on the frame (interpret mode,
    jitted)."""
    fr = _frame(frame)
    method, flags = CONFIGS[key]
    jpve = jpv.PallasVE(tmm.FRAMES[frame][1], fr["cfg"].replace(**flags),
                        interpret=True)
    return tmm._flat(jax.jit(getattr(jpve, method))(*fr["args"][method]))


@functools.lru_cache(maxsize=None)
def port_rows(frame, key):
    """The port's plain rows of configuration key on the frame, with the
    J rows its kernel was given, its config, grid and the interior valid
    mask."""
    fr = _frame(frame)
    method, flags = CONFIGS[key]
    cfg = fr["cfg"].replace(**flags)
    kern = tpv.pair_momentum_mm if method == "momentum" else tpv.pair_iad_mm
    rec = {}

    def plain(J, I2, g, c, orig=kern.plain):
        rec["J"] = J
        return orig(J, I2, g, c)
    tpve = tpv.PairVE(tmm._tgrid(tmm.FRAMES[frame][1]), tmm._tcfg(cfg))
    with mock.patch.object(kern, "plain", plain):
        out = tmm._flat(getattr(tpve, method)(
            *tmm._to_torch(list(fr["args"][method]))))
    return dict(plain=out, J=rec["J"], cfg=tmm._tcfg(cfg),
                grid=tmm._tgrid(tmm.FRAMES[frame][1]), mask=fr["validint"])


def scaled(a, b, mask, tol):
    a, b = np.asarray(a)[mask], np.asarray(b)[mask]
    scale = max(np.abs(a).max(), 1e-30)
    assert np.abs(b - a).max() <= tol * scale, (np.abs(b - a).max(), scale)


def check_block_counts(f):
    """chip_smoke.py's count of K10's issued blocks on these inputs (the
    prediction the card's count is held to): some, and fewer than it
    stages."""
    issued, staged, dense = chip_smoke.mm_block_counts(
        f["J"], f["grid"], f["cfg"])
    assert 0 < issued < staged <= dense


def check_k10_float32(frame):
    """3xTF32 blocks, all-zero blocks skipped: ax, ay, az, du at 1e-4 of
    scale and maxvsignal rtol 1e-5 against JAX and plain; the blocks the
    card issues are fewer than it stages."""
    f = port_rows(frame, "k10")
    mask = f["mask"]
    out = k10_schedule(f["J"], f["grid"], f["cfg"]).numpy()
    for ref in (jax_rows(frame, "k10"), f["plain"]):
        for r in range(4):
            scaled(ref[r], out[r], mask, 1e-4)
        np.testing.assert_allclose(out[4][mask], np.asarray(ref[4])[mask],
                                   rtol=1e-5)
    check_block_counts(f)


def check_k10_bf16(frame):
    """bf16 blocks (m16n8k16), all-zero blocks skipped: against JAX's
    bf16 at 5e-4 of scale, against plain as _check_bf16; the blocks the
    card issues are fewer than it stages."""
    f, f32 = port_rows(frame, "k10_bf16"), port_rows(frame, "k10")
    mask = f["mask"]
    jout = jax_rows(frame, "k10_bf16")
    out = k10_schedule(f["J"], f["grid"], f["cfg"]).numpy()
    out = out.astype(np.float64)
    for r in range(4):
        scaled(jout[r], out[r], mask, 5e-4)
        ref_b = np.asarray(f["plain"][r], np.float64)[mask]
        ref_f = np.asarray(f32["plain"][r], np.float64)[mask]
        scale = np.abs(ref_f).max()
        d_ref = np.abs(ref_b - ref_f).max() / scale
        assert np.abs(out[r][mask] - ref_b).max() / scale <= 0.25 * d_ref
        assert np.abs(out[r][mask] - ref_f).max() / scale >= 0.5 * d_ref
    for ref in (jout, f["plain"]):
        np.testing.assert_allclose(out[4][mask], np.asarray(ref[4])[mask],
                                   rtol=1e-5)
    check_block_counts(f)


def check_k8(frame):
    """Per-lane sums in run order: the 14 rows at 1e-4 of scale against
    JAX and plain; invalid interior slots exactly zero."""
    f = port_rows(frame, "k8")
    mask = f["mask"]
    out = k8_schedule(f["J"], f["grid"], f["cfg"]).numpy()
    assert out.shape[0] == 14
    for ref in (jax_rows(frame, "k8"), f["plain"]):
        for r in range(14):
            scaled(ref[r], out[r], mask, 1e-4)
    empty = np.asarray(jcm.interior_mask(tmm.FRAMES[frame][1])) & ~mask
    assert empty.any() and (out[:, empty] == 0).all()


@pytest.mark.parametrize("frame", ["cap64"])
def test_k10_schedule_float32(frame):
    """check_k10_float32 on the cap-64 frame."""
    check_k10_float32(frame)


@pytest.mark.parametrize("frame", ["cap64"])
def test_k10_schedule_bf16(frame):
    """check_k10_bf16 on the cap-64 frame."""
    check_k10_bf16(frame)


@pytest.mark.parametrize("frame", ["cap64"])
def test_k8_schedule(frame):
    """check_k8 on the cap-64 frame."""
    check_k8(frame)


def test_tf32_rna_ties_away():
    """The TF32 rounding of the emulation: nearest, ties away from zero,
    exact on TF32 values."""
    one = 1.0 + 2.0 ** -10                      # a TF32 value
    x = torch.tensor([one, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -11],
                     dtype=torch.float32)
    want = [one, one, -one, 1.0, 1.0 + 2.0 ** -9]
    assert tf32_rna(x).tolist() == want
