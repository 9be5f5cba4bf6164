"""P5: in-kernel matrix-product cost against precision
(scripts/mxu_micro.py).

make(mode, vpu_flops) is the script's function of x [FJ, RUNW]: per
program, 9 dots [CAP, RUNW] x [RUNW, K] of w_g = (x[0, :] + row) * (1 +
g), after vpu_flops elementwise steps w * 1.000001 + 0.5, with M2 =
x[:K, :RUNW]^T, summed into acc [CAP, K]; out [CAP, RUNW] holds acc and
zeros. Modes: "none" (acc += w[:, :K], no product), "f32", "f32_highest",
"bf16" (operands rounded to bf16, float32 sums). Every one of NCELL
programs computes the same block.

On the card (csrc/probes.cu, mma_micro_kernel) a block per program runs
the dots with mma.sync: "f32" as TF32 (what a float32 product gives at
TF32 precision), "f32_highest" as 3xTF32, "bf16" as bf16. The plain
version takes float32 products (bf16-rounded operands under "bf16").
The sweep prints ms and cycles per cell at the card's maximum SM clock,
card-wide and per SM.

    python -m sphexa_tpu_torch.probes.mma_micro
"""

from __future__ import annotations

import sys

import torch

from sphexa_tpu_torch.ops import _cuda
from sphexa_tpu_torch.probes import Probe, card, cuda_ms, need_cuda, smi

CAP = 64
RUNW = 3 * CAP
K = 16
NCELL = 17576       # the interior cells of Sedov 100^3 at cap 64
FJ = 16
MODES = ("none", "f32", "f32_highest", "bf16")
VPU_FLOPS = (0, 30)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _plain(x, mode: str, vpu_flops: int, ncell: int):
    rows = torch.arange(CAP, dtype=torch.float32, device=x.device)[:, None]
    v = x[0:1, :RUNW] + rows
    m2 = x[0:K, 0:RUNW].T
    acc = torch.zeros((CAP, K), dtype=torch.float32, device=x.device)
    for g in range(9):
        w = v * (1.0 + g)
        for _ in range(vpu_flops):
            w = w * 1.000001 + 0.5
        if mode == "none":
            acc = acc + w[:, 0:K]
        elif mode == "bf16":
            acc = acc + _bf16(w) @ _bf16(m2)
        else:
            acc = acc + w @ m2
    out = torch.zeros((CAP, RUNW), dtype=torch.float32, device=x.device)
    out[:, :K] = acc
    return out


def _launch(x, mode: str, vpu_flops: int, ncell: int):
    out = torch.zeros((CAP, RUNW), dtype=torch.float32, device=x.device)
    _cuda.mma_micro_launch(MODES.index(mode), x, out, ncell, vpu_flops)
    return out


mma_cells = Probe("mma_cells", _plain, _launch)


def make(mode: str, vpu_flops: int):
    """f(x) -> out [CAP, RUNW], x a contiguous float32 [FJ, RUNW]."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")

    def f(x):
        if x.shape != (FJ, RUNW) or x.dtype != torch.float32 \
                or not x.is_contiguous():
            raise ValueError(f"expects a contiguous float32 [{FJ}, {RUNW}]")
        return mma_cells(x, mode, vpu_flops, NCELL)
    return f


def dot_flops(ncell: int = NCELL) -> int:
    """Flops of the 9 dots of every cell (multiply-add = 2)."""
    return ncell * 9 * 2 * CAP * RUNW * K


def vpu_ops(vpu_flops: int, ncell: int = NCELL) -> int:
    """fp32 operations of the elementwise w (v, the scale, 2 a step)."""
    return ncell * 9 * CAP * RUNW * (2 + 2 * vpu_flops)


def sweep(reps: int = 10, device="cuda"):
    """Each mode and vpu_flops on the card: [{mode, vpu_flops, ms,
    card_cycles_per_cell, sm_cycles_per_cell}] at the maximum SM clock."""
    x = torch.ones((FJ, RUNW), dtype=torch.float32, device=device)
    mhz = float(smi("clocks.max.sm"))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for vf in VPU_FLOPS:
        for mode in MODES:
            f = make(mode, vf)
            ms = cuda_ms(lambda: f(x), reps)
            cyc = ms * 1e-3 * mhz * 1e6 / NCELL
            rows.append(dict(mode=mode, vpu_flops=vf, ms=ms, sm_mhz=mhz,
                             card_cycles_per_cell=cyc,
                             sm_cycles_per_cell=cyc * n_sm))
    return rows


def main() -> int:
    need_cuda()
    print(card())
    for r in sweep():
        print(f"{r['mode']:12s} vpu={r['vpu_flops']:<2d} {r['ms']:8.3f} ms  "
              f"{r['card_cycles_per_cell']:7.1f} cyc/cell (card), "
              f"{r['sm_cycles_per_cell']:8.0f} cyc/cell (one SM) at "
              f"{r['sm_mhz']:.0f} MHz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
