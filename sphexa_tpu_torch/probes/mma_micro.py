"""P5: in-kernel matrix-product cost against precision
(scripts/mxu_micro.py).

make(mode, vpu_flops) is the script's function of x [FJ, RUNW]: per
program, 9 dots [CAP, RUNW] x [RUNW, K] of w_g = (x[0, :] + row) * (1 +
g), after vpu_flops elementwise steps w * 1.000001 + 0.5, with M2 =
x[:K, :RUNW]^T, summed into acc [CAP, K]; out [CAP, RUNW] holds acc and
zeros. Modes: "none" (acc += w[:, :K], no product), "f32", "f32_highest",
"bf16" (operands rounded to bf16, float32 sums). Every one of NCELL
programs computes the same block.

On the card (csrc/probes.cu) "f32" runs as TF32 (what a float32 product
gives at TF32 precision), "f32_highest" as 3xTF32, "bf16" as bf16, in
one of two designs (DESIGNS):

  wgmma     the default: persistent warpgroups (a block of 128 threads
            walks the cells), B staged once a block, the w tile in
            registers as wgmma's A, each chunk's elementwise work
            computed while the previous chunk's wgmma chain runs
  mma_sync  a block per cell, mma.sync m16n8k8 / m16n8k16, B reloaded
            from shared memory at every step

"none" has no product: both designs run mma_sync's loop. The design
"wgmma_serial" is the wgmma kernel with its overlap switched off (wait
for each chain before the next chunk's elementwise work), for
measuring the overlap. The plain version takes float32 products
(bf16-rounded operands under "bf16"). The sweep prints ms, cycles per
cell at the card's maximum SM clock (card-wide and per SM), and each
kernel's registers, spill bytes and blocks an SM holds:

    python -m sphexa_tpu_torch.probes.mma_micro [design ...]

(no design: mma_sync, wgmma and wgmma_serial).
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
DESIGNS = ("mma_sync", "wgmma")
SERIAL = "wgmma_serial"


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def kernel_design(mode: str, design: str) -> str:
    """The design whose kernel runs `mode` under `design` (the launcher
    checks the design's name)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    _cuda.mma_design(design, 1)
    return "mma_sync" if mode == "none" else design


def _plain(x, mode: str, vpu_flops: int, ncell: int, *_design):
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


def _launch(x, mode: str, vpu_flops: int, ncell: int, design: str = "wgmma"):
    out = torch.zeros((CAP, RUNW), dtype=torch.float32, device=x.device)
    _cuda.mma_micro_launch(kernel_design(mode, design), MODES.index(mode), x,
                           out, ncell, vpu_flops)
    return out


class _Cells(Probe):
    """P5's wrapper: `launches` counts kernel launches by the design that
    ran ({design: n}; mode "none" runs mma_sync's loop)."""

    def __init__(self):
        super().__init__("mma_cells", _plain, _launch)
        self.launches = dict.fromkeys(_cuda.MMA_DESIGNS, 0)

    def _count(self, x, mode, vpu_flops, ncell, design="wgmma"):
        self.launches[kernel_design(mode, design)] += 1


mma_cells = _Cells()


def make(mode: str, vpu_flops: int, design: str = "wgmma"):
    """f(x) -> out [CAP, RUNW], x a contiguous float32 [FJ, RUNW]."""
    kernel_design(mode, design)

    def f(x):
        if x.shape != (FJ, RUNW) or x.dtype != torch.float32 \
                or not x.is_contiguous():
            raise ValueError(f"expects a contiguous float32 [{FJ}, {RUNW}]")
        return mma_cells(x, mode, vpu_flops, NCELL, design)
    return f


def info(mode: str, design: str = "wgmma") -> dict:
    """Registers, spill bytes, blocks an SM holds and the persistent
    grid of the kernel that runs `mode` under `design` (on the card)."""
    return _cuda.mma_micro_info(kernel_design(mode, design),
                                MODES.index(mode))


def dot_flops(ncell: int = NCELL) -> int:
    """Flops of the 9 dots of every cell (multiply-add = 2)."""
    return ncell * 9 * 2 * CAP * RUNW * K


def vpu_ops(vpu_flops: int, ncell: int = NCELL) -> int:
    """fp32 operations of the elementwise w (v, the scale, 2 a step)."""
    return ncell * 9 * CAP * RUNW * (2 + 2 * vpu_flops)


def sweep(reps: int = 10, device="cuda", designs=DESIGNS + (SERIAL,)):
    """Each mode, vpu_flops and design on the card ("none" once, under
    mma_sync): [{mode, vpu_flops, design, ms, card_cycles_per_cell,
    sm_cycles_per_cell, registers, local_bytes, blocks_per_sm}] at the
    maximum SM clock."""
    x = torch.ones((FJ, RUNW), dtype=torch.float32, device=device)
    mhz = float(smi("clocks.max.sm"))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for vf in VPU_FLOPS:
        for mode in MODES:
            for design in dict.fromkeys(kernel_design(mode, d)
                                        for d in designs):
                f = make(mode, vf, design)
                ms = cuda_ms(lambda: f(x), reps)
                cyc = ms * 1e-3 * mhz * 1e6 / NCELL
                k = info(mode, design)
                rows.append(dict(mode=mode, vpu_flops=vf, design=design,
                                 ms=ms, sm_mhz=mhz,
                                 card_cycles_per_cell=cyc,
                                 sm_cycles_per_cell=cyc * n_sm,
                                 registers=k["registers"],
                                 local_bytes=k["local_bytes"],
                                 blocks_per_sm=k["blocks_per_sm"]))
    return rows


def scaling(reps: int = 5, device="cuda"):
    """ms of the wgmma design at NCELL and at 2 NCELL cells of each
    product mode and vpu_flops: [{mode, vpu_flops, ms, ms_2x, ratio}]. A
    ratio near 2 shows that every cell's work runs (none hoisted or
    merged)."""
    x = torch.ones((FJ, RUNW), dtype=torch.float32, device=device)
    rows = []
    for vf in VPU_FLOPS:
        for mode in MODES[1:]:
            ms = cuda_ms(lambda: mma_cells(x, mode, vf, NCELL, "wgmma"),
                         reps)
            ms2 = cuda_ms(lambda: mma_cells(x, mode, vf, 2 * NCELL, "wgmma"),
                          reps)
            rows.append(dict(mode=mode, vpu_flops=vf, ms=ms, ms_2x=ms2,
                             ratio=ms2 / ms))
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    designs = tuple(argv) or DESIGNS + (SERIAL,)
    for d in designs:
        kernel_design("f32", d)
    need_cuda()
    print(card())
    for r in sweep(designs=designs):
        print(f"{r['mode']:12s} vpu={r['vpu_flops']:<2d} {r['design']:12s} "
              f"{r['ms']:8.3f} ms  "
              f"{r['card_cycles_per_cell']:7.1f} cyc/cell (card), "
              f"{r['sm_cycles_per_cell']:8.0f} cyc/cell (one SM) at "
              f"{r['sm_mhz']:.0f} MHz  {r['registers']} registers, "
              f"{r['local_bytes']} B spilled, {r['blocks_per_sm']} "
              f"blocks/SM")
    return 0


if __name__ == "__main__":
    sys.exit(main())
