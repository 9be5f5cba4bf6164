"""P1: the card's sustained fp32 FMA rate (scripts/vpu_ceiling.py).

make(rows, nchain, length) is the script's function: for x of shape
[NCELL * rows, W], nchain data-dependent chains acc = acc * acc * 1e-6 +
base per element (acc enters both operands, so no chain folds into one
affine map), started at base * (1 + 0.1 c), of `length` steps, then the
sum of the chains. The kernel (csrc/probes.cu, fma_chains) keeps the
chains in registers, one element a thread: a step is an FMUL and an
FFMA, two fp32 instructions. Rates are printed as the script counts them
(2 flops a step) and as the fp32 pipe sees them (4: two instructions at
2 flops, the unit of the 67 TFLOP/s data-sheet rate).

    python -m sphexa_tpu_torch.probes.fma_ceiling
"""

from __future__ import annotations

import sys

import torch

from sphexa_tpu_torch.ops import _cuda
from sphexa_tpu_torch.probes import Probe, card, cuda_ms, need_cuda

NCELL = 4096
W = 1024
ROWS = (8, 16, 32)
# the script's 1-8, and the counts a Hopper SM needs to cover the FMA
# latency with independent chains
CHAINS = (1, 2, 4, 8, 16, 32)
STEPS = 256                   # nchain * length in every point


def _plain(x, nchain: int, length: int):
    accs = [x * (1.0 + 0.1 * c) for c in range(nchain)]
    for _ in range(length):
        accs = [a * a * 1e-6 + x for a in accs]
    out = accs[0]
    for a in accs[1:]:
        out = out + a
    return out


def _launch(x, nchain: int, length: int):
    out = torch.empty_like(x)
    _cuda.fma_ceiling_launch(x, out, nchain, length)
    return out


fma_chains = Probe("fma_chains", _plain, _launch)


def make(rows: int, nchain: int, length: int):
    """f(x) -> out, x and out [NCELL * rows, W] float32."""
    def f(x):
        if x.shape != (NCELL * rows, W) or x.dtype != torch.float32 \
                or not x.is_contiguous():
            raise ValueError(f"expects a contiguous float32 "
                             f"[{NCELL * rows}, {W}] tensor")
        return fma_chains(x, nchain, length)
    return f


def flops(rows: int, nchain: int, length: int) -> int:
    """The script's count: 2 flops a chain step."""
    return NCELL * rows * W * nchain * length * 2


def sweep(rows_list=ROWS, chains=CHAINS, reps: int = 10, device="cuda"):
    """Time make() at each point on the card: [{rows, nchain, ms,
    gflops, fp32_pipe_gflops}]."""
    out = []
    for rows in rows_list:
        x = torch.ones((NCELL * rows, W), dtype=torch.float32,
                       device=device)
        for nchain in chains:
            length = STEPS // nchain
            f = make(rows, nchain, length)
            ms = cuda_ms(lambda: f(x), reps)
            fl = flops(rows, nchain, length)
            out.append(dict(rows=rows, nchain=nchain, length=length, ms=ms,
                            gflops=fl / ms / 1e6,
                            fp32_pipe_gflops=2 * fl / ms / 1e6))
    return out


def main() -> int:
    need_cuda()
    print(card())
    for p in sweep():
        print(f"rows={p['rows']:<2d} chains={p['nchain']:<2d} "
              f"{p['ms']:9.3f} ms  {p['gflops']:9.0f} Gflop/s (2 a step)  "
              f"{p['fp32_pipe_gflops']:9.0f} Gflop/s (fp32 pipe, 4 a step)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
