"""P5's wgmma design taken apart (csrc/probes.cu, mma_micro_wgmma): the
kernel built with one of its two parts cut out (-DMW_PART, ops/_cuda.py's
VARIANTS) and timed beside the whole kernel at the script's NCELL:

  product      the elementwise work removed: w's columns and rows go to
               the tensor cores as loaded, so the time is the wgmma
               chains' with the loads around them
  elementwise  the product removed: each wgmma becomes two lop3 that
               fold its A registers into the accumulator, so the time is
               the elementwise work's

The whole kernel's time against these two says how far the chains and
the elementwise work overlap.

    python -m sphexa_tpu_torch.probes.mma_parts
"""

from __future__ import annotations

import sys

import torch

from sphexa_tpu_torch.ops import _cuda
from sphexa_tpu_torch.probes import card, cuda_ms, need_cuda
from sphexa_tpu_torch.probes import mma_micro as p5

# part -> the library of probes.cu built for it
LIBRARIES = {"whole": "probes.cu", "product": "probes_product",
             "elementwise": "probes_elementwise"}


def sweep(reps: int = 5, device="cuda"):
    """ms of the whole kernel and of each part at NCELL, every product
    mode at vpu_flops 0 and 30 (the product part at 0: it has no
    elementwise steps): [{mode, vpu_flops, part, ms}]."""
    x = torch.ones((p5.FJ, p5.RUNW), dtype=torch.float32, device=device)
    out = torch.zeros((p5.CAP, p5.RUNW), dtype=torch.float32, device=device)
    rows = []
    for mode in p5.MODES[1:]:
        m = p5.MODES.index(mode)
        for part, library in LIBRARIES.items():
            for vf in (0,) if part == "product" else p5.VPU_FLOPS:
                ms = cuda_ms(lambda: _cuda.mma_micro_launch(
                    "wgmma", m, x, out, p5.NCELL, vf, library), reps)
                rows.append(dict(mode=mode, vpu_flops=vf, part=part, ms=ms))
    return rows


def main() -> int:
    need_cuda()
    print(card())
    for r in sweep():
        print(f"{r['mode']:12s} vpu={r['vpu_flops']:<2d} {r['part']:12s} "
              f"{r['ms']:8.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
