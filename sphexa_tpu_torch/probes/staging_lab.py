"""P2-P4: the cost of staging j-windows in shared memory
(scripts/dma_lab.py).

The script's three functions, each `reps` calls summed (one call: a
program per row block of out reads K windows [F, 128] of src [F, NS] and
folds rows 0-15 of each, acc + w[:8] * w[8:16] + w[:8] * 1.5 + w[8:16] *
0.5, into its [8, 128] block of out [nprog * 8, 128]):

  make_many  window k of program p at the dynamic offset starts[p, k]
  make_few   the same bytes as one contiguous [F, K * 128] span at
             starts[p, 0]
  make_pipe  window k at the static 128-lane block (p*7 + k*13) %
             (NS/128 - 1)

On the card each is a staging design of csrc/probes.cu (VARIANTS): plain
loads, K cp.async groups or K TMA loads for make_many, TMA boxes for
make_few, a cp.async ring for make_pipe. A kernel call adds its fold
into out, so reps launches sum in the script's order. The sweep prints
the ms of one call and the cost per staged window.

    python -m sphexa_tpu_torch.probes.staging_lab [K] [F] [nprog]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from sphexa_tpu_torch.ops import _cuda
from sphexa_tpu_torch.probes import Probe, card, cuda_ms, need_cuda

K, F, NPROG, REPS = 9, 24, 8192, 4
NS = 1 << 21
LANES = 128


def _fold(win):
    """win [K, F, nprog, 128] -> [nprog * 8, 128], the script's order."""
    acc = torch.zeros((8,) + tuple(win.shape[2:]), dtype=torch.float32,
                      device=win.device)
    for w in win:
        a, b = w[:8], w[8:16]
        acc = acc + a * b + a * 1.5 + b * 0.5
    return acc.permute(1, 0, 2).reshape(-1, LANES)


def many_index(starts, k: int, nprog: int):
    """Source lanes of make_many's windows: [K, nprog, 128]."""
    return (starts[:nprog, :k].T.long()[..., None]
            + torch.arange(LANES, device=starts.device))


def few_index(starts, k: int, nprog: int):
    return (starts[:nprog, 0].long()[None, :, None]
            + LANES * torch.arange(k, device=starts.device)[:, None, None]
            + torch.arange(LANES, device=starts.device))


def pipe_index(ns: int, k: int, nprog: int, device):
    nsb = ns // LANES
    blk = (torch.arange(nprog, device=device)[None] * 7
           + torch.arange(k, device=device)[:, None] * 13) % (nsb - 1)
    return blk[..., None] * LANES + torch.arange(LANES, device=device)


def _plain(index):
    def call(src, starts, out, k):
        nprog = out.shape[0] // 8
        idx = index(src, starts, k, nprog)
        win = src[:, idx].permute(1, 0, 2, 3)        # [K, F, nprog, 128]
        out += _fold(win)
        return out
    return call


_INDEX = {
    "many": lambda src, starts, k, n: many_index(starts, k, n),
    "few": lambda src, starts, k, n: few_index(starts, k, n),
    "pipe": lambda src, starts, k, n: pipe_index(src.shape[1], k, n,
                                                 src.device),
}
# staging design -> (variant of csrc/probes.cu, the script's function)
VARIANTS = {"loads": (0, "many"), "many": (1, "many"),
            "many_tma": (2, "many"), "few_tma": (3, "few"),
            "pipe": (4, "pipe")}


def _launcher(variant: int):
    def launch(src, starts, out, k):
        _cuda.staging_launch(variant, src, starts, out, k)
        return out
    return launch


PROBES = {name: Probe(f"staging_{name}", _plain(_INDEX[fn]), _launcher(v))
          for name, (v, fn) in VARIANTS.items()}


def _make(design: str, k: int, f: int, ns: int, nprog: int, reps: int):
    probe = PROBES[design]

    def run(src, starts):
        if src.shape != (f, ns) or src.dtype != torch.float32 \
                or not src.is_contiguous():
            raise ValueError(f"src: expects a contiguous float32 [{f}, "
                             f"{ns}] tensor")
        if starts.dtype != torch.int32 or starts.shape[0] < nprog \
                or starts.shape[1] < k or not starts.is_contiguous():
            raise ValueError("starts: expects contiguous int32 [nprog, >= K]")
        out = torch.zeros((nprog * 8, LANES), dtype=torch.float32,
                          device=src.device)
        for _ in range(reps):
            probe(src, starts, out, k)
        return out
    return run


def make_many(K, F, NS, nprog, reps, design: str = "many"):
    """run(src, starts) -> out of dma_lab.make_many; design: "many"
    (cp.async), "many_tma" or "loads" (plain loads)."""
    assert VARIANTS[design][1] == "many"
    return _make(design, K, F, NS, nprog, reps)


def make_few(K, F, NS, nprog, reps):
    return _make("few_tma", K, F, NS, nprog, reps)


def make_pipe(K, F, NS, nprog, reps):
    return _make("pipe", K, F, NS, nprog, reps)


def inputs(k: int, f: int, ns: int, nprog: int, seed: int = 0):
    """The script's src and starts (numpy's default_rng(seed)), as
    float32 and int32 CPU tensors."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((f, ns)).astype(np.float32)
    starts = rng.integers(0, ns - 130 * k, (nprog, 128)).astype(np.int32)
    return torch.from_numpy(src), torch.from_numpy(starts)


def window_bytes(k: int, f: int, nprog: int) -> int:
    """Bytes of the windows one call stages."""
    return 4 * k * f * LANES * nprog


def sweep(k=K, f=F, nprog=NPROG, reps_timed: int = 20, device="cuda"):
    """One call of each design on the card: [{design, ms, us_per_window,
    gbs}] (gbs: staged window bytes over the call's time)."""
    src, starts = (t.to(device) for t in inputs(k, f, NS, nprog))
    out = torch.zeros((nprog * 8, LANES), dtype=torch.float32,
                      device=device)
    rows = []
    for design in VARIANTS:
        probe = PROBES[design]
        ms = cuda_ms(lambda: probe(src, starts, out, k), reps_timed)
        rows.append(dict(design=design, ms=ms,
                         us_per_window=ms * 1e3 / (nprog * k),
                         gbs=window_bytes(k, f, nprog) / ms / 1e6))
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    k = int(argv[0]) if len(argv) > 0 else K
    f = int(argv[1]) if len(argv) > 1 else F
    nprog = int(argv[2]) if len(argv) > 2 else NPROG
    need_cuda()
    print(card())
    for r in sweep(k, f, nprog):
        print(f"{r['design']:9s} {r['ms']:8.3f} ms/call  "
              f"{r['us_per_window'] * 1e3:8.2f} ns/window  "
              f"{r['gbs']:8.1f} GB/s of windows")
    return 0


if __name__ == "__main__":
    sys.exit(main())
