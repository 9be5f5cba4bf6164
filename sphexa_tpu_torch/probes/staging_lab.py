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

A call's bytes are counted three ways (`byte_counts`): the source lanes
its windows touch, read once (unique); every window as staged (the
windows overlap, so this counts lanes again); and what a device memory
behind an LRU cache of the card's L2 size must deliver when the programs
run in the script's order (`lru_bytes`, in 32-byte sectors of every row).
`footprint_sweep` times the designs on sources of 12.6 MB to the
script's 201 MB with the same windows, so that the source fits the L2
at the small end.

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
SECTOR = 8                      # lanes of float32 in one 32-byte sector


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


def _lanes(fn: str, starts, k: int, ns: int, nprog: int):
    """First lane and lane count of each run of source lanes the
    script's function reads, in program order then window order."""
    st = np.asarray(starts)[:nprog].astype(np.int64)
    if fn == "many":
        return st[:, :k].reshape(-1), LANES
    if fn == "few":
        return st[:, 0], LANES * k
    nsb = ns // LANES
    blk = (np.arange(nprog)[:, None] * 7 + np.arange(k)[None] * 13) \
        % (nsb - 1)
    return blk.reshape(-1) * LANES, LANES


def lru_bytes(fn: str, starts, k: int, f: int, ns: int, nprog: int,
              cache_bytes: int) -> int:
    """Bytes device memory delivers to one call of the script's function
    `fn` ("many", "few", "pipe") behind an LRU cache of cache_bytes,
    the programs in order: each run of lanes is read as 32-byte sectors
    of all f rows (a sector column, 32 f bytes), a sector column missing
    from the cache costs its bytes."""
    from collections import OrderedDict

    first, n = _lanes(fn, starts, k, ns, nprog)
    cap = cache_bytes // (4 * SECTOR * f)
    cache = OrderedDict()
    misses = 0
    for a in first.tolist():
        for c in range(a // SECTOR, (a + n - 1) // SECTOR + 1):
            if c in cache:
                cache.move_to_end(c)
            else:
                misses += 1
                cache[c] = None
                if len(cache) > cap:
                    cache.popitem(last=False)
    return misses * 4 * SECTOR * f


def byte_counts(fn: str, starts, k: int, f: int, ns: int, nprog: int,
                cache_bytes: int) -> dict:
    """A call's source bytes three ways: unique (each touched lane once),
    windows (as staged) and lru (lru_bytes); "extra" is what every count
    adds: the starts read and out read and written."""
    first, n = _lanes(fn, starts, k, ns, nprog)
    touched = np.zeros(ns, dtype=bool)
    for a in first.tolist():
        touched[a:a + n] = True
    extra = 4 * nprog * {"many": k, "few": 1, "pipe": 0}[fn] \
        + 2 * 4 * nprog * 8 * LANES
    return dict(unique=4 * f * int(touched.sum()),
                windows=window_bytes(k, f, nprog),
                lru=lru_bytes(fn, starts, k, f, ns, nprog, cache_bytes),
                extra=extra)


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


def footprint_sweep(k=K, f=F, nprog=NPROG, device="cuda"):
    """One call of each design with the source 2^17 to NS = 2^21 lanes
    wide (12.6 MB to 201 MB at F 24), the same K windows a program:
    [{design, ns, source_mb, ms}]."""
    rows = []
    for sh in range(17, 22):
        ns = 1 << sh
        src, starts = (t.to(device) for t in inputs(k, f, ns, nprog))
        out = torch.zeros((nprog * 8, LANES), dtype=torch.float32,
                          device=device)
        for design, probe in PROBES.items():
            ms = cuda_ms(lambda: probe(src, starts, out, k), 10)
            rows.append(dict(design=design, ns=ns,
                             source_mb=4 * f * ns / 1e6, ms=ms))
        del src, starts, out
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
    for r in footprint_sweep(k=k, f=f, nprog=nprog):
        print(f"{r['design']:9s} source {r['source_mb']:6.1f} MB "
              f"{r['ms']:8.3f} ms/call")
    return 0


if __name__ == "__main__":
    sys.exit(main())
