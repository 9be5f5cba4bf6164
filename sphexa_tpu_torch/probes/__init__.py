"""H100 counterparts of the TPU hardware probes in scripts/ (P1-P5).

Each module holds the script's function, its plain PyTorch version and
the wrapper of its CUDA kernel (csrc/probes.cu), and a `main()` that
sweeps the script's sizes on the card and prints one line per point:

    python -m sphexa_tpu_torch.probes.fma_ceiling   # P1, vpu_ceiling.py
    python -m sphexa_tpu_torch.probes.staging_lab   # P2-P4, dma_lab.py
    python -m sphexa_tpu_torch.probes.mma_micro     # P5, mxu_micro.py

The constants are the scripts' own, copied (the port imports nothing of
the JAX package or scripts/). As everywhere in the port, a wrapper runs
the plain version for CPU tensors and the kernel for CUDA tensors.
"""

from __future__ import annotations

import subprocess

import torch


class Probe:
    """A probe kernel: launch(*args) on CUDA tensors, plain(*args) on CPU
    tensors (the first argument decides). `launches` counts kernel
    launches (`_count`, after each)."""

    def __init__(self, name: str, plain, launch):
        self.name = name
        self.plain = plain
        self._launch = launch
        self.launches = 0

    def __call__(self, *args):
        dev = args[0].device
        if dev.type == "cpu":
            return self.plain(*args)
        if dev.type != "cuda":
            raise ValueError(f"{self.name}: no kernel for device {dev}")
        out = self._launch(*args)
        self._count(*args)
        return out

    def _count(self, *args):
        self.launches += 1


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of fn() on the card over reps calls (CUDA events), after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def smi(query: str) -> str:
    """One nvidia-smi --query-gpu field list of the first card."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip().splitlines()[0]


def card() -> str:
    """The card's name and power limit, as the numbers are kept."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def need_cuda():
    if not torch.cuda.is_available():
        raise SystemExit("the probes measure the card: no CUDA device")
