"""Device selection for the port's entry points (no JAX counterpart:
the JAX package takes its device from the backend).

Entry points run on the GPU unless the caller names another device.
Without a GPU they raise instead of quietly running on the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device to run on, with a CUDA index filled in (so it compares
    equal to a tensor's .device)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "sphexa_tpu_torch runs on the GPU by default and no CUDA "
                "device is available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
