"""Device selection for the port's entry points (no JAX counterpart:
the JAX package takes its device from the backend).

Entry points run on the GPU unless the caller names another device.
Without a GPU they raise instead of quietly running on the CPU. `host`
copies a tensor to a numpy array for the host-side code (I/O, the
CLI's planners)."""

from __future__ import annotations

import numpy as np
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


def host(a):
    """numpy array of a tensor (copied from its device) or of anything
    numpy takes."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)
