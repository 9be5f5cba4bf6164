"""Particle state containers (structures of tensors).

Counterpart of sphexa_tpu/state.py: `Particles` and `SimState` are
dataclasses of tensors in place of flax.struct pytrees. Capacity is
static; `alive` masks padding rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sphexa_tpu_torch.config import COORD_DTYPE, HYDRO_DTYPE
from sphexa_tpu_torch.util.device import resolve_device

_FIELDS = ["x", "y", "z", "x_m1", "y_m1", "z_m1", "vx", "vy", "vz",
           "temp", "h", "m", "alpha", "du_m1", "alive"]


@dataclasses.dataclass
class Particles:
    """Conserved per-particle fields."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    x_m1: torch.Tensor   # x_n - x_{n-1}
    y_m1: torch.Tensor
    z_m1: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    temp: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor
    alpha: torch.Tensor
    du_m1: torch.Tensor
    alive: torch.Tensor  # bool mask for padding rows

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def replace(self, **kw) -> "Particles":
        return dataclasses.replace(self, **kw)

    def permute(self, perm) -> "Particles":
        """Reorder all per-particle fields (after a cell sort)."""
        return Particles(**{k: getattr(self, k)[perm] for k in _FIELDS})


@dataclasses.dataclass
class SimState:
    p: Particles
    ttot: torch.Tensor       # total simulation time (0-dim f32)
    dt: torch.Tensor         # current step dt
    dt_m1: torch.Tensor      # previous step dt
    iteration: torch.Tensor  # 0-dim int32

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)


def make_particles(n_capacity: int, n_active: int | None = None,
                   device=None, **fields) -> Particles:
    """Build Particles, zero-padding to capacity. Host arrays (float64
    numpy included) are cast to float32 here, as the JAX package does."""
    device = resolve_device(device)
    n_active = n_active if n_active is not None else n_capacity
    out = {}
    for name in _FIELDS[:-1]:
        dtype = COORD_DTYPE if name in ("x", "y", "z") else HYDRO_DTYPE
        arr = fields.get(name)
        if arr is None:
            arr = torch.zeros((n_active,), dtype=dtype, device=device)
        elif isinstance(arr, torch.Tensor):
            arr = arr.to(device=device, dtype=dtype)
        else:
            arr = torch.from_numpy(
                np.ascontiguousarray(arr, dtype=np.float32)).to(device)
        if arr.shape[0] < n_capacity:
            pad = torch.zeros((n_capacity - arr.shape[0],), dtype=dtype,
                              device=device)
            arr = torch.cat([arr, pad])
        out[name] = arr
    alive = torch.arange(n_capacity, device=device) < n_active
    return Particles(alive=alive, **out)


def make_state(p: Particles, dt0: float = 1e-6, ttot: float = 0.0) -> SimState:
    f32 = dict(dtype=torch.float32, device=p.device)
    return SimState(p=p, ttot=torch.tensor(ttot, **f32),
                    dt=torch.tensor(dt0, **f32),
                    dt_m1=torch.tensor(dt0, **f32),
                    iteration=torch.tensor(1, dtype=torch.int32,
                                           device=p.device))
