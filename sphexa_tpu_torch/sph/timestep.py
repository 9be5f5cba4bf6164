"""Global time-step determination.

Counterpart of sphexa_tpu/sph/timestep.py (reference: ts_global.hpp).
Every reduction masks dead rows and returns a 0-dim tensor."""

from __future__ import annotations

import torch

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.sph.kernels import ts_k_courant
from sphexa_tpu_torch.util.fp import rdiv

BIG = 1e30   # used as float32(1e30), as in the JAX package


def _fill(x, v):
    return torch.full((), v, dtype=x.dtype, device=x.device)


def courant_timestep(maxvsignal, h, c, alive, kcour: float):
    dt_i = ts_k_courant(maxvsignal, h, c, kcour)
    return torch.min(torch.where(alive, dt_i, _fill(dt_i, BIG)))


def rho_timestep(divv, alive, krho: float):
    """Krho / |max divv| (ts_global.hpp:70-94)."""
    max_divv = torch.max(torch.where(alive, divv, _fill(divv, -BIG)))
    return rdiv(krho, torch.clamp_min(torch.abs(max_divv), 1e-30))


def acceleration_timestep(ax, ay, az, alive, eta_acc: float, eps: float):
    """etaAcc * sqrt(eps / |a|_max) (ts_global.hpp:46-68)."""
    acc2 = ax * ax + ay * ay + az * az
    max_acc = torch.sqrt(torch.max(torch.where(alive, acc2,
                                               torch.zeros_like(acc2))))
    return eta_acc * torch.sqrt(rdiv(eps, torch.clamp_min(max_acc, 1e-30)))


def combine_timesteps(dt_prev, dt_candidates, cfg: SphConfig):
    """min of all limits and maxDtIncrease * previous dt
    (ts_global.hpp:96-112)."""
    return torch.minimum(cfg.max_dt_increase * dt_prev,
                         torch.stack(list(dt_candidates)).min())
