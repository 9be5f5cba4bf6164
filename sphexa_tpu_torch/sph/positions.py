"""Press 2nd-order time integration + Adams-Bashforth-2 energy update.

Counterpart of sphexa_tpu/sph/positions.py (reference:
positions.hpp:46-151)."""

from __future__ import annotations

import torch

from sphexa_tpu_torch.sfc.box import Box, Boundary, put_in_box
from sphexa_tpu_torch.sph.eos import ideal_gas_cv


def position_update(dt, dt_m1, x, y, z, ax, ay, az, dx, dy, dz, box: Box,
                    h=None, vx=None, vy=None, vz=None, fold: bool = True):
    """Returns (x', y', z', vx', vy', vz', dx', dy', dz'). `dt` and
    `dt_m1` are 0-dim tensors. fold=False skips the periodic wrap (the
    resident engine folds at rebin time)."""
    inv_dtm1 = 1.0 / dt_m1

    def advance(X, A, dX):
        v_half = dX * inv_dtm1
        v_n = v_half + 0.5 * dt_m1 * A
        v_np1 = v_n + A * dt
        dX_np1 = (v_n + 0.5 * A * torch.abs(dt)) * dt
        return X + dX_np1, v_np1, dX_np1

    xn, vxn, dxn = advance(x, ax, dx)
    yn, vyn, dyn = advance(y, ay, dy)
    zn, vzn, dzn = advance(z, az, dz)

    if box.any_fixed and h is not None:
        # freeze wall particles: v == 0 and within 2h of a fixed boundary
        def near(coord, lo, hi, b):
            if b != Boundary.fixed:
                return torch.zeros(coord.shape, dtype=torch.bool,
                                   device=coord.device)
            return ((torch.abs(hi - coord) < 2.0 * h)
                    | (torch.abs(coord - lo) < 2.0 * h))

        frozen = ((vx == 0.0) & (vy == 0.0) & (vz == 0.0)
                  & (near(x, box.xmin, box.xmax, box.bx)
                     | near(y, box.ymin, box.ymax, box.by)
                     | near(z, box.zmin, box.zmax, box.bz)))
        xn = torch.where(frozen, x, xn)
        yn = torch.where(frozen, y, yn)
        zn = torch.where(frozen, z, zn)
        vxn = torch.where(frozen, vx, vxn)
        vyn = torch.where(frozen, vy, vyn)
        vzn = torch.where(frozen, vz, vzn)
        dxn = torch.where(frozen, dx, dxn)
        dyn = torch.where(frozen, dy, dyn)
        dzn = torch.where(frozen, dz, dzn)

    if fold:
        xn, yn, zn = put_in_box(box, xn, yn, zn)
    return xn, yn, zn, vxn, vyn, vzn, dxn, dyn, dzn


def energy_update(u_old, dt, dt_m1, du, du_m1):
    """Adams-Bashforth 2; an exponential floor keeps u positive."""
    u_new = u_old + du * dt + 0.5 * (du - du_m1) / dt_m1 * torch.abs(dt) * dt
    safe_u = torch.where(u_old > 0.0, u_old, torch.ones_like(u_old))
    floored = safe_u * torch.exp(u_new * dt / safe_u)
    return torch.where(u_new < 0.0, floored, u_new)


def temp_update(temp, dt, dt_m1, du, du_m1, mui, gamma):
    cv = ideal_gas_cv(mui, gamma)
    u_new = energy_update(cv * temp, dt, dt_m1, du, du_m1)
    return u_new / cv
