"""Gravity-only (collisionless N-body) propagator.

Counterpart of sphexa_tpu/propagator/nbody.py (reference: main/src/
propagator/nbody.hpp): the FMM (gravity_solver "fmm") or the direct sum
(any other solver name), the acceleration time-step limit, and the
Press-2 position update of the hydro step."""

from __future__ import annotations

import torch

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.gravity.direct import direct_gravity, egrav
from sphexa_tpu_torch.propagator.common import StepDiagnostics
from sphexa_tpu_torch.sfc.box import Box
from sphexa_tpu_torch.sph import timestep as ts
from sphexa_tpu_torch.sph.positions import position_update
from sphexa_tpu_torch.state import SimState
from sphexa_tpu_torch.util.device import resolve_device
from sphexa_tpu_torch.util.kahan import kahan_sum


def make_nbody_step(box: Box, cfg: SphConfig, device=None):
    """step(state) -> (state, StepDiagnostics) on `device` (default: the
    GPU); the state must live there. The diagnostics carry the FMM's
    nf_truncated (0 under the direct sum)."""
    device = resolve_device(device)

    def step(state: SimState):
        ps = state.p
        if ps.device != device:
            raise ValueError(f"state on {ps.device}, step built for {device}")
        zero = torch.zeros((), dtype=torch.float32, device=device)
        if cfg.gravity_solver == "fmm":
            from sphexa_tpu_torch.gravity.fmm import FmmConfig, fmm_gravity
            g = fmm_gravity(ps.x, ps.y, ps.z, ps.m, ps.alive, box,
                            cfg.gravG, FmmConfig(level=cfg.fmm_level,
                                                 min_sep=cfg.fmm_min_sep),
                            eps=cfg.eps)
            nf = g.nf_truncated
        else:
            g = direct_gravity(ps.x, ps.y, ps.z, ps.m, ps.alive, cfg.gravG,
                               cfg.eps)
            nf = zero.to(torch.int32)
        eg = egrav(ps.m, g.pot, ps.alive)

        dt = torch.minimum(cfg.max_dt_increase * state.dt,
                           ts.acceleration_timestep(g.ax, g.ay, g.az,
                                                    ps.alive, cfg.eta_acc,
                                                    cfg.eps))
        x, y, z, vx, vy, vz, dx, dy, dz = position_update(
            dt, state.dt, ps.x, ps.y, ps.z, g.ax, g.ay, g.az,
            ps.x_m1, ps.y_m1, ps.z_m1, box)
        ps = ps.replace(x=x, y=y, z=z, vx=vx, vy=vy, vz=vz,
                        x_m1=dx, y_m1=dy, z_m1=dz)

        ke = ps.m * (vx ** 2 + vy ** 2 + vz ** 2)
        ecin = 0.5 * kahan_sum(torch.where(ps.alive, ke,
                                           torch.zeros_like(ke)))
        i0 = zero.to(torch.int32)
        diag = StepDiagnostics(
            dt=dt, ttot=state.ttot + dt, etot=ecin + eg, ecin=ecin,
            eint=zero, egrav=eg, h_max=zero, nc_mean=zero, max_nc=i0,
            max_cell_count=i0, maxvsignal=zero, nf_truncated=nf)
        return SimState(p=ps, ttot=state.ttot + dt, dt=dt, dt_m1=state.dt,
                        iteration=state.iteration + 1), diag

    return step
