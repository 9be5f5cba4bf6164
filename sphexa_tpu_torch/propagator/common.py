"""Shared step tail: global timestep + integration + diagnostics.

Counterpart of sphexa_tpu/propagator/common.py (finish_step :55)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.sfc.box import Box
from sphexa_tpu_torch.sph import timestep as ts
from sphexa_tpu_torch.sph.eos import ideal_gas_cv
from sphexa_tpu_torch.sph.kernels import update_h
from sphexa_tpu_torch.sph.positions import position_update, temp_update
from sphexa_tpu_torch.state import Particles, SimState
from sphexa_tpu_torch.util.kahan import kahan_sum


class StepDiagnostics(NamedTuple):
    dt: torch.Tensor
    ttot: torch.Tensor
    etot: torch.Tensor
    ecin: torch.Tensor
    eint: torch.Tensor
    egrav: torch.Tensor
    h_max: torch.Tensor
    nc_mean: torch.Tensor
    max_nc: torch.Tensor
    max_cell_count: torch.Tensor
    maxvsignal: torch.Tensor
    bounds: torch.Tensor = None   # [xmin,xmax,ymin,ymax,zmin,zmax] of alive
    nf_truncated: torch.Tensor = 0   # FMM near-field slots beyond
                                     # leaf_cap (dropped pairs: fail-stop)
    rho: torch.Tensor = None
    p: torch.Tensor = None


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def compute_energies(ps: Particles, cfg: SphConfig):
    """Kinetic + internal energy with compensated reductions."""
    cv = ideal_gas_cv(cfg.mui, cfg.gamma)
    ke = ps.m * (ps.vx ** 2 + ps.vy ** 2 + ps.vz ** 2)
    ecin = 0.5 * kahan_sum(torch.where(ps.alive, ke, _zero(ke)))
    ie = ps.m * cv * ps.temp
    eint = kahan_sum(torch.where(ps.alive, ie, _zero(ie)))
    return ecin, eint


def finish_step(state: SimState, ps: Particles, ax, ay, az, du, maxvsignal,
                c, divv, nc_sph, box: Box, cfg: SphConfig,
                max_nc, max_cell_count, egrav=None, nf_truncated=None,
                rho=None, p=None):
    """Timestep + Press-2 integration + AB2 energy + h controller + diag.
    `ps` must carry the force-step-updated h/alpha; divv None (the
    std pipeline) leaves out the rho limit; under gravity
    (gravG != 0) ax, ay, az include it, `egrav` is its energy and the
    acceleration limit joins the dt candidates."""
    dt_courant = ts.courant_timestep(maxvsignal, ps.h, c, ps.alive, cfg.kcour)
    candidates = [dt_courant]
    if divv is not None:  # the std pipeline has no divv (std_hydro)
        candidates.append(ts.rho_timestep(divv, ps.alive, cfg.krho))
    if cfg.gravG != 0.0:
        candidates.append(ts.acceleration_timestep(
            ax, ay, az, ps.alive, cfg.eta_acc, cfg.eps))
    dt = ts.combine_timesteps(state.dt, candidates, cfg)
    dt_m1 = state.dt

    x, y, z, vx, vy, vz, dx, dy, dz = position_update(
        dt, dt_m1, ps.x, ps.y, ps.z, ax, ay, az,
        ps.x_m1, ps.y_m1, ps.z_m1, box,
        h=ps.h, vx=ps.vx, vy=ps.vy, vz=ps.vz)
    temp = temp_update(ps.temp, dt, dt_m1, du, ps.du_m1, cfg.mui, cfg.gamma)
    h = update_h(cfg.ng0, nc_sph, ps.h, h_cap=cfg.h_cap)

    ps = ps.replace(x=x, y=y, z=z, vx=vx, vy=vy, vz=vz,
                    x_m1=dx, y_m1=dy, z_m1=dz, temp=temp, h=h, du_m1=du)

    ecin, eint = compute_energies(ps, cfg)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    egrav = zero if egrav is None else egrav
    nf_truncated = zero.to(torch.int32) if nf_truncated is None \
        else nf_truncated
    big = torch.full((), 1e30, dtype=x.dtype, device=x.device)
    bounds = torch.stack([
        torch.min(torch.where(ps.alive, ps.x, big)),
        torch.max(torch.where(ps.alive, ps.x, -big)),
        torch.min(torch.where(ps.alive, ps.y, big)),
        torch.max(torch.where(ps.alive, ps.y, -big)),
        torch.min(torch.where(ps.alive, ps.z, big)),
        torch.max(torch.where(ps.alive, ps.z, -big))])
    alive_f = ps.alive.to(nc_sph.dtype)
    diag = StepDiagnostics(
        bounds=bounds,
        dt=dt, ttot=state.ttot + dt, etot=ecin + eint + egrav, ecin=ecin,
        eint=eint, egrav=egrav,
        h_max=torch.max(torch.where(ps.alive, ps.h, _zero(ps.h))),
        nc_mean=(torch.sum(nc_sph * alive_f)
                 / torch.clamp_min(torch.sum(ps.alive), 1)).to(torch.float32),
        max_nc=max_nc, max_cell_count=max_cell_count,
        nf_truncated=nf_truncated, rho=rho, p=p,
        maxvsignal=torch.max(torch.where(ps.alive, maxvsignal,
                                         _zero(maxvsignal))))

    new_state = SimState(p=ps, ttot=state.ttot + dt, dt=dt, dt_m1=dt_m1,
                         iteration=state.iteration + 1)
    return new_state, diag
