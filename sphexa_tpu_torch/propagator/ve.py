"""VE propagator on the gather path: the CLI's default step
(--prop ve).

Counterpart of sphexa_tpu/propagator/ve.py (reference: main/src/
propagator/ve_hydro.hpp:132-218):

  sort -> neighbours(+h) -> xmass -> gradh -> EOS -> IAD+divv/curlv ->
  AV switches -> momentum+energy -> [gravity] -> dt -> positions -> h

The JAX package jits it as one XLA program; here it is plain PyTorch,
eager, with no kernel of its own and no host sync inside the step (the
CLI loop reads the diagnostics).
"""

from __future__ import annotations

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.gravity.direct import direct_gravity, egrav
from sphexa_tpu_torch.neighbors import (CellGrid, build_cell_list,
                                        build_neighbor_list)
from sphexa_tpu_torch.propagator.common import finish_step
from sphexa_tpu_torch.sfc.box import Box
from sphexa_tpu_torch.sph import hydro_ve
from sphexa_tpu_torch.sph.eos import eos_ve
from sphexa_tpu_torch.state import Particles, SimState
from sphexa_tpu_torch.util.device import resolve_device


def compute_forces_ve(ps: Particles, box: Box, grid: CellGrid,
                      cfg: SphConfig, dt):
    """Cell sort + neighbour build + the five VE pair stages.

    Returns (sorted particles with updated h/alpha, MomentumEnergy, aux).
    """
    cl = build_cell_list(grid, box, ps.x, ps.y, ps.z, alive=ps.alive)
    ps = ps.permute(cl.perm)
    nl = build_neighbor_list(grid, box, cl, ps.x, ps.y, ps.z, ps.h, cfg,
                             adapt_h=True, alive=ps.alive)
    ps = ps.replace(h=nl.h)
    x, y, z, h = ps.x, ps.y, ps.z, ps.h
    idx, nc = nl.idx, nl.nc

    xm = hydro_ve.compute_xmass(box, x, y, z, h, ps.m, idx, nc, cfg)
    kx, gradh = hydro_ve.compute_ve_def_gradh(box, x, y, z, h, ps.m, xm,
                                              idx, nc, cfg)
    rho, p, c, prho = eos_ve(ps.temp, ps.m, kx, xm, gradh, cfg.mui, cfg.gamma)

    iad = hydro_ve.compute_iad_divv_curlv(box, x, y, z, ps.vx, ps.vy, ps.vz,
                                          h, kx, xm, idx, nc, cfg)
    cij = (iad.c11, iad.c12, iad.c13, iad.c22, iad.c23, iad.c33)

    alpha = hydro_ve.compute_av_switches(box, x, y, z, ps.vx, ps.vy, ps.vz,
                                         h, c, kx, xm, iad.divv, cij,
                                         ps.alpha, dt, idx, nc, cfg)
    ps = ps.replace(alpha=alpha)

    gradv = ((iad.dV11, iad.dV12, iad.dV13, iad.dV22, iad.dV23, iad.dV33)
             if cfg.av_clean else None)
    me = hydro_ve.compute_momentum_energy(box, x, y, z, ps.vx, ps.vy, ps.vz,
                                          h, ps.m, prho, c, cij, kx, xm,
                                          alpha, idx, nc, cfg, gradv=gradv)

    aux = dict(c=c, divv=iad.divv, curlv=iad.curlv, rho=rho, p=p,
               nc_sph=nl.nc_sph, max_nc=nl.max_nc,
               max_cell_count=nl.max_cell_count)
    return ps, me, aux


def make_ve_step(box: Box, grid: CellGrid, cfg: SphConfig, device=None):
    """step(state) -> (state, StepDiagnostics): forces + timestep +
    integration, on `device` (default: the GPU); the state must live
    there. Self-gravity (gravG != 0) runs the FMM (gravity_solver
    "fmm") or the direct sum (any other solver name) over every row,
    as the JAX step does."""
    device = resolve_device(device)

    def step(state: SimState):
        if state.p.device != device:
            raise ValueError(f"state on {state.p.device}, step built for "
                             f"{device}")
        ps, me, aux = compute_forces_ve(state.p, box, grid, cfg, state.dt)
        ax, ay, az = me.ax, me.ay, me.az
        eg = nf = None
        if cfg.gravG != 0.0:
            # self-gravity (reference: ve_hydro.hpp:195-204)
            if cfg.gravity_solver == "fmm":
                from sphexa_tpu_torch.gravity.fmm import (FmmConfig,
                                                          fmm_gravity)
                g = fmm_gravity(ps.x, ps.y, ps.z, ps.m, ps.alive, box,
                                cfg.gravG, FmmConfig(level=cfg.fmm_level,
                                                     min_sep=cfg.fmm_min_sep),
                                eps=cfg.eps)
                nf = g.nf_truncated
            else:
                g = direct_gravity(ps.x, ps.y, ps.z, ps.m, ps.alive,
                                   cfg.gravG, cfg.eps)
            ax = ax + g.ax
            ay = ay + g.ay
            az = az + g.az
            eg = egrav(ps.m, g.pot, ps.alive)
        return finish_step(state, ps, ax, ay, az, me.du, me.maxvsignal,
                           aux["c"], aux["divv"], aux["nc_sph"], box, cfg,
                           max_nc=aux["max_nc"],
                           max_cell_count=aux["max_cell_count"],
                           egrav=eg, nf_truncated=nf,
                           rho=aux["rho"], p=aux["p"])

    return step
