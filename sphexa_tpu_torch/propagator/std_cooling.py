"""std-SPH + radiative cooling propagator
(reference: main/src/propagator/std_hydro_grackle.hpp:151-220: the std
pipeline, optional self-gravity, then chemistry/cooling integration and
a cooling-limited timestep).

Counterpart of sphexa_tpu/propagator/std_cooling.py
(make_std_cooling_step): the std step of propagator/std.py, gravity on
the particle rows (gravity/fmm.py or gravity/direct.py), then the
subcycled cooling of physics/cooling.py with the step's input dt.
Chemistry fields (physics/chemistry.py ChemistryData) are permuted with
the particles by the cell sort and relax to the CIE equilibrium of the
cooled temperature. Plain PyTorch, eager, no kernel of its own.

The diagnostics carry the FMM's nf_truncated, which the JAX step
discards (ROADMAP Queue 3); the physics is the same.
"""

from __future__ import annotations

import torch

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.gravity.direct import direct_gravity, egrav
from sphexa_tpu_torch.neighbors import (CellGrid, build_cell_list,
                                        build_neighbor_list)
from sphexa_tpu_torch.physics.chemistry import (ChemistryData,
                                                update_chemistry)
from sphexa_tpu_torch.physics.cooling import (CoolingParams, cool_particles,
                                              cooling_timestep)
from sphexa_tpu_torch.propagator.common import finish_step
from sphexa_tpu_torch.sfc.box import Box
from sphexa_tpu_torch.sph import hydro_std
from sphexa_tpu_torch.sph.eos import eos_std
from sphexa_tpu_torch.state import SimState
from sphexa_tpu_torch.util.device import resolve_device


def make_std_cooling_step(box: Box, grid: CellGrid, cfg: SphConfig,
                          params: CoolingParams = CoolingParams(),
                          with_chemistry: bool = False, device=None):
    """step(state) -> (state, StepDiagnostics) on `device` (default: the
    GPU); given a ChemistryData (with_chemistry=True, as the JAX
    docstring puts it), step(state, chem) -> (state, diag, chem), the
    chemistry permuted with the particles by the cell sort."""
    device = resolve_device(device)

    def step(state: SimState, chem: ChemistryData | None = None):
        ps = state.p
        if ps.device != device:
            raise ValueError(f"state on {ps.device}, step built for {device}")
        cl =build_cell_list(grid, box, ps.x, ps.y, ps.z, alive=ps.alive)
        ps = ps.permute(cl.perm)
        if chem is not None:
            chem = chem.permute(cl.perm)
        nl = build_neighbor_list(grid, box, cl, ps.x, ps.y, ps.z, ps.h,
                                 cfg, adapt_h=True, alive=ps.alive)
        ps = ps.replace(h=nl.h)
        x, y, z, h = ps.x, ps.y, ps.z, ps.h
        idx, nc = nl.idx, nl.nc

        rho = hydro_std.compute_density(box, x, y, z, h, ps.m, idx, nc, cfg)
        p, c = eos_std(ps.temp, rho, cfg.mui, cfg.gamma)
        cij = hydro_std.compute_iad_std(box, x, y, z, h, ps.m, rho, idx, nc,
                                        cfg)
        me = hydro_std.compute_momentum_energy_std(
            box, x, y, z, ps.vx, ps.vy, ps.vz, h, ps.m, rho, p, c, cij,
            idx, nc, cfg)
        ax, ay, az = me.ax, me.ay, me.az
        eg = nf = None
        if cfg.gravG != 0.0:
            # reference: std_hydro_grackle includes self-gravity
            if cfg.gravity_solver == "fmm":
                from sphexa_tpu_torch.gravity.fmm import (FmmConfig,
                                                          fmm_gravity)
                g = fmm_gravity(x, y, z, ps.m, ps.alive, box, cfg.gravG,
                                FmmConfig(level=cfg.fmm_level,
                                          min_sep=cfg.fmm_min_sep),
                                eps=cfg.eps)
                nf = g.nf_truncated
            else:
                g = direct_gravity(x, y, z, ps.m, ps.alive, cfg.gravG,
                                   cfg.eps)
            ax, ay, az = ax + g.ax, ay + g.ay, az + g.az
            eg = egrav(ps.m, g.pot, ps.alive)

        # cooling after the hydro forces, over the step's input dt; the
        # cooling time limits the global dt
        temp_cooled = cool_particles(ps.temp, rho, state.dt, cfg, params)
        temp_cooled = torch.where(ps.alive, temp_cooled, ps.temp)
        ps = ps.replace(temp=temp_cooled)
        if chem is not None:
            chem = update_chemistry(chem, temp_cooled * params.temp_to_k,
                                    ps.alive)
        dt_cool = cooling_timestep(torch.where(ps.alive, ps.temp, 1e8),
                                   rho, cfg, params)

        new_state, diag = finish_step(
            state, ps, ax, ay, az, me.du, me.maxvsignal, c, None,
            nl.nc_sph, box, cfg, max_nc=nl.max_nc,
            max_cell_count=nl.max_cell_count, egrav=eg, nf_truncated=nf)
        dt = torch.minimum(diag.dt, dt_cool)
        new_state = new_state.replace(dt=dt)
        diag = diag._replace(dt=dt)
        if chem is not None:
            return new_state, diag, chem
        return new_state, diag

    return step
