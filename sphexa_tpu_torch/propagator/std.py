"""std-SPH propagator on the gather path: density -> EOS -> IAD ->
momentum+energy (reference: main/src/propagator/std_hydro.hpp:100-170).

Counterpart of sphexa_tpu/propagator/std.py (make_std_step): plain
PyTorch, eager, as propagator/ve.py; the step has no rho timestep (no
divv) and no gravity, as the JAX step.
"""

from __future__ import annotations

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.neighbors import (CellGrid, build_cell_list,
                                        build_neighbor_list)
from sphexa_tpu_torch.propagator.common import finish_step
from sphexa_tpu_torch.sfc.box import Box
from sphexa_tpu_torch.sph import hydro_std
from sphexa_tpu_torch.sph.eos import eos_std
from sphexa_tpu_torch.state import SimState
from sphexa_tpu_torch.util.device import resolve_device


def make_std_step(box: Box, grid: CellGrid, cfg: SphConfig, device=None):
    """step(state) -> (state, StepDiagnostics) on `device` (default: the
    GPU); the state must live there."""
    device = resolve_device(device)

    def step(state: SimState):
        if state.p.device != device:
            raise ValueError(f"state on {state.p.device}, step built for "
                             f"{device}")
        ps = state.p
        cl = build_cell_list(grid, box, ps.x, ps.y, ps.z, alive=ps.alive)
        ps = ps.permute(cl.perm)
        nl = build_neighbor_list(grid, box, cl, ps.x, ps.y, ps.z, ps.h, cfg,
                                 adapt_h=True, alive=ps.alive)
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

        return finish_step(state, ps, me.ax, me.ay, me.az, me.du,
                           me.maxvsignal, c, None, nl.nc_sph, box, cfg,
                           max_nc=nl.max_nc, max_cell_count=nl.max_cell_count)

    return step
