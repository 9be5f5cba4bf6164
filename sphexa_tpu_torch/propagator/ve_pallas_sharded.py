"""The cell-major VE step on the slab domain: one shard per z-slab.

Counterpart of sphexa_tpu/propagator/ve_pallas_sharded.py
(make_ve_step_pallas_sharded :71, _zplane_maps :56, the zxchg, refresh
and _local_step closures :102-244). The global cell grid is split into
z-plane ranges, one per shard. Each shard bins its owned particles into
a local n x n x nz_local frame whose z-ghost planes come from the
neighbour shards' interior edge planes (one ring exchange a refresh,
the slot-frame analog of the reference's exchangeHalos,
ve_hydro.hpp:156-187). The x-y ghost columns stay local: K1z
(ops/pair_ve.ghost_refresh_xy) rewrites them AFTER the z exchange, so
a corner slot composes both images. The stages, kernels and physics are
the single-device engine's (ve_cellmajor._run_pipeline); only the
refresh changes.

The shards run as threads of one process (domain/mesh.SlabMesh), as the
JAX package runs them under jax.shard_map. A one-plane z halo covers the
2h search radius because the z cell edge obeys the same >= 2 h_max
bound as the grid.

As in the JAX package, the refresh of the five base rows passes no
coordinate rows to K1z (:157-158 with :87-93): the x-y ghost columns of
the position rows get the unshifted source positions, so a periodic x-y
box loses its x-y images in this step (ROADMAP Queue 3 gives the size).
The block-time-step engine (ve_bdt_sharded) passes them.

Self-gravity (gravG != 0) runs after the pair stages on the particle
frame, across the shards (ve_sharded._sharded_gravity with dim=2: the
slab FMM, or the gathered direct or Ewald sum), as the JAX step does
(:170-181): it adds to the accelerations, bounds dt by the acceleration
criterion, adds egrav to etot and its fail-stop count to `lost`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.domain.mesh import ShardComm, SlabMesh
from sphexa_tpu_torch.domain.slab import SlabConfig, migrate
from sphexa_tpu_torch.ops.cellmajor import (CMGrid, _cell_coords_all,
                                            build_layout, from_cm,
                                            interior_mask, to_cm)
from sphexa_tpu_torch.ops.pair_ve import FILL_POS, PairVE, ghost_refresh_xy
from sphexa_tpu_torch.propagator.ve_cellmajor import _masked, _run_pipeline
from sphexa_tpu_torch.propagator.ve_sharded import _sharded_gravity
from sphexa_tpu_torch.sfc.box import Box, Boundary
from sphexa_tpu_torch.sph import timestep as ts
from sphexa_tpu_torch.sph.eos import ideal_gas_cv
from sphexa_tpu_torch.sph.kernels import update_h
from sphexa_tpu_torch.sph.positions import position_update, temp_update
from sphexa_tpu_torch.state import SimState


class PallasShardedDiag(NamedTuple):
    dt: torch.Tensor
    ttot: torch.Tensor
    etot: torch.Tensor
    ecin: torch.Tensor
    eint: torch.Tensor
    lost: torch.Tensor
    n_owned: torch.Tensor
    max_nc: torch.Tensor
    h_max: torch.Tensor
    overflow: torch.Tensor   # cm slot-cap overflow (must stay 0)


def _zplane_maps(grid: CMGrid, device):
    """Slot indices of the four z planes of the exchange: the low and
    high ghost planes and the interior edge planes next to them."""
    cx, cy, cz = _cell_coords_all(grid)
    lane = np.arange(grid.cap)

    def slots(cell_mask):
        cells = np.flatnonzero(cell_mask)
        return torch.tensor((cells[:, None] * grid.cap + lane).reshape(-1),
                            device=device)

    return dict(lo_ghost=slots(cz == 0), lo_edge=slots(cz == 1),
                hi_edge=slots(cz == grid.nz),
                hi_ghost=slots(cz == grid.npz - 1))


def make_zxchg(grid: CMGrid, box: Box, mesh: SlabMesh):
    """zxchg(comm, stack, zrow=-1): fill a [rows, n_slots] stack's z-ghost
    planes from the neighbour shards' edge planes, in place, and return
    it. zrow >= 0 marks the z coordinate row: a periodic z adds -Lz to
    shard 0's left images and +Lz to shard D-1's right images. With an
    open z the outer shards have no neighbour there: coordinate stacks
    get FILL_POS, every other stack 1.0, NOT 0.0 (the frame contract
    wants finite, divide-safe j rows: volj = xm_j / kx_j is 0/0 on zero
    fills). The counterpart of both zxchg closures of the JAX package
    (ve_pallas_sharded.py:102-131, ve_bdt_sharded.make_zxchg :51)."""
    D = mesh.n_slabs
    maps = {d: _zplane_maps(grid, d) for d in set(mesh.devices)}
    periodic_z = box.bz == Boundary.periodic
    lz = float(np.float32(box.lz))

    def zxchg(comm: ShardComm, stack, zrow: int = -1):
        m = maps[comm.device]
        me = comm.me
        from_left, from_right = comm.ring_pair(stack[:, m["hi_edge"]],
                                               stack[:, m["lo_edge"]])
        if zrow >= 0 and periodic_z:
            if me == 0:
                from_left[zrow] -= lz
            if me == D - 1:
                from_right[zrow] += lz
        if not periodic_z:
            kill = FILL_POS if zrow >= 0 else 1.0
            if me == 0:
                from_left = torch.full_like(from_left, kill)
            if me == D - 1:
                from_right = torch.full_like(from_right, kill)
        stack[:, m["lo_ghost"]] = from_left
        stack[:, m["hi_ghost"]] = from_right
        return stack

    return zxchg


def local_frame_z(box: Box, D: int, me: int, z):
    """The z that bins a shard's slab onto the full box, so build_layout
    lands it on [0, nz_local): z_lo = zmin + W * me and (z - z_lo) * D +
    zmin, clipped below zmax, in float32 as the JAX package rounds them
    (ve_pallas_sharded.py:147-149)."""
    W = np.float32(box.lz / D)
    z_lo = float(np.float32(box.zmin) + W * np.float32(me))
    z_fake = (z - z_lo) * float(D) + box.zmin
    return torch.clamp(z_fake, box.zmin, box.zmax - 1e-6 * box.lz)


def make_ve_step_pallas_sharded(box: Box, grid: CMGrid, cfg: SphConfig,
                                sc: SlabConfig, mesh: SlabMesh):
    """grid is the per-shard local grid (n x n x nz_local); the global
    grid is n x n x (nz_local * n_slabs), plane-aligned with the slabs
    of migration. Returns step(states) -> (states, PallasShardedDiag):
    states holds one SimState per shard, on its device; the diagnostics
    are reduced over the shards and live on shard 0's device."""
    D = sc.n_slabs
    if mesh.n_slabs != D:
        raise ValueError(f"mesh of {mesh.n_slabs} shards, SlabConfig of "
                         f"{D} slabs")
    pve = PairVE(grid, cfg)
    box_loc = dataclasses.replace(box, bz=Boundary.open)
    zxchg = make_zxchg(grid, box, mesh)
    intmasks = {d: interior_mask(grid, d) for d in set(mesh.devices)}
    cv = ideal_gas_cv(cfg.mui, cfg.gamma)

    def local_step(comm: ShardComm, state: SimState):
        def refresh(stack, zrow: int = -1):
            return ghost_refresh_xy(zxchg(comm, stack, zrow), grid, box_loc)

        ps, dt_prev = state.p, state.dt
        ps, lost = migrate(comm, ps, box, sc)
        z_fake = local_frame_z(box, D, comm.me, ps.z)
        layout = build_layout(grid, box_loc, ps.x, ps.y, z_fake,
                              alive=ps.alive)
        validint = layout.valid & intmasks[comm.device]

        bstack = refresh(torch.stack(pve.base_rows(layout, ps.x, ps.y, ps.z,
                                                   ps.h)), zrow=2)
        base = [bstack[i] for i in range(5)]

        def cm(f, fill=0.0):
            return to_cm(layout, f, fill)

        jstack = refresh(torch.stack([cm(ps.m), cm(ps.vx), cm(ps.vy),
                                      cm(ps.vz), cm(ps.temp),
                                      cm(ps.alpha)]))
        m, vx, vy, vz, temp, alpha = (jstack[i] for i in range(6))
        out = _run_pipeline(pve, refresh, base, m, vx, vy, vz, temp, alpha,
                            dt_prev, validint)

        # ---- integrate and gather back to the particle frame ----
        def back(f, fill=0.0):
            return from_cm(layout, f, ps.n, fill)

        ax_p, ay_p, az_p = back(out["ax"]), back(out["ay"]), back(out["az"])
        egrav = torch.zeros((), dtype=torch.float32, device=ps.x.device)
        if cfg.gravG != 0.0:
            gax, gay, gaz, egrav, govf = _sharded_gravity(comm, ps, box,
                                                          cfg, dim=2)
            lost = lost + govf
            ax_p, ay_p, az_p = ax_p + gax, ay_p + gay, az_p + gaz

        dt_local = torch.minimum(
            ts.courant_timestep(out["maxvsignal"], out["h"], out["c"],
                                validint, cfg.kcour),
            ts.rho_timestep(out["divv"], validint, cfg.krho))
        if cfg.gravG != 0.0:
            dt_local = torch.minimum(dt_local, ts.acceleration_timestep(
                ax_p, ay_p, az_p, ps.alive, cfg.eta_acc, cfg.eps))
        dt = comm.pmin(torch.minimum(cfg.max_dt_increase * dt_prev,
                                     dt_local))
        h_back = back(out["h"], 1.0)
        x, y, z, vxn, vyn, vzn, dx, dy, dz = position_update(
            dt, dt_prev, ps.x, ps.y, ps.z, ax_p, ay_p, az_p, ps.x_m1,
            ps.y_m1, ps.z_m1, box, h=h_back, vx=ps.vx, vy=ps.vy, vz=ps.vz)
        du = back(out["du"])
        temp_n = temp_update(ps.temp, dt, dt_prev, du, ps.du_m1, cfg.mui,
                             cfg.gamma)
        h_n = update_h(cfg.ng0, back(out["nc_sph"], 1.0), h_back)
        ps = ps.replace(x=x, y=y, z=z, vx=vxn, vy=vyn, vz=vzn, x_m1=dx,
                        y_m1=dy, z_m1=dz, temp=temp_n,
                        h=torch.where(ps.alive, h_n, 1.0), du_m1=du,
                        alpha=back(out["alpha"], cfg.alphamin))

        # ---- diagnostics, reduced in shard order ----
        alive = ps.alive
        ecin = comm.psum(0.5 * torch.sum(_masked(
            ps.m * (ps.vx ** 2 + ps.vy ** 2 + ps.vz ** 2), alive)))
        eint = comm.psum(torch.sum(_masked(ps.m * cv * ps.temp, alive)))
        ttot = state.ttot + dt
        diag = PallasShardedDiag(
            dt=dt, ttot=ttot, etot=ecin + eint + egrav, ecin=ecin,
            eint=eint,
            lost=comm.psum(lost),
            n_owned=comm.psum(torch.sum(alive, dtype=torch.int32)),
            max_nc=comm.pmax(torch.max(_masked(out["nc_sph"] - 1.0,
                                               validint))).to(torch.int32),
            h_max=comm.pmax(torch.max(_masked(ps.h, alive))),
            overflow=comm.psum(layout.overflow.to(torch.int32)))
        new = SimState(p=ps, ttot=ttot, dt=dt, dt_m1=state.dt,
                       iteration=state.iteration + 1)
        return new, diag

    def step(states):
        res = mesh.run(local_step, states)
        return [r[0] for r in res], res[0][1]

    return step
