"""h-tier zoom grids over the Hilbert load-balanced domain
(--prop ve-tiered-sharded).

Counterpart of sphexa_tpu/propagator/ve_tiered_sharded.py (the
distributed focused octree: the focus tree and LET on the full MPI
domain, domain/include/cstone/focus/octree_focus_mpi.hpp:51 with
domain.hpp:196 sync):

  - particles are Hilbert-quantile balanced, migrated and halo-exchanged
    as in ve_hilbert (domain/hilbert.py); the tiers compose above;
  - every shard holds the GLOBAL tier set (planned once from the whole
    state) and bins only its owned and halo rows into each tier's grid;
  - each tier runs the gated stages (K2g on the card): a z-supercell
    holding no row of this shard is skipped, so each shard pays for its
    own occupancy of the global tier grids;
  - stage results cross shards through the halo refresh at the
    reference's exchangeHalos points (_tiered_forces' refresh hook),
    and cross tiers through the owner merge;
  - self-gravity: the generic sharded FMM (ve_sharded._sharded_gravity).

Fail-stops: migration and halo losses (`lost`), and the tier fold (slot
overflow, unowned rows, owner-frame misses, h clamps past the budget),
psum'd; a nonzero fold re-tiers at the host boundary.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.domain.facade import imbalance_of
from sphexa_tpu_torch.domain.hilbert import (HilbertConfig, balance_splits,
                                             exchange_halos, hilbert_keys,
                                             migrate, refresh_halo_fields)
from sphexa_tpu_torch.domain.mesh import ShardComm, SlabMesh
from sphexa_tpu_torch.propagator.ve_cellmajor import _masked
from sphexa_tpu_torch.propagator.ve_hilbert import pack_owned
from sphexa_tpu_torch.propagator.ve_sharded import _sharded_gravity
from sphexa_tpu_torch.propagator.ve_tiered import (_build_layouts,
                                                   _tier_engines,
                                                   _tiered_forces)
from sphexa_tpu_torch.sfc.box import Box
from sphexa_tpu_torch.sph import timestep as ts
from sphexa_tpu_torch.sph.eos import ideal_gas_cv
from sphexa_tpu_torch.sph.kernels import update_h
from sphexa_tpu_torch.sph.positions import position_update, temp_update
from sphexa_tpu_torch.state import SimState

_I32 = torch.int32


class TieredShardDiag(NamedTuple):
    dt: torch.Tensor
    ttot: torch.Tensor
    etot: torch.Tensor
    ecin: torch.Tensor
    eint: torch.Tensor
    lost: torch.Tensor       # migration + halo + gravity-band losses (0)
    n_owned: torch.Tensor    # global alive count (conservation)
    fold: torch.Tensor       # tier overflow + unowned + clamp + miss (psum)
    max_nc: torch.Tensor
    h_max: torch.Tensor
    imbalance: torch.Tensor


def _local_step(comm: ShardComm, ps, dt_prev, box: Box, engines,
                cfg: SphConfig, hc: HilbertConfig):
    """One step of one shard: balance, migrate, halos (no cell list: the
    tier layouts replace it), the tiered stages on the extended frame,
    gravity, integration of the owned rows."""
    keys = hilbert_keys(box, ps.x, ps.y, ps.z)
    splits = balance_splits(comm, keys, ps.alive, hc)
    ps, lost_mig, n_own0 = migrate(comm, ps, box, splits, hc)
    imbalance = imbalance_of(comm, n_own0, hc)
    exts, maps = exchange_halos(comm, ps, box, hc)
    dev = ps.x.device
    owned = torch.cat([ps.alive, torch.zeros(hc.ext - hc.cap,
                                             dtype=torch.bool, device=dev)])

    def refresh(d: dict) -> dict:
        names = list(d)
        return dict(zip(names, refresh_halo_fields(
            comm, tuple(d[k] for k in names), maps, hc)))

    layouts = _build_layouts(engines, box, exts)
    fo = _tiered_forces(exts, dt_prev, layouts, engines, box, cfg,
                        refresh=refresh, owned=owned)
    ax, ay, az = fo["ax"], fo["ay"], fo["az"]
    egrav = torch.zeros((), dtype=torch.float32, device=dev)
    govf = torch.zeros((), dtype=_I32, device=dev)
    if cfg.gravG != 0.0:
        gax, gay, gaz, egrav, govf = _sharded_gravity(comm, ps, box, cfg)

        def ext_rows(v):
            return torch.cat([v, v.new_zeros(hc.ext - hc.cap)])

        ax, ay, az = ax + ext_rows(gax), ay + ext_rows(gay), \
            az + ext_rows(gaz)

    # ---- global timestep (pmin: the MPI_Allreduce MIN) ----
    valid = owned & exts.alive
    cands = [ts.courant_timestep(fo["maxvsignal"], fo["h"], fo["c"], valid,
                                 cfg.kcour),
             ts.rho_timestep(fo["divv"], valid, cfg.krho)]
    if cfg.gravG != 0.0:
        cands.append(ts.acceleration_timestep(ax, ay, az, valid,
                                              cfg.eta_acc, cfg.eps))
    dt = comm.pmin(torch.minimum(cfg.max_dt_increase * dt_prev,
                                 torch.stack(cands).min()))

    # ---- integrate the owned rows ----
    xn, yn, zn, vxn, vyn, vzn, dxn, dyn, dzn = position_update(
        dt, dt_prev, exts.x, exts.y, exts.z, ax, ay, az, exts.x_m1,
        exts.y_m1, exts.z_m1, box, h=fo["h"], vx=exts.vx, vy=exts.vy,
        vz=exts.vz)
    temp = temp_update(exts.temp, dt, dt_prev, fo["du"], exts.du_m1,
                       cfg.mui, cfg.gamma)
    h_new = update_h(cfg.ng0, fo["nc_sph"], fo["h"])
    exts = exts.replace(x=xn, y=yn, z=zn, vx=vxn, vy=vyn, vz=vzn, x_m1=dxn,
                        y_m1=dyn, z_m1=dzn, temp=temp, h=h_new,
                        du_m1=fo["du"], alpha=fo["alpha"])
    ps_new, n_own = pack_owned(exts, valid, hc.cap)

    # ---- diagnostics ----
    cv = ideal_gas_cv(cfg.mui, cfg.gamma)
    ecin = comm.psum(0.5 * torch.sum(_masked(
        exts.m * (vxn ** 2 + vyn ** 2 + vzn ** 2), valid)))
    eint = comm.psum(torch.sum(_masked(exts.m * cv * temp, valid)))
    diag = TieredShardDiag(
        dt=dt, ttot=torch.zeros_like(dt), etot=ecin + eint + egrav,
        ecin=ecin, eint=eint,
        lost=comm.psum(lost_mig + maps.send_lost) + govf,
        n_owned=comm.psum(n_own), fold=comm.psum(fo["fold"].to(_I32)),
        max_nc=comm.pmax(torch.max(_masked(fo["nc_sph"] - 1.0, valid))),
        h_max=comm.pmax(torch.max(_masked(h_new, valid))),
        imbalance=imbalance)
    return ps_new, dt, diag


def make_ve_step_tiered_hilbert(box: Box, tiers, cfg: SphConfig,
                                hc: HilbertConfig, mesh: SlabMesh):
    """step(states) -> (states, TieredShardDiag) over one SimState a
    shard ([cap] owned frames). The tiers' h bounds must cover the field,
    or rows count as unowned (the fold). Each tier's stages are gated
    (K2g), on every shard's device."""
    if mesh.n_slabs != hc.n_ranks:
        raise ValueError(f"mesh of {mesh.n_slabs} shards, HilbertConfig of "
                         f"{hc.n_ranks} ranks")
    engines = {d: _tier_engines(tiers, cfg, d, gated=True)
               for d in set(mesh.devices)}

    def local(comm, state: SimState):
        ps, dt, diag = _local_step(comm, state.p, state.dt, box,
                                   engines[comm.device], cfg, hc)
        ttot = state.ttot + dt
        return (SimState(p=ps, ttot=ttot, dt=dt, dt_m1=state.dt,
                         iteration=state.iteration + 1),
                diag._replace(ttot=ttot))

    def step(states):
        res = mesh.run(local, states)
        return [r[0] for r in res], res[0][1]

    return step
