"""The VE step on the Hilbert load-balanced domain (--prop ve-hilbert).

Counterpart of sphexa_tpu/propagator/ve_hilbert.py (reference:
main/src/propagator/ve_hydro.hpp:132-205 under MPI): each shard syncs
its domain (domain/facade.Domain: Hilbert-quantile ranges recomputed
every step, one-hop all_to_all migration, coarse-grid halo discovery to
any peer), runs the five VE pair stages of the gather path
(sph/hydro_ve.py, plain PyTorch as the JAX step is plain XLA) on its
cell-sorted extended frame, with the halo refreshes at the reference's
exchange points, adds the cross-shard self-gravity (the generic sharded
FMM, or the gathered direct or Ewald sum), integrates its owned rows
and packs them back into its [cap] frame.

The shards are SlabMesh threads. A state is a list of one SimState a
shard; the diagnostics are reduced over the shards.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.domain.facade import Domain
from sphexa_tpu_torch.domain.hilbert import HilbertConfig, hilbert_keys
from sphexa_tpu_torch.domain.mesh import ShardComm, SlabMesh
from sphexa_tpu_torch.domain.slab import _pack
from sphexa_tpu_torch.neighbors import CellGrid
from sphexa_tpu_torch.propagator.ve_cellmajor import _masked
from sphexa_tpu_torch.propagator.ve_sharded import _sharded_gravity
from sphexa_tpu_torch.sfc.box import Box
from sphexa_tpu_torch.sph import hydro_ve
from sphexa_tpu_torch.sph import timestep as ts
from sphexa_tpu_torch.sph.eos import eos_ve, ideal_gas_cv
from sphexa_tpu_torch.sph.kernels import update_h
from sphexa_tpu_torch.sph.positions import position_update, temp_update
from sphexa_tpu_torch.state import _FIELDS, Particles, SimState


class HilbertDiag(NamedTuple):
    dt: torch.Tensor
    ttot: torch.Tensor
    etot: torch.Tensor
    ecin: torch.Tensor
    eint: torch.Tensor
    lost: torch.Tensor       # migration + halo + gravity-band losses (0)
    n_owned: torch.Tensor    # total alive particles (conservation check)
    max_nc: torch.Tensor
    h_max: torch.Tensor
    imbalance: torch.Tensor  # max shard load / ideal load
    halo_frac: torch.Tensor  # r_halo / (dilate * coarse cell edge), <= 1
    # the densest cell of any shard's extended frame against cell_cap
    # (the gather step's fail-stop; the JAX HilbertDiag lacks it, so a
    # JAX run past cell_cap drops candidates silently: ROADMAP Queue 3)
    max_cell_count: torch.Tensor


def pack_owned(exts: Particles, valid, cap: int) -> tuple:
    """Compact the owned alive rows of an extended frame into the [cap]
    owned frame. Returns (particles, count)."""
    packed, n_own = _pack(valid, [getattr(exts, f) for f in _FIELDS[:-1]],
                          cap)
    alive = torch.arange(cap, device=valid.device) < n_own
    cols = dict(zip(_FIELDS[:-1], packed))
    cols["h"] = torch.where(alive, cols["h"], 1.0)
    return Particles(alive=alive, **cols), n_own


def _local_step(comm: ShardComm, ps: Particles, dt_prev, box: Box,
                grid: CellGrid, cfg: SphConfig, hc: HilbertConfig):
    """One step of one shard. Returns (owned frame, dt, HilbertDiag)."""
    sr = Domain(box, grid, cfg, hc).sync(comm, ps)
    ps = sr.ps
    exts, owned, nl, refresh = sr.exts, sr.owned, sr.nl, sr.refresh
    r_halo = 2.0 * sr.h_max * 1.3   # slack for in-step h growth
    x, y, z, h = exts.x, exts.y, exts.z, exts.h
    idx, nc = nl.idx, nl.nc

    # ---- pair stages with the reference-placed halo refreshes ----
    xm = hydro_ve.compute_xmass(box, x, y, z, h, exts.m, idx, nc, cfg)
    (xm,) = refresh((xm,))
    kx, gradh = hydro_ve.compute_ve_def_gradh(box, x, y, z, h, exts.m, xm,
                                              idx, nc, cfg)
    rho, p, c, prho = eos_ve(exts.temp, exts.m, kx, xm, gradh, cfg.mui,
                             cfg.gamma)
    kx, prho, c = refresh((kx, prho, c))
    iad = hydro_ve.compute_iad_divv_curlv(box, x, y, z, exts.vx, exts.vy,
                                          exts.vz, h, kx, xm, idx, nc, cfg)
    cij = refresh((iad.c11, iad.c12, iad.c13, iad.c22, iad.c23, iad.c33,
                   iad.divv))
    divv, cij = cij[6], cij[:6]
    alpha = hydro_ve.compute_av_switches(box, x, y, z, exts.vx, exts.vy,
                                         exts.vz, h, c, kx, xm, divv, cij,
                                         exts.alpha, dt_prev, idx, nc, cfg)
    (alpha,) = refresh((torch.where(owned, alpha, exts.alpha),))
    exts = exts.replace(alpha=alpha)
    me = hydro_ve.compute_momentum_energy(box, x, y, z, exts.vx, exts.vy,
                                          exts.vz, h, exts.m, prho, c, cij,
                                          kx, xm, alpha, idx, nc, cfg)
    ax, ay, az = me.ax, me.ay, me.az
    dev = x.device
    egrav = torch.zeros((), dtype=torch.float32, device=dev)
    govf = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.gravG != 0.0:
        # the generic sharded FMM (any domain shape); the owned rows of
        # the extended frame carry its accelerations
        gax, gay, gaz, egrav, govf = _sharded_gravity(comm, ps, box, cfg)

        def ext_rows(v):
            return torch.cat([v, v.new_zeros(hc.ext - hc.cap)])[sr.perm]

        ax, ay, az = ax + ext_rows(gax), ay + ext_rows(gay), \
            az + ext_rows(gaz)

    # ---- global timestep (MPI_Allreduce MIN -> pmin) ----
    valid = owned & exts.alive
    cands = [ts.courant_timestep(me.maxvsignal, h, c, valid, cfg.kcour),
             ts.rho_timestep(iad.divv, valid, cfg.krho)]
    if cfg.gravG != 0.0:
        cands.append(ts.acceleration_timestep(ax, ay, az, valid,
                                              cfg.eta_acc, cfg.eps))
    dt = comm.pmin(torch.minimum(cfg.max_dt_increase * dt_prev,
                                 torch.stack(cands).min()))

    # ---- integrate the owned rows ----
    xn, yn, zn, vxn, vyn, vzn, dxn, dyn, dzn = position_update(
        dt, dt_prev, exts.x, exts.y, exts.z, ax, ay, az, exts.x_m1,
        exts.y_m1, exts.z_m1, box, h=h, vx=exts.vx, vy=exts.vy, vz=exts.vz)
    temp = temp_update(exts.temp, dt, dt_prev, me.du, exts.du_m1, cfg.mui,
                       cfg.gamma)
    exts = exts.replace(x=xn, y=yn, z=zn, vx=vxn, vy=vyn, vz=vzn, x_m1=dxn,
                        y_m1=dyn, z_m1=dzn, temp=temp,
                        h=update_h(cfg.ng0, nl.nc_sph, h), du_m1=me.du)
    ps_new, n_own = pack_owned(exts, valid, hc.cap)

    # ---- diagnostics ----
    cv = ideal_gas_cv(cfg.mui, cfg.gamma)
    ecin = comm.psum(0.5 * torch.sum(_masked(
        exts.m * (vxn ** 2 + vyn ** 2 + vzn ** 2), valid)))
    eint = comm.psum(torch.sum(_masked(exts.m * cv * temp, valid)))
    diag = HilbertDiag(
        dt=dt, ttot=torch.zeros_like(dt), etot=ecin + eint + egrav,
        ecin=ecin, eint=eint, lost=comm.psum(sr.lost) + govf,
        n_owned=comm.psum(n_own), max_nc=comm.pmax(nl.max_nc),
        h_max=sr.h_max, imbalance=sr.imbalance,
        halo_frac=r_halo / (hc.dilate * min(box.lx, box.ly, box.lz)
                            / hc.coarse),
        max_cell_count=comm.pmax(nl.max_cell_count))
    return ps_new, dt, diag


def make_ve_step_hilbert(box: Box, grid: CellGrid, cfg: SphConfig,
                         hc: HilbertConfig, mesh: SlabMesh):
    """step(states) -> (states, HilbertDiag): one SimState a shard (its
    [cap] owned frame, on its device); the diagnostics come from shard
    0, reduced over the shards."""
    if mesh.n_slabs != hc.n_ranks:
        raise ValueError(f"mesh of {mesh.n_slabs} shards, HilbertConfig of "
                         f"{hc.n_ranks} ranks")

    def local(comm, state: SimState):
        ps, dt, diag = _local_step(comm, state.p, state.dt, box, grid, cfg,
                                   hc)
        ttot = state.ttot + dt
        return (SimState(p=ps, ttot=ttot, dt=dt, dt_m1=state.dt,
                         iteration=state.iteration + 1),
                diag._replace(ttot=ttot))

    def step(states):
        res = mesh.run(local, states)
        return [r[0] for r in res], res[0][1]

    return step


def distribute_hilbert(ps_host: dict, box: Box, hc: HilbertConfig,
                       mesh: SlabMesh) -> list:
    """Host-side initial distribution: sort by Hilbert key (stable),
    cut into n_ranks equal counts, pad each to cap. ps_host maps field
    -> numpy array of the alive particles. Returns one Particles a
    shard, on its device."""
    cols = {f: np.asarray(ps_host[f], np.float32) for f in _FIELDS[:-1]}
    keys = hilbert_keys(box, *(torch.from_numpy(cols[c]) for c in "xyz"))
    order = np.argsort(keys.numpy(), kind="stable")
    n = len(order)
    bounds = [int(round(n * d / hc.n_ranks)) for d in range(hc.n_ranks + 1)]
    shards = []
    for d in range(hc.n_ranks):
        sel = order[bounds[d]:bounds[d + 1]]
        if len(sel) > hc.cap:
            raise ValueError(f"rank {d} holds {len(sel)} > cap {hc.cap}")
        pad = hc.cap - len(sel)
        dev = mesh.devices[d]
        t = {f: torch.from_numpy(np.concatenate(
            [cols[f][sel], np.full(pad, 1.0 if f == "h" else 0.0,
                                   np.float32)])).to(dev)
             for f in _FIELDS[:-1]}
        shards.append(Particles(
            alive=torch.arange(hc.cap, device=dev) < len(sel), **t))
    return shards
