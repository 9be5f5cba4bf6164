"""The VE gather step on the slab domain, the host-side set-up of the
slab-sharded engines (distribution of the particles into slabs, the
slab planner) and the self-gravity of every sharded engine.

Counterpart of sphexa_tpu/propagator/ve_sharded.py: ShardedDiag (:33),
_local_step (:48), make_ve_step_sharded (:172), distribute (:196-234)
and _sharded_gravity (:237-310); and of `MultiChipAdapter._slab_setup`
in sphexa_tpu/propagator/multichip.py (:243-300), as the host function
plan_slab.

make_ve_step_sharded is the single-device gather step (propagator/ve)
on each shard's slab, the reference's ve_hydro.hpp:132-205 under MPI:
migrate to the +-1 neighbours, extend the frame by the neighbours' halo
bands within r_halo = 2.6 h_max (domain/slab.exchange_halos), cell-sort
the extended frame, build the neighbour lists (the halo rows keep their
exchanged h, the owners' adapted h is refreshed into them), run the
five gather stages (sph/hydro_ve, plain PyTorch, as the JAX step is
plain XLA) with the halo refreshes at the reference's exchange points,
add the slab FMM (dim=2) under gravity, take the global dt by pmin,
integrate, and pack the owned rows back into the [cap] frame. The
neighbour search runs over the extended frame's alive rows (owned and
halo, as the JAX step searches them); the dead padding rows get a dead
row's outputs in both.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.domain.mesh import ShardComm, SlabMesh
from sphexa_tpu_torch.domain.slab import (SlabConfig, _pack, exchange_halos,
                                          migrate, refresh_halo_fields)
from sphexa_tpu_torch.neighbors import (CellGrid, build_cell_list,
                                        build_neighbor_list)
from sphexa_tpu_torch.ops.cellmajor import CMGrid, choose_cm_grid
from sphexa_tpu_torch.ops.pair_ve import MAX_CAP
from sphexa_tpu_torch.sfc.box import Box
from sphexa_tpu_torch.sph import hydro_ve
from sphexa_tpu_torch.sph import timestep as ts
from sphexa_tpu_torch.sph.eos import eos_ve, ideal_gas_cv
from sphexa_tpu_torch.sph.kernels import update_h
from sphexa_tpu_torch.sph.positions import position_update, temp_update
from sphexa_tpu_torch.state import _FIELDS, Particles, SimState


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class ShardedDiag(NamedTuple):
    dt: torch.Tensor
    ttot: torch.Tensor
    etot: torch.Tensor
    ecin: torch.Tensor
    eint: torch.Tensor
    lost: torch.Tensor       # migration (+ gravity band) losses, 0
    n_owned: torch.Tensor    # total alive particles (conservation check)
    max_nc: torch.Tensor
    h_max: torch.Tensor
    halo_frac: torch.Tensor  # r_halo / slab width; < 1 for the +-1
                             # halo exchange to be complete
    # the densest cell of any shard's extended frame against cell_cap
    # (the gather step's fail-stop; the JAX ShardedDiag lacks it)
    max_cell_count: torch.Tensor


def _local_step(comm: ShardComm, ps: Particles, dt_prev, box: Box,
                grid: CellGrid, cfg: SphConfig, sc: SlabConfig):
    """One step of one shard. Returns (owned frame, dt, ShardedDiag)."""
    # ---- domain sync: migration and the halo bands ----
    ps, lost = migrate(comm, ps, box, sc)
    h_max = comm.pmax(torch.max(torch.where(ps.alive, ps.h, 0.0)))
    r_halo = 2.0 * h_max * 1.3   # slack for in-step h growth
    ext, maps = exchange_halos(comm, ps, box, sc, r_halo)
    dev = ps.x.device
    owned_ext = torch.cat([ps.alive, torch.zeros(2 * sc.halo_cap,
                                                 dtype=torch.bool,
                                                 device=dev)])

    # ---- cell sort of the extended frame ----
    cl = build_cell_list(grid, box, ext.x, ext.y, ext.z, alive=ext.alive)
    perm = cl.perm.to(torch.int64)
    exts = ext.permute(perm)
    owned = owned_ext[perm]
    inv_perm = torch.empty_like(perm)
    inv_perm[perm] = torch.arange(sc.ext, device=dev)

    nl = build_neighbor_list(grid, box, cl, exts.x, exts.y, exts.z, exts.h,
                             cfg, adapt_h=True, alive=exts.alive,
                             rows=torch.nonzero(exts.alive).reshape(-1))

    def refresh(fields):
        return refresh_halo_fields(comm, fields, maps, sc, inv_perm=inv_perm)

    # halo rows have incomplete neighbourhoods: keep their exchanged h
    # and pull the owners' adapted values
    (h,) = refresh((torch.where(owned, nl.h, exts.h),))
    exts = exts.replace(h=h)
    x, y, z = exts.x, exts.y, exts.z
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
    egrav = torch.zeros((), dtype=torch.float32, device=dev)
    if cfg.gravG != 0.0:
        # the slab FMM (or the gathered direct or Ewald sum) over the
        # owned frame; its rows sit at the extended frame's first cap
        gax, gay, gaz, egrav, govf = _sharded_gravity(comm, ps, box, cfg,
                                                      dim=2)
        lost = lost + govf

        def ext_rows(v):
            return torch.cat([v, v.new_zeros(2 * sc.halo_cap)])[perm]

        ax, ay, az = ax + ext_rows(gax), ay + ext_rows(gay), \
            az + ext_rows(gaz)

    # ---- global timestep: local minima, then pmin ----
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

    # ---- compact the owned alive rows back into the [cap] frame ----
    packed, n_own = _pack(valid, [getattr(exts, f) for f in _FIELDS[:-1]],
                          sc.cap)
    alive = torch.arange(sc.cap, device=dev) < n_own
    cols = dict(zip(_FIELDS[:-1], packed))
    cols["h"] = torch.where(alive, cols["h"], 1.0)
    ps_new = Particles(alive=alive, **cols)

    # ---- diagnostics (psum = MPI_Allreduce SUM) ----
    cv = ideal_gas_cv(cfg.mui, cfg.gamma)
    ecin = comm.psum(0.5 * torch.sum(torch.where(
        valid, exts.m * (vxn ** 2 + vyn ** 2 + vzn ** 2), 0.0)))
    eint = comm.psum(torch.sum(torch.where(valid, exts.m * cv * temp, 0.0)))
    diag = ShardedDiag(
        dt=dt, ttot=torch.zeros_like(dt), etot=ecin + eint + egrav,
        ecin=ecin, eint=eint, lost=comm.psum(lost), n_owned=comm.psum(n_own),
        max_nc=comm.pmax(nl.max_nc), h_max=h_max,
        halo_frac=r_halo / (box.lz / sc.n_slabs),
        max_cell_count=comm.pmax(nl.max_cell_count))
    return ps_new, dt, diag


def make_ve_step_sharded(box: Box, grid: CellGrid, cfg: SphConfig,
                         sc: SlabConfig, mesh: SlabMesh):
    """step(states) -> (states, ShardedDiag): one SimState a shard (its
    [cap] owned frame, on its device, as `distribute` gives it); the
    diagnostics come from shard 0, reduced over the shards. `grid` is
    the gather path's global cell grid."""
    if mesh.n_slabs != sc.n_slabs:
        raise ValueError(f"mesh of {mesh.n_slabs} shards, SlabConfig of "
                         f"{sc.n_slabs} slabs")

    def local(comm, state: SimState):
        ps, dt, diag = _local_step(comm, state.p, state.dt, box, grid, cfg,
                                   sc)
        ttot = state.ttot + dt
        return (SimState(p=ps, ttot=ttot, dt=dt, dt_m1=state.dt,
                         iteration=state.iteration + 1),
                diag._replace(ttot=ttot))

    def step(states):
        res = mesh.run(local, states)
        return [r[0] for r in res], res[0][1]

    return step


def distribute(ps_host: dict, box: Box, sc: SlabConfig, mesh: SlabMesh,
               extras: dict | None = None):
    """Bin particles into slabs by z and pad each slab to cap. ps_host
    maps field -> numpy array (the alive particles). Returns one
    Particles per shard, on that shard's device; with `extras` (name ->
    array, further payload columns binned the same way) also a dict
    name -> per-shard tensors."""
    if mesh.n_slabs != sc.n_slabs:
        raise ValueError(f"mesh of {mesh.n_slabs} shards, SlabConfig of "
                         f"{sc.n_slabs} slabs")
    z = np.asarray(ps_host["z"], np.float64)
    slab = np.clip(((z - box.zmin) / (box.lz / sc.n_slabs)).astype(np.int64),
                   0, sc.n_slabs - 1)
    cols = dict(ps_host)
    cols.update(extras or {})
    names = list(_FIELDS[:-1]) + list((extras or {}).keys())
    shards, ext = [], {k: [] for k in (extras or {})}
    for s in range(sc.n_slabs):
        sel = np.flatnonzero(slab == s)
        if len(sel) > sc.cap:
            raise ValueError(f"slab {s} holds {len(sel)} > cap {sc.cap}")
        pad = sc.cap - len(sel)
        dev = mesh.devices[s]
        t = {}
        for f in names:
            arr = np.asarray(cols[f], np.float32)[sel]
            fill = 1.0 if f == "h" else 0.0
            t[f] = torch.from_numpy(np.concatenate(
                [arr, np.full(pad, fill, np.float32)])).to(dev)
        alive = torch.arange(sc.cap, device=dev) < len(sel)
        shards.append(Particles(alive=alive, **{f: t[f]
                                                for f in _FIELDS[:-1]}))
        for k in ext:
            ext[k].append(t[k])
    if extras is None:
        return shards
    return shards, ext


def plan_slab(host: dict, box: Box, h_max: float, n_slabs: int,
              cap_max: int = MAX_CAP):
    """Slab-domain sizing of the slab-sharded engines (the JAX adapter's
    _slab_setup): halve n_slabs while a slab is thinner than 2 h_max
    (the one-plane z exchange must cover the search radius), the global
    grid of choose_cm_grid split into n // D z-planes a shard, the cell
    cap from the measured occupancy, and the slab caps from the measured
    slab counts. host: numpy arrays of the alive particles. Returns
    (local grid, SlabConfig); the SlabConfig's n_slabs is the D used.

    cap_max (the pair kernels' ceiling MAX_CAP by default): at caps
    within it the plan is the JAX rule's (at Evrard 100, D = 2,
    CMGrid(n=18, cap=1664, nzi=9)). Only where the JAX rule's cap
    exceeds it, which the JAX rule does not check, are the finer grids
    that the 2 h_max bound still allows measured and the finest within
    it taken (with the 1.3 margin if one fits, else a headroom of 8
    rows); none raises RuntimeError (a slab too thin for 2 h_max at
    D = 2 raises ValueError)."""
    D = n_slabs
    while D > 1 and box.lz / D < 2.0 * h_max * 1.05:
        D //= 2
    if D < 2:
        raise ValueError(f"slab width {box.lz:.4g}/D < 2*h_max "
                         f"{2 * h_max:.4g} even at D=2: problem too small "
                         f"for the slab-sharded engine")
    n_global = len(host["x"])
    n_per = n_global / D

    def measure(n):
        """(z planes a shard, the densest cell's count) on n x n x D nz."""
        nz_local = max(n // D, 1)
        if box.lz / (D * nz_local) < 2.0 * h_max:
            nz_local = max(int(box.lz / D / (2.0 * h_max * 1.05)), 1)
        gx = np.clip(((host["x"] - box.xmin) / box.lx * n)
                     .astype(np.int64), 0, n - 1)
        gy = np.clip(((host["y"] - box.ymin) / box.ly * n)
                     .astype(np.int64), 0, n - 1)
        gz = np.clip(((host["z"] - box.zmin) / box.lz * D * nz_local)
                     .astype(np.int64), 0, D * nz_local - 1)
        cell = (gx * n + gy) * (D * nz_local) + gz
        return nz_local, int(np.bincount(cell).max())

    n = choose_cm_grid(box, h_max * 1.25, n_global).n
    nz_local, max_occ = measure(n)
    cap_cm = max(128, round_up(int(max_occ * 1.3) + 8, 128))
    if cap_cm > cap_max:
        # past the kernels' ceiling only: finer grids within
        # choose_cm_grid's 2 h_max bound on the cell edge, the finest
        # whose cap fits, with the 1.3 margin if one does, else with the
        # single-device planner's headroom of 8
        L = min(box.lx, box.ly, box.lz)
        n_corr = max(1, int(np.floor(L / (2.0 * h_max * 1.25 * 1.05))))
        counts = {m: measure(m) for m in range(n, n_corr + 1)}
        fits = []
        for margin in (1.3, 1.0):
            fits = [(m, max(128, round_up(int(c * margin) + 8, 128)))
                    for m, (_, c) in sorted(counts.items(), reverse=True)]
            fits = [f for f in fits if f[1] <= cap_max]
            if fits:
                break
        if not fits:
            raise RuntimeError(
                f"the densest slot cell needs cap {cap_cm} > {cap_max} at "
                f"every grid the 2 h_max bound allows ({n}..{n_corr} a "
                f"side): too clustered for the slab-sharded engines")
        n, cap_cm = fits[0]
        nz_local = counts[n][0]
    grid = CMGrid(n=n, cap=cap_cm, nzi=nz_local)

    # binned in the host arrays' own type, as the adapter does
    slab = np.clip(((host["z"] - box.zmin) / (box.lz / D))
                   .astype(np.int64), 0, D - 1)
    max_cnt = int(np.bincount(slab, minlength=D).max())
    sc = SlabConfig(
        n_slabs=D, cap=round_up(int(max_cnt * 1.5) + 64, 8),
        halo_cap=round_up(int(max_cnt * 0.6) + 64, 8),
        mig_cap=round_up(max(int(n_per * 0.25), 128), 8))
    return grid, sc


def _sharded_gravity(comm: ShardComm, ps, box: Box, cfg: SphConfig,
                     dim: int | None = None):
    """Self-gravity across the shards, inside SlabMesh.run. `ps` has x,
    y, z, m and alive rows of the same length on every shard. Returns
    (ax, ay, az, egrav, ovf): egrav and the fail-stop count ovf
    (near-field truncation + band overflow, must stay 0) are psum'd.

    The FMM solver with `dim` set (z-slabs) runs fmm_gravity_sharded,
    its level raised to min_level_for_bands(D) so the +-rings bands
    cover the near field; with `dim` None (Hilbert ranges) it runs
    fmm_gravity_sharded_generic with cfg.gravity_band_cap. The direct
    and Ewald solvers all_gather every shard's rows and evaluate the
    whole set (O(N) a shard), each shard keeping its own rows."""
    from sphexa_tpu_torch.gravity import fmm
    alive = ps.alive

    def energy(pot):
        return comm.psum(0.5 * torch.sum(torch.where(alive, ps.m * pot,
                                                     0.0)))

    if cfg.gravity_solver == "fmm":
        if dim is not None:
            fc = fmm.FmmConfig(min_sep=cfg.fmm_min_sep, level=max(
                cfg.fmm_level, fmm.min_level_for_bands(comm.n)))
            ax, ay, az, pot, nf, bo = fmm.fmm_gravity_sharded(
                comm, ps.x, ps.y, ps.z, ps.m, alive, box, cfg.gravG, fc,
                cfg.eps, dim=dim, rings=cfg.gravity_rings)
        else:
            fc = fmm.FmmConfig(level=cfg.fmm_level, min_sep=cfg.fmm_min_sep)
            ax, ay, az, pot, nf, bo = fmm.fmm_gravity_sharded_generic(
                comm, ps.x, ps.y, ps.z, ps.m, alive, box, cfg.gravG, fc,
                cfg.eps, band_cap=cfg.gravity_band_cap)
        return ax, ay, az, energy(pot), nf + bo

    cap = ps.x.shape[0]
    gx, gy, gz, gm, ga = (v.reshape(-1) for v in comm.all_gather(
        (ps.x, ps.y, ps.z, torch.where(alive, ps.m, 0.0), alive)))
    if cfg.gravity_solver == "ewald":
        from sphexa_tpu_torch.gravity.ewald import ewald_gravity
        g = ewald_gravity(gx, gy, gz, gm, ga, box, cfg.gravG, eps=cfg.eps)
    else:
        from sphexa_tpu_torch.gravity.direct import direct_gravity
        g = direct_gravity(gx, gy, gz, gm, ga, cfg.gravG, cfg.eps)
    mine = slice(comm.me * cap, (comm.me + 1) * cap)
    ovf = torch.zeros((), dtype=torch.int32, device=ps.x.device)
    return (g.ax[mine], g.ay[mine], g.az[mine], energy(g.pot[mine]), ovf)
