"""Load-balanced multi-device VE on the cell-major engine over column
ranges of the x-major column curve (the Hilbert domain's balance with
windows the pair kernels can take).

Counterpart of sphexa_tpu/propagator/ve_pallas_hilbert.py (ColDomain
:68, ColDiag :89, flat_columns :106, balance_column_splits :114,
make_ve_step_pallas_hilbert :145, distribute_columns :378). The mapping
onto the reference (domain/include/cstone/domain/assignment.hpp:55,
domaindecomp.hpp singleRangeSfcSplit, exchange_halos.hpp):

  SFC                     ->  the n^2 (x, y) grid columns in x-major
                              order, q = ix * n + iy; shard d owns the
                              contiguous range [S_d, S_{d+1})
  sfcSplit quantiles      ->  a psum'd float32 column histogram, its
                              cumsum and searchsorted, every step; each
                              shard owns at least n + 1 columns
  exchangeParticles       ->  domain/hilbert.migrate (one all_to_all)
                              with the column owners
  halo discovery + P2P    ->  the halo of a column range lies in the
                              neighbours' first and last n + 1 columns:
                              one ring_pair of packed bands, the x seam
                              shifted by -+Lx on a periodic x; the
                              receiver keeps the halo rows within
                              x-rows [r0 - 1, r_hi + 1]
  per-stage exchangeHalos ->  band re-sends of new payloads on the
                              particle frame; the slot frame is rebuilt
                              from the refreshed rows by to_cm, which
                              re-derives every periodic ghost slot, so
                              no K1 runs

Each shard bins its owned and halo rows into CMGrid(n, cap, nxi=rows):
x-rows [r0 - 1, r0 - 1 + rows) of the global grid, all of y and z. The
stages are the single-device engine's (ve_cellmajor._run_pipeline on
ops/pair_ve.PairVE: the K3-K7 cell launch, csrc/cell_pair.cu). The
shards are domain/mesh.SlabMesh threads.

row_span_ok reports whether every shard's owned rows and its two halo
rows fit the window; where they do not, x_fake clips the rows past it
onto the window's edge cells and the neighbour sets there are wrong, so
a caller must stop on it (the JAX package has no caller: this engine
has no command-line prop).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.domain.hilbert import HilbertConfig, migrate
from sphexa_tpu_torch.domain.mesh import ShardComm, SlabMesh
from sphexa_tpu_torch.domain.slab import _pack_indices
from sphexa_tpu_torch.ops.cellmajor import (CMGrid, build_layout, from_cm,
                                            interior_mask, to_cm)
from sphexa_tpu_torch.ops.pair_ve import PairVE
from sphexa_tpu_torch.propagator.ve_cellmajor import _masked, _run_pipeline
from sphexa_tpu_torch.propagator.ve_sharded import _sharded_gravity
from sphexa_tpu_torch.sfc.box import Box, Boundary, normalize_coords
from sphexa_tpu_torch.sph import timestep as ts
from sphexa_tpu_torch.sph.eos import ideal_gas_cv
from sphexa_tpu_torch.sph.kernels import update_h
from sphexa_tpu_torch.sph.positions import position_update, temp_update
from sphexa_tpu_torch.state import _FIELDS, Particles, SimState

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class ColDomain:
    """Static shape of the balanced column-range domain."""
    n_ranks: int
    n: int              # global interior cells a side
    cap: int            # owned rows a shard
    halo_cap: int       # halo-band rows a side
    mig_cap: int        # migration rows a (source, destination) pair
    rows_cap: int = 0   # the x-row window (0: ceil(n / D) + 4)

    @property
    def rows(self) -> int:
        if self.rows_cap:
            return self.rows_cap
        return -(-self.n // self.n_ranks) + 4

    @property
    def ext(self) -> int:
        return self.cap + 2 * self.halo_cap


class ColDiag(NamedTuple):
    dt: torch.Tensor
    ttot: torch.Tensor
    etot: torch.Tensor
    ecin: torch.Tensor
    eint: torch.Tensor
    lost: torch.Tensor        # migration + halo-band overflow (0)
    n_owned: torch.Tensor     # the largest shard's owned count
    n_total: torch.Tensor
    imbalance: torch.Tensor   # max shard load / mean - 1
    max_nc: torch.Tensor
    h_max: torch.Tensor
    row_span_ok: torch.Tensor  # every shard's owned + halo rows fit
    overflow: torch.Tensor    # slot-cap overflow (0)


def flat_columns(box: Box, n: int, x, y):
    """The x-major column id q = ix * n + iy of each particle."""
    nx, ny, _ = normalize_coords(box, x, y, x)
    ix = torch.clamp_max((nx * n).to(_I32), n - 1)
    iy = torch.clamp_max((ny * n).to(_I32), n - 1)
    return ix * n + iy


def spacing_passes(inner, span: int):
    """At least `span` between consecutive inner boundaries: a forward
    pass raising each, then a backward pass lowering each (the JAX
    package's unrolled loops)."""
    k = inner.shape[-1]
    inner = inner.clone()
    for i in range(1, k):
        inner[..., i] = torch.maximum(inner[..., i], inner[..., i - 1] + span)
    for i in range(k - 2, -1, -1):
        inner[..., i] = torch.minimum(inner[..., i], inner[..., i + 1] - span)
    return inner


def balance_column_splits(comm: ShardComm, q, alive, n: int, n_ranks: int):
    """The quantile split of the global column histogram (float32,
    psum'd): int32 boundaries [D + 1], splits[0] = 0, splits[D] = n^2,
    every shard owning at least n + 1 columns (the +-1 ring's halo
    condition)."""
    ncol = n * n
    if ncol < n_ranks * (n + 1):
        raise ValueError(f"{n_ranks} shards need {n_ranks * (n + 1)} "
                         f"columns; the grid has {ncol}")
    dev = q.device
    hist = torch.zeros(ncol, dtype=torch.float32, device=dev)
    hist.index_add_(0, q.to(torch.int64), alive.to(torch.float32))
    cum = torch.cumsum(comm.psum(hist), 0)
    d = torch.arange(1, n_ranks, dtype=torch.float32, device=dev)
    targets = cum[-1] * d / n_ranks
    inner = torch.searchsorted(cum, targets, side="left").to(_I32) + 1
    k = torch.arange(1, n_ranks, dtype=_I32, device=dev)
    inner = torch.minimum(torch.maximum(inner, k * (n + 1)),
                          ncol - (n_ranks - k) * (n + 1))
    inner = spacing_passes(inner, n + 1)
    return torch.cat([inner.new_zeros(1), inner, inner.new_full((1,), ncol)])


def window_coord(v, vmin: float, vmax: float, length: float, first_cell,
                 edge: float, n_window: int):
    """Positions mapped so that build_layout on the whole axis
    [vmin, vmax) bins the global cells [first_cell - 1, first_cell - 1 +
    n_window) onto the window's n_window cells; positions past the
    window clip onto its edge cells (in float32, as the JAX package
    rounds them)."""
    f = vmin + ((v - vmin) / edge - (first_cell.to(torch.float32) - 1.0)) \
        * (length / float(n_window))
    return torch.clamp(f, vmin, vmax - 1e-6 * length)


def slot_fills(k: int) -> tuple:
    """The benign invalid-slot fill of each row of a stack that
    _run_pipeline refreshes (the JAX pipeline's `fills`): its two-row
    stacks (xm and h, kx and gradh) take 1.0, the IAD, divv, curlv and
    alpha stacks 0.0."""
    return (1.0, 1.0) if k == 2 else (0.0,) * k


def finish_window_step(comm: ShardComm, ps: Particles, eps: Particles, out,
                       layout, validint, dt_prev, box: Box, cfg: SphConfig,
                       n_ext: int, cap: int, dim, h_cap: float = 0.0):
    """The tail that the column and tile steps share: the sharded
    gravity (slab FMM along `dim`, or the generic one with dim None) on
    the owned frame, the global dt, the integration of the extended
    frame and the owned rows cut back out. Returns (owned frame, dt,
    egrav, gravity fail-stop count, maxima row of nc_sph - 1)."""
    dev = ps.x.device

    def back(f, fill=0.0):
        return from_cm(layout, f, n_ext, fill)

    ax_p, ay_p, az_p = back(out["ax"]), back(out["ay"]), back(out["az"])
    egrav = torch.zeros((), dtype=torch.float32, device=dev)
    govf = torch.zeros((), dtype=_I32, device=dev)
    if cfg.gravG != 0.0:
        gax, gay, gaz, egrav, govf = _sharded_gravity(comm, ps, box, cfg,
                                                      dim=dim)
        pad = torch.zeros(n_ext - cap, dtype=torch.float32, device=dev)
        ax_p = ax_p + torch.cat([gax, pad])
        ay_p = ay_p + torch.cat([gay, pad])
        az_p = az_p + torch.cat([gaz, pad])

    dt_local = torch.minimum(
        ts.courant_timestep(out["maxvsignal"], out["h"], out["c"], validint,
                            cfg.kcour),
        ts.rho_timestep(out["divv"], validint, cfg.krho))
    if cfg.gravG != 0.0:
        dt_local = torch.minimum(dt_local, ts.acceleration_timestep(
            ax_p, ay_p, az_p, eps.alive, cfg.eta_acc, cfg.eps))
    dt = comm.pmin(torch.minimum(cfg.max_dt_increase * dt_prev, dt_local))

    h_back = back(out["h"], 1.0)
    x, y, z, vxn, vyn, vzn, dx, dy, dz = position_update(
        dt, dt_prev, eps.x, eps.y, eps.z, ax_p, ay_p, az_p, eps.x_m1,
        eps.y_m1, eps.z_m1, box, h=h_back, vx=eps.vx, vy=eps.vy, vz=eps.vz)
    du = back(out["du"])
    temp_n = temp_update(eps.temp, dt, dt_prev, du, eps.du_m1, cfg.mui,
                         cfg.gamma)
    h_n = update_h(cfg.ng0, back(out["nc_sph"], 1.0), h_back, h_cap=h_cap)

    def own(v):
        return v[:cap]

    ps = ps.replace(
        x=own(x), y=own(y), z=own(z), vx=own(vxn), vy=own(vyn),
        vz=own(vzn), x_m1=own(dx), y_m1=own(dy), z_m1=own(dz),
        temp=own(temp_n), h=torch.where(ps.alive, own(h_n), 1.0),
        du_m1=own(du), alpha=own(back(out["alpha"], cfg.alphamin)))
    nc_max = torch.max(_masked(out["nc_sph"] - 1.0, validint))
    return ps, dt, egrav, govf, nc_max


def window_diag(comm: ShardComm, ps: Particles, cfg: SphConfig, D: int,
                n_own, lost, egrav, nc_max, span_ok, overflow):
    """The reduced diagnostics of the column and tile steps: (dt-free)
    dict of ColDiag's / TileDiag's fields."""
    cv = ideal_gas_cv(cfg.mui, cfg.gamma)
    alive = ps.alive
    ecin = comm.psum(0.5 * torch.sum(_masked(
        ps.m * (ps.vx ** 2 + ps.vy ** 2 + ps.vz ** 2), alive)))
    eint = comm.psum(torch.sum(_masked(ps.m * cv * ps.temp, alive)))
    n_tot = comm.psum(n_own)
    n_max = comm.pmax(n_own)
    return dict(
        etot=ecin + eint + egrav, ecin=ecin, eint=eint,
        lost=comm.psum(lost), n_owned=n_max, n_total=n_tot,
        imbalance=n_max.to(torch.float32)
        / torch.clamp_min(n_tot.to(torch.float32) / D, 1.0) - 1.0,
        max_nc=comm.pmax(nc_max).to(_I32),
        h_max=comm.pmax(torch.max(_masked(ps.h, alive))),
        span_ok=torch.all(comm.all_gather(span_ok)),
        overflow=comm.psum(overflow.to(_I32)))


def make_ve_step_pallas_hilbert(box: Box, cd: ColDomain, cap_cell: int,
                                cfg: SphConfig, mesh: SlabMesh):
    """step(states) -> (states, ColDiag): one SimState a shard (its [cap]
    owned frame, on its device, as distribute_columns gives it); the
    diagnostics come from shard 0, reduced over the shards. The global
    grid is n^3 (cubic, from the 2 h_max bound); each shard's local
    grid is rows x n x n."""
    D, n, H = cd.n_ranks, cd.n, cd.halo_cap
    if mesh.n_slabs != D:
        raise ValueError(f"mesh of {mesh.n_slabs} shards, ColDomain of {D} "
                         f"ranks")
    grid = CMGrid(n=n, cap=cap_cell, nxi=cd.rows)
    pve = PairVE(grid, cfg)
    box_loc = dataclasses.replace(box, bx=Boundary.open)
    intmasks = {d: interior_mask(grid, d) for d in set(mesh.devices)}
    periodic_x = box.bx == Boundary.periodic
    edge = box.lx / n
    lx = float(np.float32(box.lx))
    hc = HilbertConfig(n_ranks=D, cap=cd.cap, halo_cap=H, mig_cap=cd.mig_cap)
    xi = _FIELDS.index("x")

    def local_step(comm: ShardComm, state: SimState):
        me, ps, dt_prev = comm.me, state.p, state.dt
        dev = ps.x.device

        # ---- assignment and migration, every step (Domain::sync) ----
        q0 = flat_columns(box, n, ps.x, ps.y)
        splits = balance_column_splits(comm, q0, ps.alive, n, D)
        owner = torch.searchsorted(splits[1:-1].contiguous(), q0,
                                   side="right").to(_I32)
        ps, lost_mig, n_own = migrate(comm, ps, box, None, hc, owner=owner)
        s_lo, s_hi = splits[me], splits[me + 1]
        r0 = torch.div(s_lo, n, rounding_mode="floor")
        r_hi = torch.div(s_hi - 1, n, rounding_mode="floor")

        # ---- the halo bands (+-1 ring) and their cached index maps ----
        q = flat_columns(box, n, ps.x, ps.y)
        lane = torch.arange(H, device=dev)
        mask_r = ps.alive & (q >= s_hi - (n + 1))     # to shard me + 1
        mask_l = ps.alive & (q < s_lo + (n + 1))      # to shard me - 1
        idx_r, cnt_r = _pack_indices(mask_r, H)
        idx_l, cnt_l = _pack_indices(mask_l, H)
        idx_r, idx_l = idx_r.to(torch.int64), idx_l.to(torch.int64)
        lost_halo = (torch.sum(mask_r, dtype=_I32) - cnt_r
                     + torch.sum(mask_l, dtype=_I32) - cnt_l)
        sv_r, sv_l = lane < cnt_r, lane < cnt_l
        hv_l, hv_r = comm.ring_pair(sv_r, sv_l)   # the receiver's slots
        if not periodic_x:
            hv_l = hv_l & (me != 0)
            hv_r = hv_r & (me != D - 1)

        def band_refresh(stack, xrow: int = -1):
            """Re-send the bands with the rows of `stack` [K, ext] as
            payload into its halo slots (a new stack); xrow marks the
            coordinate row that takes the periodic x seam shift."""
            pay_r = torch.where(sv_r, stack[:, idx_r], 0.0)
            pay_l = torch.where(sv_l, stack[:, idx_l], 0.0)
            got_l, got_r = comm.ring_pair(pay_r, pay_l)
            if xrow >= 0 and periodic_x:
                # the received tensors are the senders' own: shift copies
                if me == 0:
                    got_l = got_l.clone()
                    got_l[xrow] += -lx
                if me == D - 1:
                    got_r = got_r.clone()
                    got_r[xrow] += lx
            return torch.cat([
                stack[:, :cd.cap],
                torch.where(hv_l, got_l, stack[:, cd.cap:cd.cap + H]),
                torch.where(hv_r, got_r, stack[:, cd.cap + H:])], 1)

        # ---- the extended particle frame: owned rows and halo slots ----
        own_rows = torch.stack([getattr(ps, f) for f in _FIELDS[:-1]])
        ext_rows = band_refresh(torch.cat(
            [own_rows, own_rows.new_zeros((own_rows.shape[0], 2 * H))], 1),
            xrow=xi)
        ext = dict(zip(_FIELDS[:-1], ext_rows))
        # the (n + 1)-column band can reach one x-row past the stencil
        # when a split falls on a row boundary: the receiver keeps the
        # halo rows in [r0 - 1, r_hi + 1]
        r_ext = torch.floor((ext["x"] - box.xmin) / edge).to(_I32)
        need = (r_ext >= r0 - 1) & (r_ext <= r_hi + 1)
        hv_l = hv_l & need[cd.cap:cd.cap + H]
        hv_r = hv_r & need[cd.cap + H:]
        ext_alive = torch.cat([ps.alive, hv_l, hv_r])
        ext["h"] = torch.where(ext_alive, ext["h"], 1.0)
        eps = Particles(alive=ext_alive, **ext)
        owned_row = torch.cat([ps.alive, torch.zeros(2 * H, dtype=torch.bool,
                                                     device=dev)])

        # ---- bin into the local x-row window ----
        x_fake = window_coord(eps.x, box.xmin, box.xmax, box.lx, r0, edge,
                              grid.nx)
        layout = build_layout(grid, box_loc, x_fake, eps.y, eps.z,
                              alive=ext_alive)
        own_slots = to_cm(layout, owned_row.to(torch.float32)) > 0.5
        validint = layout.valid & intmasks[dev] & own_slots
        # the kept halo rows [r0 - 1, r_hi + 1] must fit the window
        span_ok = (r_hi - r0 + 3) <= grid.nx

        base = pve.base_rows(layout, eps.x, eps.y, eps.z, eps.h)

        def cm(f, fill=0.0):
            return to_cm(layout, f, fill)

        def refresh(stack):
            """Slot frame -> particle frame -> band re-send -> slot frame
            (to_cm re-derives the ghost slots). Invalid slots get each
            row's benign fill, not the incoming values: slots of cells
            outside the window are never written by the stages."""
            fills = slot_fills(stack.shape[0])
            rows = torch.stack([from_cm(layout, stack[i], cd.ext, f)
                                for i, f in enumerate(fills)])
            rows = band_refresh(rows)
            return torch.stack([cm(rows[i], f) for i, f in enumerate(fills)])

        out = _run_pipeline(pve, refresh, base, cm(eps.m), cm(eps.vx),
                            cm(eps.vy), cm(eps.vz), cm(eps.temp),
                            cm(eps.alpha), dt_prev, validint)
        ps, dt, egrav, govf, nc_max = finish_window_step(
            comm, ps, eps, out, layout, validint, dt_prev, box, cfg, cd.ext,
            cd.cap, dim=0)
        d = window_diag(comm, ps, cfg, D, n_own, lost_mig + lost_halo + govf,
                        egrav, nc_max, span_ok, layout.overflow)
        d["row_span_ok"] = d.pop("span_ok")
        ttot = state.ttot + dt
        return (SimState(p=ps, ttot=ttot, dt=dt, dt_m1=state.dt,
                         iteration=state.iteration + 1),
                ColDiag(dt=dt, ttot=ttot, **d))

    def step(states):
        res = mesh.run(local_step, states)
        return [r[0] for r in res], res[0][1]

    return step


def _shards_of(ps_host: dict, owner, n_ranks: int, cap: int,
               mesh: SlabMesh) -> list:
    """One Particles a shard: the rows of each owner, in row order,
    padded to cap, on the shard's device."""
    shards = []
    for d in range(n_ranks):
        sel = np.flatnonzero(owner == d)
        if len(sel) > cap:
            raise ValueError(f"rank {d} holds {len(sel)} > cap {cap}")
        pad = cap - len(sel)
        dev = mesh.devices[d]
        t = {f: torch.from_numpy(np.concatenate(
            [np.asarray(ps_host[f], np.float32)[sel],
             np.full(pad, 1.0 if f == "h" else 0.0, np.float32)])).to(dev)
             for f in _FIELDS[:-1]}
        shards.append(Particles(alive=torch.arange(cap, device=dev)
                                < len(sel), **t))
    return shards


def distribute_columns(ps_host: dict, box: Box, cd: ColDomain,
                       mesh: SlabMesh) -> list:
    """Host-side initial distribution: the balanced column-range split
    of the particles (ps_host: field -> numpy array of the alive rows),
    each shard padded to cap. Returns one Particles a shard."""
    n = cd.n
    x = np.asarray(ps_host["x"], np.float64)
    y = np.asarray(ps_host["y"], np.float64)
    ix = np.clip(((x - box.xmin) / box.lx * n).astype(np.int64), 0, n - 1)
    iy = np.clip(((y - box.ymin) / box.ly * n).astype(np.int64), 0, n - 1)
    q = ix * n + iy
    cum = np.cumsum(np.bincount(q, minlength=n * n))
    targets = cum[-1] * np.arange(1, cd.n_ranks) / cd.n_ranks
    inner = np.searchsorted(cum, targets, side="left") + 1
    lo = np.arange(1, cd.n_ranks) * (n + 1)
    hi = n * n - (cd.n_ranks - np.arange(1, cd.n_ranks)) * (n + 1)
    inner = np.maximum.accumulate(np.clip(inner, lo, hi))
    splits = np.concatenate([[0], inner, [n * n]])
    owner = np.searchsorted(splits[1:-1], q, side="right")
    return _shards_of(ps_host, owner, cd.n_ranks, cd.cap, mesh)
