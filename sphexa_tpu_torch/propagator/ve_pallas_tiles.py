"""Load-balanced multi-device VE on the cell-major engine over 2-D tile
domains: count-balanced x-bands, each cut into z-ranges
(--prop ve-pallas-tiles).

Counterpart of sphexa_tpu/propagator/ve_pallas_tiles.py (TileDomain
:75, TileDiag :97, _cell_coords :113, _cells_of_fine :121,
_quantile_splits :127, tile_splits :161, _in_span :182, _wrap_shift
:191, make_ve_step_pallas_tiles :202, plan_tile_caps :448,
_np_quantile_splits :478, distribute_tiles :496), and plan_tile_halo,
_second_shift, tile_factors and plan_tile_domain, which the JAX package
lacks (its adapter's halo_cap is a fixed share of the rows, and its
sizing sits in the adapter; ROADMAP Queue 3). The column ranges of
ve_pallas_hilbert keep a static x-row window that the tall sparse
ranges of a clustered field (Evrard) outgrow; tiles split both windowed
axes:

  assignment.hpp:55 sfcSplit  ->  two nested count-balanced quantile
      splits from psum'd float32 histograms, every step: the x-rows
      into R bands, then each band's z-columns into C ranges (D = R C
      shards). A shard owns [rows ra..rb) x all y x [z-cols ca..cb).
  exchangeParticles           ->  domain/hilbert.migrate (one
      all_to_all) with the tile owners.
  halo discovery + P2P        ->  a shard's halo is its rectangle grown
      by one cell, minus its own: every shard packs, for every other
      shard, its owned rows inside that shard's grown rectangle (with
      the periodic wrap shifts of x and z), and one all_to_all delivers
      every halo. A window wider than the periodic box (a tile of
      n - 1 cells and its halo cells: coarse grids) holds the cell at
      both of its ends twice, plainly and through the seam: those rows
      go twice, the second copies after the JAX band (the JAX step
      sends one copy, and the neighbour sets at the other end are
      wrong). The per-stage refreshes re-send the same index maps
      with new payloads; to_cm re-derives the ghost slots, so no K1
      runs.
  the local frame             ->  CMGrid(n, cap, nxi=rows_cap if R > 1,
      nzi=zcols_cap if C > 1): the rectangle plus one halo cell a side
      on the windowed axes; an axis with one part keeps the global
      periodic layout (an open window there would lose the wrap pairs:
      no other shard sends them). The stages are the single-device
      engine's (ve_cellmajor._run_pipeline on PairVE: the K3-K7 cell
      launch of csrc/cell_pair.cu).

Ownership boundaries lie on a `fine` x sub-cell grid (4 bins a cell an
axis): whole-cell splits quantize a small cluster's mass at about
1/span a row. Two tiles may then share a boundary cell; the slots stay
per-particle (own_slots), and the windows and grown rectangles round
the fine spans out to whole cells.

span_ok reports whether every shard's rectangle and its halo cells fit
the windows. Where they do not, the positions past a window are clipped
onto its edge cells (window_coord) and the neighbour sets there are
wrong; the JAX CLI adapter does not read span_ok
(sphexa_tpu/propagator/multichip.py:343-369), the port's
MultiChipAdapter fail-stops on it and the main loop re-plans the
windows (plan_tile_caps) from the restored state (ROADMAP Queue 3).
Under gravity the generic sharded FMM runs (dim None): tiles are the
generic domain shape it serves. The JAX step's TILES_DEBUG print
(ve_pallas_tiles.py:276-282) is a debug aid, not physics, and is left
out: the port reads no environment variable here.
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
from sphexa_tpu_torch.ops.cellmajor import (CMGrid, build_layout,
                                            choose_cap_and_grid, from_cm,
                                            interior_mask, to_cm)
from sphexa_tpu_torch.ops.pair_ve import MAX_CAP, PairVE
from sphexa_tpu_torch.propagator.ve_cellmajor import _run_pipeline
from sphexa_tpu_torch.propagator.ve_pallas_hilbert import (
    _shards_of, finish_window_step, slot_fills, spacing_passes, window_coord,
    window_diag)
from sphexa_tpu_torch.propagator.ve_sharded import round_up
from sphexa_tpu_torch.sfc.box import Box, Boundary, normalize_coords
from sphexa_tpu_torch.state import _FIELDS, Particles, SimState

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class TileDomain:
    """Static shape of the balanced 2-D tile domain."""
    n_rows: int          # R: x-bands
    n_cols: int          # C: z-ranges a band (D = R C)
    n: int               # global interior cells a side
    cap: int             # owned rows a shard
    halo_cap: int        # halo rows a (source, destination) pair
    mig_cap: int         # migration rows a (source, destination) pair
    rows_cap: int        # x-row window (>= widest band's cells + 2)
    zcols_cap: int       # z-column window (>= widest range's cells + 2)
    fine: int = 4        # split bins a cell an axis

    @property
    def n_ranks(self) -> int:
        return self.n_rows * self.n_cols

    @property
    def ext(self) -> int:
        return self.cap + self.n_ranks * self.halo_cap


class TileDiag(NamedTuple):
    dt: torch.Tensor
    ttot: torch.Tensor
    etot: torch.Tensor
    ecin: torch.Tensor
    eint: torch.Tensor
    lost: torch.Tensor       # migration + halo-band overflow (0)
    n_owned: torch.Tensor    # the largest shard's owned count
    n_total: torch.Tensor
    imbalance: torch.Tensor  # max shard load / mean - 1
    max_nc: torch.Tensor
    h_max: torch.Tensor
    span_ok: torch.Tensor    # every rectangle + halo fits the windows
    overflow: torch.Tensor   # slot-cap overflow (0)


def _cell_coords(box: Box, n: int, x, y, z):
    nx, ny, nz = normalize_coords(box, x, y, z)
    return tuple(torch.clamp_max((v * n).to(_I32), n - 1)
                 for v in (nx, ny, nz))


def _cells_of_fine(lo_f, hi_f, fine: int):
    """The inclusive cell range [oc_lo, oc_hi] of the fine-bin span
    [lo_f, hi_f)."""
    return (torch.div(lo_f, fine, rounding_mode="floor"),
            torch.div(hi_f - 1, fine, rounding_mode="floor"))


def _quantile_splits(hist, parts: int, min_span: int):
    """[..., m] float32 histogram -> [..., parts + 1] int32 count-balanced
    boundaries, at least min_span apart. Each boundary rounds to the
    nearer side of its cumulative-mass crossing."""
    m = hist.shape[-1]
    dev = hist.device
    cum = torch.cumsum(hist, -1)
    k = torch.arange(1, parts, dtype=_I32, device=dev)
    targets = cum[..., -1:] * k.to(torch.float32) / parts
    k1 = torch.clamp(torch.searchsorted(cum, targets, side="left"), 0,
                     m - 1)
    before = torch.gather(cum, -1, torch.clamp_min(k1 - 1, 0))
    under = targets - torch.where(k1 > 0, before, 0.0)
    over = torch.gather(cum, -1, k1) - targets
    inner = k1.to(_I32) + (over < under).to(_I32)
    inner = torch.minimum(torch.maximum(inner, k * min_span),
                          m - (parts - k) * min_span)
    inner = spacing_passes(inner, min_span)
    zero = inner.new_zeros(inner.shape[:-1] + (1,))
    return torch.cat([zero, inner, zero + m], -1)


def tile_splits(comm: ShardComm, ixf, izf, alive, nf: int, R: int, C: int,
                fine: int):
    """The balanced tiles on the fine grid (nf = n fine bins an axis):
    (row_splits [R + 1], col_splits [R, C + 1], owner [N]) in fine
    units, the same on every shard (the histograms are psum'd)."""
    af = alive.to(torch.float32)
    dev = ixf.device
    histx = torch.zeros(nf, dtype=torch.float32, device=dev)
    histx.index_add_(0, ixf.to(torch.int64), af)
    row_splits = _quantile_splits(comm.psum(histx), R, fine)
    band = torch.clamp(torch.searchsorted(row_splits[1:-1].contiguous(), ixf,
                                          side="right"), 0, R - 1)
    hist2 = torch.zeros(R * nf, dtype=torch.float32, device=dev)
    hist2.index_add_(0, band * nf + izf.to(torch.int64), af)
    col_splits = _quantile_splits(comm.psum(hist2).reshape(R, nf), C, fine)
    cs = col_splits[band]                                    # [N, C + 1]
    col = torch.sum(izf[:, None] >= cs[:, 1:C], 1, dtype=_I32)
    return row_splits, col_splits, (band.to(_I32) * C + col)


def _in_span(i, a, b, n: int, periodic: bool):
    """Membership of cell i in the (on a periodic axis, wrapped) span
    [a, b); a may be -1 and b n + 1 for a grown rectangle."""
    if not periodic:
        return (i >= a) & (i < b)
    return torch.where(b - a >= n, True, torch.remainder(i - a, n) < b - a)


def _wrap_shift(i, a, b, n: int, periodic: bool):
    """s in {-1, 0, +1} with i + s n in [a, b) for a member of the
    wrapped span (0 for non-members and open axes)."""
    if not periodic:
        return torch.zeros_like(i)
    plain = (i >= a) & (i < b)
    down = (i - n >= a) & (i - n < b)
    up = (i + n >= a) & (i + n < b)
    return torch.where(plain, 0, torch.where(down, -1, torch.where(up, 1, 0)))


def _second_shift(i, a, b, n: int):
    """On a periodic windowed axis whose span [a, b) is longer than n
    (a tile of n - 1 cells and its two halo cells), the cells at both of
    its ends are one cell of the box, which the window holds twice: at
    its plain place and through the seam. Returns (s, has): the shift of
    that second copy and where it exists (besides _wrap_shift's)."""
    plain = (i >= a) & (i < b)
    down = (i - n >= a) & (i - n < b)
    up = (i + n >= a) & (i + n < b)
    return torch.where(down, -1, 1), plain & (down | up)


def make_ve_step_pallas_tiles(box: Box, td: TileDomain, cap_cell: int,
                              cfg: SphConfig, mesh: SlabMesh):
    """step(states) -> (states, TileDiag): one SimState a shard (its [cap]
    owned frame, on its device, as distribute_tiles gives it); the
    diagnostics come from shard 0, reduced over the shards. The global
    grid is n^3; each shard's local grid is rows_cap x n x zcols_cap on
    the windowed axes."""
    D, R, C, n, H = td.n_ranks, td.n_rows, td.n_cols, td.n, td.halo_cap
    if mesh.n_slabs != D:
        raise ValueError(f"mesh of {mesh.n_slabs} shards, TileDomain of "
                         f"{D} ranks")
    per_x = box.bx == Boundary.periodic
    per_z = box.bz == Boundary.periodic
    edge_x, edge_z = box.lx / n, box.lz / n
    nf = n * td.fine
    win_x, win_z = R > 1, C > 1
    # windows wider than the periodic box take second, shifted copies
    # of the cells at both of their ends (the JAX step sends one copy,
    # ROADMAP Queue 3)
    dup_x = win_x and per_x and td.rows_cap > n
    dup_z = win_z and per_z and td.zcols_cap > n
    grid = CMGrid(n=n, cap=cap_cell, nxi=td.rows_cap if win_x else 0,
                  nzi=td.zcols_cap if win_z else 0)
    pve = PairVE(grid, cfg)
    box_loc = dataclasses.replace(
        box, bx=Boundary.open if win_x else box.bx,
        bz=Boundary.open if win_z else box.bz)
    intmasks = {d: interior_mask(grid, d) for d in set(mesh.devices)}
    hc = HilbertConfig(n_ranks=D, cap=td.cap, halo_cap=H, mig_cap=td.mig_cap)
    lx, lz = float(np.float32(box.lx)), float(np.float32(box.lz))
    xi, zi = _FIELDS.index("x"), _FIELDS.index("z")

    def local_step(comm: ShardComm, state: SimState):
        me, ps, dt_prev = comm.me, state.p, state.dt
        dev = ps.x.device

        # ---- assignment and migration, every step (Domain::sync) ----
        ixf0, _, izf0 = _cell_coords(box, nf, ps.x, ps.y, ps.z)
        rs, cs, owner = tile_splits(comm, ixf0, izf0, ps.alive, nf, R, C,
                                    td.fine)
        ps, lost_mig, n_own = migrate(comm, ps, box, None, hc, owner=owner)
        my_band, my_col = me // C, me % C
        r0, r_hi = _cells_of_fine(rs[my_band], rs[my_band + 1], td.fine)
        c0, c_hi = _cells_of_fine(cs[my_band, my_col],
                                  cs[my_band, my_col + 1], td.fine)

        # ---- the halo bands: one packed band a destination ----
        # each destination's rectangle rounded out to cells, grown by 1
        ix, _, iz = _cell_coords(box, n, ps.x, ps.y, ps.z)
        lane = torch.arange(H, device=dev)
        idx_d, sv_d, sx_d, sz_d = [], [], [], []
        lost_halo = torch.zeros((), dtype=_I32, device=dev)
        for d in range(D):
            db, dc = d // C, d % C
            oc_lo, oc_hi = _cells_of_fine(rs[db], rs[db + 1], td.fine)
            zc_lo, zc_hi = _cells_of_fine(cs[db, dc], cs[db, dc + 1],
                                          td.fine)
            ra, rb, ca, cb = oc_lo - 1, oc_hi + 2, zc_lo - 1, zc_hi + 2
            m = (ps.alive & _in_span(ix, ra, rb, n, per_x)
                 & _in_span(iz, ca, cb, n, per_z))
            if d == me:
                m = torch.zeros_like(m)
            sx = [_wrap_shift(ix, ra, rb, n, per_x)]
            sz = [_wrap_shift(iz, ca, cb, n, per_z)]
            ms = [m]
            if dup_x:
                s2, has = _second_shift(ix, ra, rb, n)
                ms.append(m & has)
                sx, sz = sx + [s2], sz + sz
            if dup_z:
                s2, has = _second_shift(iz, ca, cb, n)
                ms += [mk & has for mk in ms]
                sx, sz = sx + sx, sz + [s2] * len(sz)
            # first copies in row order (the JAX band), then the seconds
            m = torch.cat(ms)
            idx, cnt = _pack_indices(m, H)
            idx = idx.to(torch.int64)
            lost_halo = lost_halo + (torch.sum(m, dtype=_I32) - cnt)
            idx_d.append(torch.remainder(idx, ps.x.shape[0]))
            sv_d.append(lane < cnt)
            sx_d.append(torch.cat(sx)[idx])
            sz_d.append(torch.cat(sz)[idx])
        idx_d = torch.stack(idx_d)                            # [D, H]
        sv_d = torch.stack(sv_d)
        # the coordinate shifts of the periodic seams, zero off the band
        shift = {xi: torch.where(sv_d, torch.stack(sx_d).to(torch.float32)
                                 * lx, 0.0),
                 zi: torch.where(sv_d, torch.stack(sz_d).to(torch.float32)
                                 * lz, 0.0)}
        hv = comm.all_to_all(sv_d)                 # [D, H] halo validity

        def band_exchange(stack, shifted=False):
            """Send each row of stack [K, cap] in the packed bands of
            every destination; returns the halo block [K, D H] received
            (0 in the empty slots). `shifted` adds the seam shifts to
            the x and z rows (the full field stack)."""
            pay = torch.where(sv_d[:, None], stack[:, idx_d].transpose(0, 1),
                              0.0)                           # [D, K, H]
            if shifted:
                for row, s in shift.items():
                    pay[:, row] = pay[:, row] + s
            got = comm.all_to_all(pay)                       # [D, K, H]
            got = torch.where(hv[:, None], got, 0.0)
            return got.transpose(0, 1).reshape(stack.shape[0], D * H)

        # ---- the extended particle frame: owned rows + halo blocks ----
        own_rows = torch.stack([getattr(ps, f) for f in _FIELDS[:-1]])
        ext_rows = torch.cat([own_rows, band_exchange(own_rows, True)], 1)
        ext_alive = torch.cat([ps.alive, hv.reshape(D * H)])
        ext = dict(zip(_FIELDS[:-1], ext_rows))
        ext["h"] = torch.where(ext_alive, ext["h"], 1.0)
        eps = Particles(alive=ext_alive, **ext)
        owned_row = torch.cat([ps.alive, torch.zeros(
            D * H, dtype=torch.bool, device=dev)])

        # ---- bin into the local rectangle window ----
        x_fake = window_coord(eps.x, box.xmin, box.xmax, box.lx, r0, edge_x,
                              grid.nx) if win_x else eps.x
        z_fake = window_coord(eps.z, box.zmin, box.zmax, box.lz, c0, edge_z,
                              grid.nz) if win_z else eps.z
        layout = build_layout(grid, box_loc, x_fake, eps.y, z_fake,
                              alive=ext_alive)
        own_slots = to_cm(layout, owned_row.to(torch.float32)) > 0.5
        validint = layout.valid & intmasks[dev] & own_slots
        span_ok = torch.ones((), dtype=torch.bool, device=dev)
        if win_x:
            span_ok = span_ok & ((r_hi - r0 + 3) <= grid.nx)
        if win_z:
            span_ok = span_ok & ((c_hi - c0 + 3) <= grid.nz)

        base = pve.base_rows(layout, eps.x, eps.y, eps.z, eps.h)

        def cm(f, fill=0.0):
            return to_cm(layout, f, fill)

        def refresh(stack):
            """Slot frame -> particle frame -> band re-send -> slot frame
            (to_cm re-derives the ghost slots)."""
            fills = slot_fills(stack.shape[0])
            rows = torch.stack([from_cm(layout, stack[i], td.ext, f)
                                for i, f in enumerate(fills)])
            rows = torch.cat([rows[:, :td.cap],
                              band_exchange(rows[:, :td.cap])], 1)
            return torch.stack([cm(rows[i], f) for i, f in enumerate(fills)])

        out = _run_pipeline(pve, refresh, base, cm(eps.m), cm(eps.vx),
                            cm(eps.vy), cm(eps.vz), cm(eps.temp),
                            cm(eps.alpha), dt_prev, validint)
        ps, dt, egrav, govf, nc_max = finish_window_step(
            comm, ps, eps, out, layout, validint, dt_prev, box, cfg, td.ext,
            td.cap, dim=None, h_cap=cfg.h_cap)
        d = window_diag(comm, ps, cfg, D, n_own, lost_mig + lost_halo + govf,
                        egrav, nc_max, span_ok, layout.overflow)
        ttot = state.ttot + dt
        return (SimState(p=ps, ttot=ttot, dt=dt, dt_m1=state.dt,
                         iteration=state.iteration + 1),
                TileDiag(dt=dt, ttot=ttot, **d))

    def step(states):
        res = mesh.run(local_step, states)
        return [r[0] for r in res], res[0][1]

    return step


def _np_quantile_splits(hist, parts: int, min_span: int):
    m = len(hist)
    cum = np.cumsum(hist)
    targets = cum[-1] * np.arange(1, parts) / parts
    k1 = np.clip(np.searchsorted(cum, targets, side="left"), 0, m - 1)
    under = targets - np.where(k1 > 0, cum[np.maximum(k1 - 1, 0)], 0.0)
    over = cum[k1] - targets
    inner = k1 + np.where(over < under, 1, 0)
    lo = np.arange(1, parts) * min_span
    hi = m - (parts - np.arange(1, parts)) * min_span
    inner = np.clip(inner, lo, hi)
    for i in range(1, parts - 1):
        inner[i] = max(inner[i], inner[i - 1] + min_span)
    for i in range(parts - 3, -1, -1):
        inner[i] = min(inner[i], inner[i + 1] - min_span)
    return np.concatenate([[0], inner, [m]])


def _fine_bins(box: Box, nf: int, x, z):
    ix = np.clip(((np.asarray(x, np.float64) - box.xmin) / box.lx * nf)
                 .astype(int), 0, nf - 1)
    iz = np.clip(((np.asarray(z, np.float64) - box.zmin) / box.lz * nf)
                 .astype(int), 0, nf - 1)
    return ix, iz


def plan_tile_caps(box: Box, td_partial: dict, x, y, z, alive=None):
    """Host-side window planning: the widest tile's cells (+2 halo
    cells) on each windowed axis from the fine-grid splits the step
    computes on the same positions. Returns (rows_cap, zcols_cap);
    re-plan when span_ok trips."""
    fine = td_partial.get("fine", 4)
    if alive is not None:
        keep = np.asarray(alive)
        x, z = np.asarray(x)[keep], np.asarray(z)[keep]
    rs, cs, _ = _tile_owners(box, td_partial["n"], td_partial["n_rows"],
                             td_partial["n_cols"], fine, x, z)

    def cspan(s):
        return int(((s[1:] - 1) // fine - s[:-1] // fine + 1).max())

    return cspan(rs) + 2, max(cspan(c) for c in cs) + 2


def _tile_owners(box: Box, n: int, R: int, C: int, fine: int, x, z):
    """Host-side tiles of these positions, as distribute_tiles and the
    step's first splits make them: (row splits, column splits a band,
    owner of each row), in fine units."""
    nf = n * fine
    ix, iz = _fine_bins(box, nf, x, z)
    rs = _np_quantile_splits(np.bincount(ix, minlength=nf), R, fine)
    band = np.clip(np.searchsorted(rs[1:-1], ix, side="right"), 0, R - 1)
    owner = np.zeros(len(ix), int)
    cs = []
    for b in range(R):
        sel = band == b
        cs.append(_np_quantile_splits(np.bincount(iz[sel], minlength=nf), C,
                                      fine))
        col = np.clip(np.searchsorted(cs[b][1:-1], iz[sel], side="right"),
                      0, C - 1)
        owner[sel] = b * C + col
    return rs, cs, owner


def plan_tile_halo(box: Box, td_partial: dict, x, y, z) -> int:
    """Host-side halo planning: the most rows any tile sends any other
    in the step's first exchange (its rows inside the other's rectangle
    rounded out to cells and grown by one, wrapped on a periodic axis,
    a row twice where a window wider than the box holds its cell at
    both ends). Where one tile's grown rectangle covers most of the box
    (a coarse grid), that is most of a tile's rows, or twice them."""
    n, R, C = td_partial["n"], td_partial["n_rows"], td_partial["n_cols"]
    fine = td_partial.get("fine", 4)
    rs, cs, owner = _tile_owners(box, n, R, C, fine, x, z)
    ix, iz = _fine_bins(box, n, x, z)

    def copies(i, a, b, periodic, windowed):
        if not periodic:
            return ((i >= a) & (i < b)).astype(np.int64)
        if not windowed:            # the periodic layout wraps the axis
            return np.ones(i.shape, np.int64)
        return sum(((i + s * n >= a) & (i + s * n < b)).astype(np.int64)
                   for s in (-1, 0, 1))

    worst = 0
    for d in range(R * C):
        db, dc = divmod(d, C)
        w = (copies(ix, rs[db] // fine - 1, (rs[db + 1] - 1) // fine + 2,
                    box.bx == Boundary.periodic, R > 1)
             * copies(iz, cs[db][dc] // fine - 1,
                      (cs[db][dc + 1] - 1) // fine + 2,
                      box.bz == Boundary.periodic, C > 1) * (owner != d))
        worst = max(worst, int(np.bincount(owner, weights=w,
                                           minlength=R * C).max()))
    return worst


def tile_factors(D: int) -> tuple:
    """The tile domain's (R, C) for D shards: R = 2^floor(floor(log2 D)
    / 2), C = D // R, R <= C (the JAX adapter's rule, multichip.py:218-219;
    R C < D where R does not divide D: D = 5, 7, 9, ...)."""
    R = 1 << (max(D.bit_length() - 1, 0) // 2)
    return R, D // R


def plan_tile_domain(box: Box, host: dict, h_max: float, n_global: int,
                     D: int):
    """The tile domain's sizing for D shards (the JAX adapter's,
    sphexa_tpu/propagator/multichip.py:198-241, with two changes): the
    global grid is choose_cap_and_grid's at 1.25 h_max, headroom 16,
    cap_max MAX_CAP (4096, the JAX adapter's off the TPU); R x C must be
    D; the halo cap is at least 1.3 x the measured halo (plan_tile_halo)
    + 64. The windows are plan_tile_caps's + 2. host: field -> numpy
    array of the alive rows. Returns (grid, TileDomain); raises
    ValueError where R x C != D or no grid fits."""
    R, C = tile_factors(D)
    if R * C != D:
        raise ValueError(
            f"D = {D} shards do not factor as R x C tiles: R = "
            f"2^floor(floor(log2 D) / 2) = {R} and C = D // R = {C} give "
            f"R x C = {R * C} != {D} (a count that R divides runs: 2, 3, "
            f"4, 6, 8, 10, 12, ...)")
    try:
        _, grid = choose_cap_and_grid(
            box, h_max * 1.25, n_global, host["x"], host["y"], host["z"],
            cap_max=MAX_CAP, headroom=16)
    except ValueError as e:
        raise ValueError(f"{e} (the pair kernels' ceiling)") from None
    part = dict(n=grid.n, n_rows=R, n_cols=C)
    rows_cap, zcols_cap = plan_tile_caps(box, part, host["x"], host["y"],
                                         host["z"])
    halo = plan_tile_halo(box, part, host["x"], host["y"], host["z"])
    n_per = n_global / D
    return grid, TileDomain(
        n_rows=R, n_cols=C, n=grid.n,
        cap=round_up(int(n_per * 2) + 256, 8),
        halo_cap=round_up(max(int(n_per * 0.6), 256, int(halo * 1.3) + 64),
                          8),
        mig_cap=round_up(max(int(n_per * 0.25), 128), 8),
        rows_cap=rows_cap + 2, zcols_cap=zcols_cap + 2)


def distribute_tiles(ps_host: dict, box: Box, td: TileDomain,
                     mesh: SlabMesh) -> list:
    """Host-side initial distribution: the balanced tile split of the
    particles (ps_host: field -> numpy array of the alive rows), each
    shard padded to cap. Returns one Particles a shard."""
    _, _, owner = _tile_owners(box, td.n, td.n_rows, td.n_cols, td.fine,
                               ps_host["x"], ps_host["z"])
    return _shards_of(ps_host, owner, td.n_ranks, td.cap, mesh)
