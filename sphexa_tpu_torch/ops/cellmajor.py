"""Cell-major padded particle layout.

Counterpart of sphexa_tpu/ops/cellmajor.py. The search grid has one
ghost-cell layer per side; ghost cells hold pre-shifted copies of the
wrapped interior cells, so pair kernels need no periodic folding. Every
cell owns `cap` slots; per-particle fields live field-major as
[F, n_cells * cap] row stacks, so a kernel for one cell reads its 27
neighbour blocks as contiguous [F, cap] tiles.

The host planners (choose_cm_grid, choose_cap_and_grid,
choose_grid_with_hcap) stay on the host, with the cell counts in C
(util/native.py) as the JAX package counts them, and return the same
(cap, grid) as the JAX package, so both packages run on identical
frames.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import math
import os
from typing import NamedTuple

import numpy as np
import torch

from sphexa_tpu_torch.config import INDEX_DTYPE
from sphexa_tpu_torch.sfc.box import Box, normalize_coords


@dataclasses.dataclass(frozen=True)
class CMGrid:
    """Static cell-major grid description (hashable). n is the interior
    cell count in y (and x unless nxi is set); nz defaults to n."""
    n: int
    cap: int = 128
    nzi: int = 0
    nxi: int = 0

    @property
    def nz(self) -> int:
        return self.nzi if self.nzi else self.n

    @property
    def nx(self) -> int:
        return self.nxi if self.nxi else self.n

    @property
    def np_(self) -> int:  # padded cells in y
        return self.n + 2

    @property
    def npx(self) -> int:  # padded cells in x
        return self.nx + 2

    @property
    def npz(self) -> int:  # padded cells in z
        return self.nz + 2

    @property
    def n_cells(self) -> int:
        return self.npx * self.np_ * self.npz

    @property
    def n_slots(self) -> int:
        return self.n_cells * self.cap

    def padded_id(self, cx, cy, cz):
        """Row-major padded cell id from interior coords (adds ghost offset)."""
        return (((cx + 1) * self.np_) + (cy + 1)) * self.npz + (cz + 1)


class CMLayout(NamedTuple):
    src: torch.Tensor         # [n_slots] original-frame row per slot
    valid: torch.Tensor       # [n_slots] slot holds a (copy of a) real particle
    interior: torch.Tensor    # [n_slots] slot belongs to an interior cell
    shift: tuple              # (sx, sy, sz) [n_slots] ghost coordinate shifts
    ghost_pull: torch.Tensor  # [n_slots] interior source slot (identity inside)
    slot_of: torch.Tensor     # [N] slot of each particle (parked -> n_slots)
    overflow: torch.Tensor    # 0-dim: particles dropped for lack of slots


# ---------------------------------------------------------------------------
# host planners (numpy)
# ---------------------------------------------------------------------------

def choose_cm_grid(box: Box, h_max: float, n_global: int,
                   target_occupancy: float = 0.0, cap: int = 128,
                   slack: float = 1.05) -> CMGrid:
    """Interior cell count: as many cells as the 2*h_max search radius
    allows, no more than needed to keep mean occupancy near target.
    n is kept even."""
    if target_occupancy <= 0:
        target_occupancy = 0.78 * cap
    L = min(box.lx, box.ly, box.lz)
    n_corr = max(1, int(math.floor(L / (2.0 * h_max * slack))))
    vol_per_cell = target_occupancy * (box.lx * box.ly * box.lz) / max(n_global, 1)
    cell_occ = vol_per_cell ** (1.0 / 3.0)
    n_occ = max(1, int(math.ceil(L / cell_occ)))
    n = min(n_corr, max(n_occ, 1))
    if n > 1 and n % 2:
        n -= 1 if n_corr <= n else -1
        n = min(n, n_corr)
    return CMGrid(n=max(n, 1), cap=cap)


def legal_zgroup(npz: int, cap: int, max_lanes: int = 1024) -> int:
    """Largest z-group Z in (8,6,4,3,2,1) dividing npz with Z*cap a
    multiple of 128 and within max_lanes; 0 when none exists. The port
    keeps this rule of the JAX planner so both pick the same grids."""
    best = 0
    for z in (8, 6, 4, 3, 2, 1):
        if npz % z == 0 and (z * cap) % 128 == 0:
            if best == 0:
                best = z
            if z * cap <= max_lanes:
                return z
    if best:
        for z in (1, 2, 3, 4, 6, 8):
            if npz % z == 0 and (z * cap) % 128 == 0:
                return z
    return 0


def _unit_coords(xs, ys, zs, box: Box):
    """(x - xmin) / lx (and y, z) in float64: the coordinates the C
    counts bin, mapped once for a scan over resolutions."""
    return tuple(np.ascontiguousarray(
        (np.asarray(c, np.float64) - lo) / ln)
        for c, lo, ln in ((xs, box.xmin, box.lx), (ys, box.ymin, box.ly),
                          (zs, box.zmin, box.lz)))


def max_cell_count(grid: CMGrid, box: Box, xs, ys, zs) -> int:
    """Host-side: the largest per-cell particle count of the given
    (alive) positions binned into `grid`, in C (util/native.py), as the
    JAX package counts it; max_cell_count_plain is its numpy form."""
    from sphexa_tpu_torch.util import native
    return native.max_cell_count(*_unit_coords(xs, ys, zs, box),
                                 grid.nx, grid.n, grid.nz)


def max_cell_count_plain(grid: CMGrid, box: Box, xs, ys, zs) -> int:
    """numpy form of max_cell_count (the bins in float64, as in C)."""
    xs, ys, zs = (np.asarray(v, np.float64) for v in (xs, ys, zs))
    ix = np.clip(((xs - box.xmin) / box.lx * grid.nx).astype(int),
                 0, grid.nx - 1)
    iy = np.clip(((ys - box.ymin) / box.ly * grid.n).astype(int),
                 0, grid.n - 1)
    iz = np.clip(((zs - box.zmin) / box.lz * grid.nz).astype(int),
                 0, grid.nz - 1)
    cnt = np.bincount((ix * grid.n + iy) * grid.nz + iz,
                      minlength=grid.nx * grid.n * grid.nz)
    return int(cnt.max())


@functools.lru_cache(maxsize=1)
def _pool() -> concurrent.futures.ThreadPoolExecutor:
    return concurrent.futures.ThreadPoolExecutor(
        max_workers=min(8, os.cpu_count() or 1))


def _cap_for(g0: CMGrid, count: int, cap_min: int, headroom: int,
             cap_max: int) -> int:
    """The smallest legal cap for `count` particles a cell (+headroom,
    at least cap_min, a multiple of 64) on g0; past cap_max when none
    fits. It never falls as the count rises."""
    need = max(cap_min, count + headroom)
    cap = int(np.ceil(need / 64) * 64)
    while cap <= cap_max and not _cap_aligned(g0, cap):
        cap += 64
    return cap


def _cap_aligned(g0: CMGrid, cap: int) -> bool:
    """The JAX planner's (grid, cap) legality rule: cap % 128 == 0, or
    exactly 64 with an even z-group and even nz."""
    zg = legal_zgroup(g0.npz, cap)
    if zg == 0:
        return False
    if cap % 128 == 0:
        return True
    return cap == 64 and zg % 2 == 0 and g0.nz % 2 == 0


def choose_cap_and_grid(box: Box, h_eff: float, n_global: int, xs, ys, zs,
                        cap_min: int = 64, cap_max: int = 1024,
                        headroom: int = 0):
    """Jointly pick (cap, grid): scan interior resolutions n from the
    2*h_eff bound down; the realized max cell count (+headroom) sets the
    cap; return the candidate with the least n_cells * cap^2."""
    L = min(box.lx, box.ly, box.lz)
    n_corr = max(2, int(math.floor(L / (2.0 * h_eff * 1.05))))
    ns = range(n_corr, 1, -1)
    from sphexa_tpu_torch.util import native
    uvw = _unit_coords(xs, ys, zs, box)
    every8 = [np.ascontiguousarray(c[::8]) for c in uvw]

    def count(n):
        # a subset's count is a lower bound: where it already puts the cap
        # past cap_max, so would the full count (the cap rises with it)
        low = native.max_cell_count(*every8, n, n, n)
        if _cap_for(CMGrid(n=n), low, cap_min, headroom, cap_max) > cap_max:
            return low
        return native.max_cell_count(*uvw, n, n, n)

    # every resolution at once (the C counts release the GIL); the choice
    # below stays the sequential scan
    best = None
    for n, c in zip(ns, _pool().map(count, ns)):
        g0 = CMGrid(n=n)
        cap = _cap_for(g0, c, cap_min, headroom, cap_max)
        if cap > cap_max:
            continue
        g = CMGrid(n=n, cap=cap)
        cost = g.n_cells * cap * cap
        if best is None or cost < best[0]:
            best = (cost, cap, g)
    if best is None:
        raise ValueError(
            f"no (cap, grid) with a legal z-group fits these positions "
            f"below cap_max={cap_max}")
    return best[1], best[2]


def choose_grid_with_hcap(box: Box, n_global: int, xs, ys, zs,
                          cap_max: int = 128, headroom: int = 8,
                          margin: float = 1.08):
    """(cap, grid, h_cap): the coarsest resolution whose occupancy
    (+headroom) fits a legal cap <= cap_max, and the bounded smoothing
    length that grid supports (2 * h_cap * margin <= cell edge)."""
    n_max = max(4, int(math.ceil((4.0 * max(n_global, 1)) ** (1.0 / 3.0))))
    for n in range(2, n_max + 1):
        g0 = CMGrid(n=n)
        need = max(64, max_cell_count(g0, box, xs, ys, zs) + headroom)
        cap = int(np.ceil(need / 64) * 64)
        while cap <= cap_max and not _cap_aligned(g0, cap):
            cap += 64
        if cap > cap_max:
            continue
        g = CMGrid(n=n, cap=cap)
        edge = min(box.lx / g.nx, box.ly / g.n, box.lz / g.nz)
        return cap, g, edge / (2.0 * margin)
    raise ValueError(
        f"no occupancy-feasible grid with cap <= {cap_max} at any "
        f"resolution up to n={n_max}")


# ---------------------------------------------------------------------------
# static ghost maps
# ---------------------------------------------------------------------------

def _cell_coords_all(grid: CMGrid):
    """Integer coords (padded frame) of every padded cell, numpy."""
    npd, npz = grid.np_, grid.npz
    ids = np.arange(grid.n_cells)
    cz = ids % npz
    cy = (ids // npz) % npd
    cx = ids // (npz * npd)
    return cx, cy, cz


def _interior_cells_np(grid: CMGrid) -> np.ndarray:
    cx, cy, cz = _cell_coords_all(grid)
    return ((cx >= 1) & (cx <= grid.nx) & (cy >= 1) & (cy <= grid.n)
            & (cz >= 1) & (cz <= grid.nz))


def interior_mask(grid: CMGrid, device) -> torch.Tensor:
    """Static bool [n_slots]: slot belongs to an interior (non-ghost) cell."""
    return torch.tensor(np.repeat(_interior_cells_np(grid), grid.cap),
                        device=device)


class GhostStatic(NamedTuple):
    """The data-independent part of a CMLayout, fixed per (grid, box).
    Numpy arrays, read-only."""
    interior: np.ndarray
    fillable: np.ndarray
    ghost_pull: np.ndarray
    shift_x: np.ndarray
    shift_y: np.ndarray
    shift_z: np.ndarray


@functools.lru_cache(maxsize=8)
def ghost_static(grid: CMGrid, box: Box) -> GhostStatic:
    """Ghost-cell pull maps and coordinate shifts (see build_layout)."""
    n, nzc, nxc, cap, npd = grid.n, grid.nz, grid.nx, grid.cap, grid.np_
    cx, cy, cz = _cell_coords_all(grid)
    is_interior_cell = _interior_cells_np(grid)
    px, py, pz = box.periodic

    def wrap(c, periodic, nd, last):
        if periodic:
            shift = np.where(c == 0, 1, np.where(c == last - 1, -1, 0))
        else:
            shift = np.zeros_like(c)  # non-periodic ghosts stay empty
        return c + shift * nd, shift

    sxc, shx = wrap(cx, px, nxc, grid.npx)
    syc, shy = wrap(cy, py, n, npd)
    szc, shz = wrap(cz, pz, nzc, grid.npz)
    src_cell = (sxc * npd + syc) * grid.npz + szc
    fillable = (((cx >= 1) & (cx <= nxc)) | px) \
        & (((cy >= 1) & (cy <= n)) | py) & (((cz >= 1) & (cz <= nzc)) | pz)

    lane = np.arange(cap)
    gs = GhostStatic(
        interior=np.repeat(is_interior_cell, cap),
        fillable=np.repeat(fillable, cap),
        ghost_pull=(np.repeat(src_cell, cap) * cap
                    + np.tile(lane, grid.n_cells)).astype(np.int64),
        shift_x=np.repeat(-shx * box.lx, cap).astype(np.float32),
        shift_y=np.repeat(-shy * box.ly, cap).astype(np.float32),
        shift_z=np.repeat(-shz * box.lz, cap).astype(np.float32))
    for a in gs:
        a.setflags(write=False)
    return gs


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _static_rows(grid: CMGrid, box: Box, device):
    """ghost_static on `device` (interior, shift, ghost_pull, fillable),
    uploaded once per (grid, box, device): build_layout and attach_static
    read these tensors and never write them."""
    gs = ghost_static(grid, box)
    return (torch.tensor(gs.interior, device=device),
            tuple(torch.tensor(s, device=device)
                  for s in (gs.shift_x, gs.shift_y, gs.shift_z)),
            torch.tensor(gs.ghost_pull, device=device),
            torch.tensor(gs.fillable, device=device))


def build_layout(grid: CMGrid, box: Box, x, y, z, alive=None) -> CMLayout:
    """Bin particles into cell slots (stable sort by cell id) and derive
    the ghost slots. Dead rows are parked past the last cell."""
    dev = x.device
    N = x.shape[0]
    n, nzc, nxc, cap = grid.n, grid.nz, grid.nx, grid.cap

    nx, ny, nz = normalize_coords(box, x, y, z)
    ix = torch.clamp_max((nx * nxc).to(torch.int32), nxc - 1)
    iy = torch.clamp_max((ny * n).to(torch.int32), n - 1)
    iz = torch.clamp_max((nz * nzc).to(torch.int32), nzc - 1)
    cid = grid.padded_id(ix, iy, iz).to(INDEX_DTYPE)
    if alive is not None:
        cid = torch.where(alive, cid, torch.full_like(cid, grid.n_cells))

    # stable, as jnp.argsort: slot order within a cell follows row order
    order = torch.argsort(cid, stable=True)
    cid_sorted = cid[order]
    targets = torch.arange(grid.n_cells + 1, dtype=cid.dtype, device=dev)
    cell_start = torch.searchsorted(cid_sorted, targets)   # side "left"

    rank = (torch.arange(N, dtype=INDEX_DTYPE, device=dev)
            - cell_start[torch.clamp_max(cid_sorted, grid.n_cells)])
    real = cid_sorted < grid.n_cells
    ok = (rank < cap) & real
    overflow = torch.sum((rank >= cap) & real)
    slot_sorted = torch.where(ok, cid_sorted * cap + rank,
                              torch.full_like(cid_sorted, grid.n_slots))

    slot_of = torch.empty(N, dtype=INDEX_DTYPE, device=dev)
    slot_of[order] = slot_sorted

    # inverse map; parked rows all write the sentinel slot n_slots,
    # which is sliced off (the JAX package's mode="drop" scatter)
    src = torch.zeros(grid.n_slots + 1, dtype=INDEX_DTYPE, device=dev)
    src[slot_sorted] = order
    src = src[:grid.n_slots]
    valid = torch.zeros(grid.n_slots + 1, dtype=torch.bool, device=dev)
    valid[slot_sorted] = True
    valid = valid[:grid.n_slots]

    interior, shift, ghost_pull, fillable = _static_rows(grid, box, dev)
    src = torch.where(interior, src, src[ghost_pull])
    valid = torch.where(interior, valid, valid[ghost_pull] & fillable)
    return CMLayout(src=src, valid=valid, interior=interior, shift=shift,
                    ghost_pull=ghost_pull, slot_of=slot_of, overflow=overflow)


def attach_static(grid: CMGrid, box: Box, src, valid, slot_of,
                  overflow) -> CMLayout:
    """A full CMLayout from its data-dependent rows (src, valid,
    slot_of, overflow) and the static ghost maps: engines that carry
    layouts between steps carry only those four (the JAX package's
    attach_static, ops/cellmajor.py:348)."""
    interior, shift, ghost_pull, _ = _static_rows(grid, box, src.device)
    return CMLayout(src=src, valid=valid, interior=interior, shift=shift,
                    ghost_pull=ghost_pull, slot_of=slot_of,
                    overflow=overflow)


def to_cm(layout: CMLayout, field, fill=0.0):
    """Materialize a per-particle field into the cell-major frame."""
    out = field[layout.src]
    return torch.where(layout.valid, out, torch.full_like(out, fill))


def positions_cm(layout: CMLayout, x, y, z):
    """Positions with ghost shifts applied."""
    sx, sy, sz = layout.shift
    return (to_cm(layout, x) + sx, to_cm(layout, y) + sy,
            to_cm(layout, z) + sz)


def refresh_ghosts(layout: CMLayout, field):
    """The ghost slots of a cm-frame field pulled anew from their interior
    sources, after a stage computed new interior values (the periodic
    analog of a halo field refresh)."""
    return torch.where(layout.interior, field, field[layout.ghost_pull])


def from_cm(layout: CMLayout, field_cm, n: int, fill=0.0):
    """Gather a cm-frame result back to the particle frame."""
    padded = torch.cat([field_cm, field_cm.new_full((1,), fill)])
    return padded[torch.clamp_max(layout.slot_of, field_cm.shape[0])]
