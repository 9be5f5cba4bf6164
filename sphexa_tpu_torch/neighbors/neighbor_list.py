"""Fixed-width padded neighbour lists with coupled h adaptation.

Counterpart of sphexa_tpu/neighbors/neighbor_list.py (reference:
sph/include/sph/find_neighbors.hpp:10-44): candidates are gathered from
the 27 cells around each particle's cell, distances are computed once
and reused across the h iteration (h only moves the filter radius), and
the surviving neighbours are compacted, in candidate order, into an
[N, K] index matrix that every pair stage of the gather path reads.

The JAX package maps over i-chunks with lax.map and iterates h with
fori_loop; here both are Python loops over chunks of cfg.chunk rows and
cfg.h_iter passes. The last chunk is short instead of repeating row N-1:
every row's result depends on that row alone, so the outputs are the
same. The index matrix is int32, as in the JAX package (at 10^6 rows
and K = 160 it is 640 MB).

The h controller follows the reference policy: iterate while
nc_sph < ng0/4 or nc_sph - 1 > ngmax (kernels.hpp:27,
find_neighbors.hpp:17-35).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.neighbors.cell_list import CellGrid, CellList
from sphexa_tpu_torch.sfc.box import Box, fold
from sphexa_tpu_torch.sfc.morton import morton_encode
from sphexa_tpu_torch.sph.kernels import update_h

_OFFSETS = [(ox, oy, oz) for ox in (-1, 0, 1) for oy in (-1, 0, 1)
            for oz in (-1, 0, 1)]


class NeighborList(NamedTuple):
    idx: torch.Tensor      # [N, K] int32 neighbour rows (sorted frame), padded
    nc: torch.Tensor       # [N] neighbours in the list (excl. self, <= K)
    nc_sph: torch.Tensor   # [N] true neighbour count + 1 (self), uncapped
    h: torch.Tensor        # [N] possibly h-adapted smoothing lengths
    max_cell_count: torch.Tensor  # 0-dim: cell_cap overflow if > cap
    max_nc: torch.Tensor          # 0-dim: list overflow if > K


def _neighbor_cell_ids(grid: CellGrid, box: Box, ix, iy, iz):
    """Morton ids of the 27 surrounding cells, and whether each exists
    (out-of-range cells on non-periodic dimensions do not). Returns
    ([..., 27] ids, [..., 27] valid)."""
    n = grid.cells_per_dim
    px, py, pz = box.periodic
    ids = []
    valids = []
    for ox, oy, oz in _OFFSETS:
        jx, jy, jz = ix + ox, iy + oy, iz + oz
        valid = torch.ones(jx.shape, dtype=torch.bool, device=jx.device)
        for j, per in ((jx, px), (jy, py), (jz, pz)):
            if not per:
                valid &= (j >= 0) & (j < n)
        # & (n - 1) wraps periodic dimensions and maps the out-of-range
        # cells of open ones to any in-range id (they are invalid)
        ids.append(morton_encode(jx & (n - 1), jy & (n - 1), jz & (n - 1)))
        valids.append(valid)
    ids = torch.stack(ids, dim=-1)
    valid = torch.stack(valids, dim=-1)
    if n < 3 and (px or py or pz):
        # with < 3 cells per periodic dim, offsets -1 and +1 alias to the
        # same cell: invalidate duplicate ids (keep the first occurrence)
        dup = ids[..., :, None] == ids[..., None, :]
        earlier = torch.tril(torch.ones((27, 27), dtype=torch.bool,
                                        device=ids.device), diagonal=-1)
        valid &= ~torch.any(dup & earlier & valid[..., None, :], dim=-1)
    return ids, valid


def build_neighbor_list(grid: CellGrid, box: Box, cl: CellList,
                        x, y, z, h, cfg: SphConfig,
                        adapt_h: bool = True, alive=None,
                        rows=None) -> NeighborList:
    """x, y, z, h must already be in cell-sorted order (cl.perm applied).
    `alive` (sorted frame) excludes padding rows from search, h adaptation
    and the overflow diagnostics. `rows` (an index of sorted-frame rows)
    limits the candidate search to those rows: every other row gets a
    dead row's outputs (no neighbour, nc 0, h as given) and max_nc
    counts the searched rows only, while max_cell_count still covers
    every row's neighbour cells. The Hilbert domain passes its owned
    rows, since the lists of its halo rows would be discarded."""
    N = x.shape[0]
    C = min(cfg.chunk, N)
    K = cfg.ngpad
    CAP = cfg.cell_cap
    M = 27 * CAP
    dev = x.device

    ix, iy, iz = cl.coords
    cell_start = cl.cell_start
    px, py, pz = box.periodic
    lx, ly, lz = box.lengths
    lane = torch.arange(CAP, dtype=cell_start.dtype, device=dev)
    ngmin = cfg.ng0 // 4

    R = N if rows is None else rows.numel()
    idx_out, nc_out, nc_sph_out, h_out, max_cells = [], [], [], [], []
    for c0 in range(0, R, C):
        i_idx = (torch.arange(c0, min(c0 + C, N), device=dev) if rows is None
                 else rows[c0:c0 + C].to(torch.int64))
        ci = i_idx.shape[0]
        xi, yi, zi, hi = x[i_idx], y[i_idx], z[i_idx], h[i_idx]

        nb_ids, nb_valid = _neighbor_cell_ids(
            grid, box, ix[i_idx], iy[i_idx], iz[i_idx])      # [C, 27]
        starts = cell_start[nb_ids]
        sizes = cell_start[nb_ids + 1] - starts
        counts = torch.where(nb_valid, torch.clamp_max(sizes, CAP), 0)

        cand = starts[:, :, None] + lane                      # [C, 27, CAP]
        cand_valid = lane < counts[:, :, None]
        cand = torch.where(cand_valid, cand, 0).reshape(ci, M)
        cand_valid = cand_valid.reshape(ci, M)

        rx = fold(xi[:, None] - x[cand], lx, px)             # [C, M]
        ry = fold(yi[:, None] - y[cand], ly, py)
        rz = fold(zi[:, None] - z[cand], lz, pz)
        d2 = rx * rx + ry * ry + rz * rz

        base_valid = cand_valid & (cand != i_idx[:, None])
        if alive is not None:
            i_alive = alive[i_idx]
            base_valid &= i_alive[:, None]

        def count_nc(hh):
            r2 = (2.0 * hh) ** 2
            return torch.sum(base_valid & (d2 < r2[:, None]), dim=1,
                             dtype=torch.int32)

        if adapt_h:
            for _ in range(cfg.h_iter):
                nc_true = count_nc(hi)
                nc_sph = nc_true + 1
                need = (nc_sph < ngmin) | (nc_true > cfg.ngmax)
                if alive is not None:
                    need &= i_alive
                hi = torch.where(need, update_h(cfg.ng0, nc_sph, hi,
                                                h_cap=cfg.h_cap), hi)

        nc_true = count_nc(hi)
        valid = base_valid & (d2 < ((2.0 * hi) ** 2)[:, None])

        # compact valid candidates into the first K slots, in order;
        # column K takes the dropped ones and is sliced off
        pos = torch.cumsum(valid, dim=1) - 1
        pos = torch.where(valid & (pos < K), pos, K)
        out = torch.zeros((ci, K + 1), dtype=torch.int32, device=dev)
        out.scatter_(1, pos, cand.to(torch.int32))

        idx_out.append(out[:, :K])
        nc_out.append(torch.clamp_max(nc_true, K))
        nc_sph_out.append(nc_true + 1)
        h_out.append(hi)
        max_cells.append(torch.max(torch.where(nb_valid, sizes, 0)))

    if rows is None:
        nc_sph = torch.cat(nc_sph_out)
        return NeighborList(torch.cat(idx_out), torch.cat(nc_out), nc_sph,
                            torch.cat(h_out),
                            torch.max(torch.stack(max_cells)).to(torch.int32),
                            torch.max(nc_sph - 1))

    # the rows not searched: a dead row's outputs; every row's neighbour
    # cells enter max_cell_count
    rows = rows.to(torch.int64)
    i32 = dict(dtype=torch.int32, device=dev)
    idx = torch.zeros((N, K), **i32)
    nc = torch.zeros(N, **i32)
    nc_sph = torch.ones(N, **i32)
    h_all = h.clone()
    if R:
        idx[rows] = torch.cat(idx_out)
        nc[rows] = torch.cat(nc_out)
        nc_sph[rows] = torch.cat(nc_sph_out)
        h_all[rows] = torch.cat(h_out)
    # the neighbour cells of every row's cell: once a distinct cell
    n = grid.cells_per_dim
    cells = torch.unique((ix * n + iy) * n + iz)
    nb_ids, nb_valid = _neighbor_cell_ids(grid, box, cells // (n * n),
                                          (cells // n) % n, cells % n)
    sizes = cell_start[nb_ids + 1] - cell_start[nb_ids]
    return NeighborList(idx, nc, nc_sph, h_all,
                        torch.max(torch.where(nb_valid, sizes, 0))
                        .to(torch.int32),
                        torch.max(nc_sph - 1))


def gather_nbr(field, idx):
    """Gather a per-particle field over the [N, K] neighbour index matrix."""
    return field[idx]
