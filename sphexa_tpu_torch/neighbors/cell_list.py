"""Uniform cell list over Morton-ordered cells.

Counterpart of sphexa_tpu/neighbors/cell_list.py: every particle gets
the Morton id of its cell on a 2^level grid, particles are sorted by
cell id (stable, as jnp.argsort), and cell_start gives each cell's
contiguous range of sorted rows. The permutation is bit-equal to the
JAX package's, which every later comparison of the gather path relies
on. The grid level makes the cell edge cover the search radius 2*h.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from sphexa_tpu_torch.config import INDEX_DTYPE
from sphexa_tpu_torch.sfc.box import Box, normalize_coords
from sphexa_tpu_torch.sfc.morton import morton_encode


@dataclasses.dataclass(frozen=True)
class CellGrid:
    """Static description of the search grid (hashable)."""
    level: int  # cells per dim = 2^level

    @property
    def cells_per_dim(self) -> int:
        return 1 << self.level

    @property
    def num_cells(self) -> int:
        return 1 << (3 * self.level)

    def cell_size(self, box: Box):
        n = self.cells_per_dim
        return (box.lx / n, box.ly / n, box.lz / n)


def choose_level(box: Box, h_max: float, slack: float = 1.05,
                 max_level: int = 8) -> int:
    """Largest level whose cell edge still covers the search radius 2*h_max
    (with slack for h growth between re-grids)."""
    min_len = min(box.lx, box.ly, box.lz)
    radius = 2.0 * h_max * slack
    if radius <= 0:
        return max_level
    level = int(math.floor(math.log2(max(min_len / radius, 1.0))))
    return max(1, min(level, max_level))


class CellList(NamedTuple):
    perm: torch.Tensor        # [N] particle permutation: sorted <- original
    cid: torch.Tensor         # [N] cell id per sorted particle (int64)
    cell_start: torch.Tensor  # [num_cells + 1] first sorted index per cell
    coords: tuple             # (ix, iy, iz) cell coords per sorted particle


def cell_id_of(grid: CellGrid, box: Box, x, y, z):
    nx, ny, nz = normalize_coords(box, x, y, z)
    n = grid.cells_per_dim
    ix = torch.clamp_max((nx * n).to(torch.int64), n - 1)
    iy = torch.clamp_max((ny * n).to(torch.int64), n - 1)
    iz = torch.clamp_max((nz * n).to(torch.int64), n - 1)
    return morton_encode(ix, iy, iz), (ix, iy, iz)


def build_cell_list(grid: CellGrid, box: Box, x, y, z, alive=None) -> CellList:
    """Sort particles by Morton cell id and compute per-cell ranges.

    Dead (padding) particles get cell id = num_cells so they sort to the
    end and are invisible to all candidate gathers.
    """
    cid, _ = cell_id_of(grid, box, x, y, z)
    if alive is not None:
        cid = torch.where(alive, cid, torch.full_like(cid, grid.num_cells))
    perm = torch.argsort(cid, stable=True)
    cid_sorted = cid[perm]
    targets = torch.arange(grid.num_cells + 1, dtype=cid.dtype,
                           device=cid.device)
    cell_start = torch.searchsorted(cid_sorted, targets)   # side "left"
    _, coords = cell_id_of(grid, box, x[perm], y[perm], z[perm])
    return CellList(perm.to(INDEX_DTYPE), cid_sorted,
                    cell_start.to(INDEX_DTYPE), coords)
