"""Domain facade, the cstone::Domain analog (reference:
domain/include/cstone/domain/domain.hpp:66, its sync sequence at
domain.hpp:181-195).

Counterpart of sphexa_tpu/domain/facade.py. Domain.sync() runs the
per-step domain work of one shard inside SlabMesh.run:

  Hilbert keys -> quantile splits (psum'd histograms) -> one-hop
  all_to_all migration -> halo discovery and exchange -> cell sort of
  the extended frame -> neighbour lists and the owners' h adaptation
  -> a `refresh` handle for the per-stage halo re-sends.

The propagator then runs its pair stages and calls sr.refresh(fields)
at the reference's exchange points (ve_hydro.hpp:132-205).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import torch

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.domain.hilbert import (HilbertConfig, balance_splits,
                                             balance_splits64,
                                             exchange_halos, hilbert_keys,
                                             migrate, owner_of64,
                                             refresh_halo_fields)
from sphexa_tpu_torch.domain.mesh import ShardComm
from sphexa_tpu_torch.neighbors import (CellGrid, build_cell_list,
                                        build_neighbor_list)
from sphexa_tpu_torch.sfc.box import Box
from sphexa_tpu_torch.sfc.hilbert64 import keys64_from_positions
from sphexa_tpu_torch.state import Particles


class SyncResult(NamedTuple):
    exts: Particles          # extended (owned + halo) frame, cell-sorted
    owned: torch.Tensor      # [ext] bool: row is an owned particle
    nl: Any                  # NeighborList over the extended frame
    refresh: Callable        # per-stage halo re-send (tuple -> tuple)
    ps: Particles            # owned frame after migration (for gravity)
    lost: torch.Tensor       # migration + halo capacity losses (fail-stop)
    n_owned: torch.Tensor    # this shard's owned count
    imbalance: torch.Tensor  # max shard load / ideal load
    h_max: torch.Tensor      # global h max (pmax)
    perm: torch.Tensor       # cell-sort permutation of the extended frame
    inv_perm: torch.Tensor


class Domain:
    """The Hilbert-quantile balanced domain of one (box, grid, cfg, hc).
    sync(comm, ps) runs on every shard each step (the Domain::sync
    cadence, domain.hpp:196-318)."""

    def __init__(self, box: Box, grid: CellGrid, cfg: SphConfig,
                 hc: HilbertConfig):
        self.box, self.grid, self.cfg, self.hc = box, grid, cfg, hc

    def sync(self, comm: ShardComm, ps: Particles,
             adapt_h: bool = True) -> SyncResult:
        box, grid, cfg, hc = self.box, self.grid, self.cfg, self.hc
        if hc.key64:
            hi, lo = keys64_from_positions(box, ps.x, ps.y, ps.z)
            s_hi, s_lo = balance_splits64(comm, hi, lo, ps.alive, hc)
            ps, lost_mig, n_own0 = migrate(
                comm, ps, box, None, hc, owner=owner_of64(hi, lo, s_hi,
                                                          s_lo))
        else:
            keys = hilbert_keys(box, ps.x, ps.y, ps.z)
            splits = balance_splits(comm, keys, ps.alive, hc)
            ps, lost_mig, n_own0 = migrate(comm, ps, box, splits, hc)
        imbalance = imbalance_of(comm, n_own0, hc)
        h_max = comm.pmax(torch.max(torch.where(ps.alive, ps.h, 0.0)))

        ext, maps = exchange_halos(comm, ps, box, hc)
        owned_ext = torch.cat([ps.alive, torch.zeros(
            hc.ext - hc.cap, dtype=torch.bool, device=ps.x.device)])
        cl = build_cell_list(grid, box, ext.x, ext.y, ext.z, alive=ext.alive)
        perm = cl.perm.to(torch.int64)
        exts = ext.permute(perm)
        owned = owned_ext[perm]
        inv_perm = torch.empty_like(perm)
        inv_perm[perm] = torch.arange(hc.ext, device=perm.device)
        # the owned rows only: the halo rows' lists, h and stage outputs
        # are overwritten from their owners (the JAX step searches every
        # row, its max_nc counts the halo rows too: ROADMAP Queue 3)
        nl = build_neighbor_list(grid, box, cl, exts.x, exts.y, exts.z,
                                 exts.h, cfg, adapt_h=adapt_h,
                                 alive=exts.alive,
                                 rows=torch.nonzero(owned).reshape(-1))
        refresh = functools.partial(refresh_halo_fields, comm, maps=maps,
                                    hc=hc, inv_perm=inv_perm)
        if adapt_h:
            # halo rows have incomplete neighbourhoods: keep their
            # exchanged h and pull the owners' adapted values
            (h,) = refresh((torch.where(owned, nl.h, exts.h),))
            exts = exts.replace(h=h)
        return SyncResult(exts=exts, owned=owned, nl=nl, refresh=refresh,
                          ps=ps, lost=lost_mig + maps.send_lost,
                          n_owned=n_own0, imbalance=imbalance, h_max=h_max,
                          perm=perm, inv_perm=inv_perm)


def imbalance_of(comm: ShardComm, n_own, hc: HilbertConfig):
    """Largest shard load over the ideal load."""
    return (comm.pmax(n_own).to(torch.float32) * hc.n_ranks
            / torch.clamp_min(comm.psum(n_own).to(torch.float32), 1.0))
