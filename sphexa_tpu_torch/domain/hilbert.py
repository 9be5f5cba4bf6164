"""Hilbert-range load-balanced domain decomposition over the shards.

Counterpart of sphexa_tpu/domain/hilbert.py (reference:
domain/include/cstone/domain/assignment.hpp:55 GlobalAssignment,
domaindecomp.hpp singleRangeSfcSplit, domaindecomp_mpi.hpp:86
exchangeParticles, halos/halos.hpp:118). The mapping:

  bucket-count global octree  ->  a 2^split_bits-bin histogram of the
                                  Hilbert keys, psum'd, split at count
                                  quantiles (or, with key64, an exact
                                  60-bit radix select)
  exchangeParticles           ->  ShardComm.all_to_all of fixed-capacity
                                  per-destination buffers; a capacity
                                  overflow is counted in `lost`, which
                                  must fail-stop the run
  halo discovery              ->  coarse occupancy grids, all_gather,
                                  dilation by `dilate` coarse cells; a
                                  row goes to every shard whose dilated
                                  grid covers its coarse cell
  exchangeHalos per stage     ->  all_to_all of the packed band rows
                                  with new payloads

halo_pool = P > 0 compacts the received halo rows into P slots, so the
extended frame is cap + P whatever the shard count (the peer-economy of
the reference's findPeersMac); the pool's overflow counts into `lost`.

Every function below that takes a ShardComm runs inside SlabMesh.run.
The keys are int64 tensors holding the JAX package's uint32 values
(sfc/hilbert.py); every sort is stable where the JAX one is, so the
domains, the packed rows and the halo maps equal the JAX package's bit
for bit.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from sphexa_tpu_torch.domain.mesh import ShardComm
from sphexa_tpu_torch.domain.slab import _pack, _pack_indices
from sphexa_tpu_torch.sfc.box import Box, normalize_coords
from sphexa_tpu_torch.sfc.hilbert import MAX_LEVEL, hilbert_encode
from sphexa_tpu_torch.sfc.hilbert64 import key64_less
from sphexa_tpu_torch.state import _FIELDS, Particles

KEY_BITS = 3 * MAX_LEVEL  # 30
_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class HilbertConfig:
    n_ranks: int
    cap: int            # owned-particle capacity per shard
    halo_cap: int       # halo slots per (src, dst) pair
    mig_cap: int        # migration slots per (src, dst) pair
    split_bits: int = 13   # histogram bins = 2^split_bits
    coarse: int = 16       # coarse halo-discovery grid cells per dim
    dilate: int = 1        # halo dilation in coarse cells; complete halos
                           # need dilate * cell edge >= r_halo
    key64: bool = False    # level-20 (hi, lo) keys, exact radix splits
    halo_pool: int = 0     # 0: dense halo frame of n_ranks * halo_cap
                           # slots; P > 0: received halos compacted into
                           # P slots (overflow counts into lost)

    @property
    def n_halo_slots(self) -> int:
        """Halo slots of the extended frame."""
        return self.halo_pool or self.n_ranks * self.halo_cap

    @property
    def ext(self) -> int:
        """Extended frame: owned + (dense or pooled) halo slots."""
        return self.cap + self.n_halo_slots


def hilbert_keys(box: Box, x, y, z):
    """30-bit Hilbert keys of positions (reference: sfc/sfc.hpp:284)."""
    nx, ny, nz = normalize_coords(box, x, y, z)
    side = 1 << MAX_LEVEL

    def cell(v):
        return torch.clamp_max((v * float(side)).to(_I32), side - 1)

    return hilbert_encode(cell(nx), cell(ny), cell(nz))


def balance_splits(comm: ShardComm, keys, alive, hc: HilbertConfig):
    """The global key histogram's quantile split: shard d owns keys in
    [splits[d], splits[d+1]), splits[0] = 0, splits[D] = 2^30. The
    histogram and its cumulative sum are float32, as in the JAX package
    (exact below 2^24 particles)."""
    nbins = 1 << hc.split_bits
    shift = KEY_BITS - hc.split_bits
    hist = torch.zeros(nbins, dtype=torch.float32, device=keys.device)
    hist.index_add_(0, keys >> shift, alive.to(torch.float32))
    cum = torch.cumsum(comm.psum(hist), 0)
    d = torch.arange(1, hc.n_ranks, dtype=torch.float32, device=keys.device)
    targets = cum[-1] * d / hc.n_ranks
    cut = torch.searchsorted(cum, targets, side="left") + 1
    return torch.cat([cut.new_zeros(1), cut << shift,
                      cut.new_full((1,), 1 << KEY_BITS)])


def owner_of(keys, splits):
    """Shard owning each key (searchsorted over the inner boundaries)."""
    return torch.searchsorted(splits[1:-1].contiguous(), keys,
                              side="right").to(_I32)


def balance_splits64(comm: ShardComm, hi, lo, alive, hc: HilbertConfig):
    """Level-20 (60-bit) quantile splits by MSD radix select: six psum'd
    histograms of 10-bit windows narrow each cut to an exact 60-bit
    boundary (JAX hilbert.py:143). Returns (splits_hi, splits_lo), the
    D - 1 inner boundaries; shard d owns [split_{d-1}, split_d)."""
    D = hc.n_ranks
    ncut = D - 1
    dev = hi.device
    total = comm.psum(torch.sum(alive, dtype=_I32))
    remaining = (total * torch.arange(1, D, dtype=_I32, device=dev)) // D
    windows = [(hi >> 20) & 1023, (hi >> 10) & 1023, hi & 1023,
               (lo >> 20) & 1023, (lo >> 10) & 1023, lo & 1023]
    pm = alive[:, None].expand(alive.shape[0], ncut)
    decided = []
    for w in windows:
        hist = torch.zeros((ncut, 1024), dtype=torch.float32, device=dev)
        for c in range(ncut):
            hist[c].index_add_(0, w, pm[:, c].to(torch.float32))
        cum = torch.cumsum(comm.psum(hist), 1)
        rem_f = remaining.to(torch.float32)
        # the bin holding the remaining'th key (0-indexed) of the subset
        binsel = torch.sum(cum <= rem_f[:, None] + 0.5, 1, dtype=_I32)
        binsel = torch.clamp_max(binsel, 1023)
        below = torch.where(
            binsel > 0,
            torch.gather(cum, 1, torch.clamp_min(binsel - 1, 0)
                         .to(torch.int64)[:, None])[:, 0], 0.0)
        remaining = remaining - below.to(_I32)
        decided.append(binsel.to(torch.int64))
        pm = pm & (w[:, None] == decided[-1][None, :])
    d = decided
    return ((d[0] << 20) | (d[1] << 10) | d[2],
            (d[3] << 20) | (d[4] << 10) | d[5])


def owner_of64(hi, lo, splits_hi, splits_lo):
    """Shard owning each (hi, lo) key: keys equal to a boundary go right
    (owner_of's side='right')."""
    ge = ~key64_less(hi[:, None], lo[:, None], splits_hi[None, :],
                     splits_lo[None, :])
    return torch.sum(ge, 1, dtype=_I32)


def migrate(comm: ShardComm, ps: Particles, box: Box, splits,
            hc: HilbertConfig, owner=None):
    """Send every particle to its Hilbert-range owner in one all_to_all
    (reference: domaindecomp_mpi.hpp:86 exchangeParticles). Every shard
    is one hop away; only a capacity overflow loses rows, counted in
    `lost`. `owner` overrides the key ownership (the 64-bit splits).
    Returns (particles, lost, n_owned)."""
    me, D = comm.me, hc.n_ranks
    if owner is None:
        owner = owner_of(hilbert_keys(box, ps.x, ps.y, ps.z), splits)
    stay = ps.alive & (owner == me)
    fields = [getattr(ps, f) for f in _FIELDS[:-1]]
    dev = ps.x.device

    send, counts = [], []
    lost_cap = torch.zeros((), dtype=_I32, device=dev)
    for d in range(D):
        go = ps.alive & (owner == d) & ~stay
        buf, n_d = _pack(go, fields, hc.mig_cap)
        lost_cap = lost_cap + (torch.sum(go, dtype=_I32) - n_d)
        send.append(torch.stack(buf))                 # [F, mig_cap]
        counts.append(n_d)
    recv, counts_r = comm.all_to_all((torch.stack(send),
                                      torch.stack(counts)))

    surv, n_surv = _pack(stay, fields, hc.cap)
    # the survivors, then each source's rows at its running offset (the
    # JAX package's dynamic_update_slice chain, later sources
    # overwriting the zero tail of earlier ones)
    acc = torch.zeros((len(fields), hc.cap + D * hc.mig_cap),
                      dtype=fields[0].dtype, device=dev)
    acc[:, :hc.cap] = torch.stack(surv)
    offsets = n_surv + torch.cat([counts_r.new_zeros(1),
                                  torch.cumsum(counts_r, 0)[:-1]])
    lane = torch.arange(hc.mig_cap, device=dev)
    for d in range(D):
        acc[:, offsets[d] + lane] = recv[d]
    n_own = n_surv + torch.sum(counts_r)
    lost_ovf = torch.clamp_min(n_own - hc.cap, 0)
    n_own = torch.clamp_max(n_own, hc.cap)
    alive = torch.arange(hc.cap, device=dev) < n_own
    cols = dict(zip(_FIELDS[:-1], acc[:, :hc.cap]))
    cols["h"] = torch.where(alive, cols["h"], 1.0)
    return (Particles(alive=alive, **cols), (lost_cap + lost_ovf).to(_I32),
            n_own.to(_I32))


class HaloMaps(NamedTuple):
    send_idx: torch.Tensor    # [D, halo_cap] owned rows bound for shard d
    send_valid: torch.Tensor  # [D, halo_cap]
    pool_src: torch.Tensor    # [n_halo_slots] received row feeding each
                              # frame halo slot (identity when dense)
    pool_valid: torch.Tensor  # [n_halo_slots]
    send_lost: torch.Tensor   # per-pair capacity + pool overflow count


def _coarse_cells(box: Box, hc: HilbertConfig, x, y, z):
    G = hc.coarse
    nx, ny, nz = normalize_coords(box, x, y, z)

    def cell(v):
        return torch.clamp_max((v * G).to(_I32), G - 1)

    return (cell(nx) * G + cell(ny)) * G + cell(nz)


def discover_halos(comm: ShardComm, ps: Particles, box: Box,
                   hc: HilbertConfig) -> HaloMaps:
    """Coarse-grid halo discovery (in place of the reference's octree
    collision walk, traversal/collisions.hpp:79): shard e needs row p
    iff p's coarse cell lies in e's occupancy grid dilated by `dilate`
    cells (wrapping in every dimension; on open boundaries that only
    over-sends)."""
    G, D, me = hc.coarse, hc.n_ranks, comm.me
    dev = ps.x.device
    cid = _coarse_cells(box, hc, ps.x, ps.y, ps.z).to(torch.int64)
    occ = torch.zeros(G ** 3, dtype=torch.float32, device=dev)
    occ.index_add_(0, cid, ps.alive.to(torch.float32))
    dil = (comm.all_gather(occ) > 0).reshape(D, G, G, G)
    for ax in (1, 2, 3):
        acc = dil
        for s in range(1, hc.dilate + 1):
            acc = acc | torch.roll(dil, s, ax) | torch.roll(dil, -s, ax)
        dil = acc
    dil = dil.reshape(D, G ** 3)

    send_idx, send_valid, counts = [], [], []
    lost = torch.zeros((), dtype=_I32, device=dev)
    lane = torch.arange(hc.halo_cap, device=dev)
    for d in range(D):
        need = ps.alive & dil[d][cid] & (me != d)
        idx, n_d = _pack_indices(need, hc.halo_cap)
        lost = lost + (torch.sum(need, dtype=_I32) - n_d)
        send_idx.append(idx)
        send_valid.append(lane < n_d)
        counts.append(n_d)
    counts_r = comm.all_to_all(torch.stack(counts))
    halo_valid = (lane[None, :] < counts_r[:, None]).reshape(-1)
    if hc.halo_pool:
        pool_src, n_pool = _pack_indices(halo_valid, hc.halo_pool)
        lost = lost + (torch.sum(halo_valid, dtype=_I32) - n_pool)
        pool_valid = torch.arange(hc.halo_pool, device=dev) < n_pool
    else:
        pool_src = torch.arange(D * hc.halo_cap, dtype=_I32, device=dev)
        pool_valid = halo_valid
    return HaloMaps(send_idx=torch.stack(send_idx),
                    send_valid=torch.stack(send_valid), pool_src=pool_src,
                    pool_valid=pool_valid, send_lost=lost)


def _send_recv(comm: ShardComm, fields, maps: HaloMaps, send_rows):
    """One all_to_all of every field's halo payload; returns the
    received rows of each field in halo-slot order [F, n_halo_slots]."""
    payload = torch.stack([torch.where(maps.send_valid, f[send_rows], 0.0)
                           for f in fields], 1)        # [D, F, halo_cap]
    got = comm.all_to_all(payload)                     # [D, F, halo_cap]
    got = got.permute(1, 0, 2).reshape(len(fields), -1)
    return got[:, maps.pool_src.to(torch.int64)]


def refresh_halo_fields(comm: ShardComm, fields: tuple, maps: HaloMaps,
                        hc: HilbertConfig, inv_perm=None) -> tuple:
    """Re-send the halo bands with new payloads (the reference's
    per-stage exchangeHalos, ve_hydro.hpp:156-187). `fields` live on
    the extended frame [cap + n_halo_slots], optionally permuted (then
    pass inv_perm: extended row -> frame row). Returns new tensors."""
    def frame_rows(i):
        return i if inv_perm is None else inv_perm[i]

    send_rows = frame_rows(maps.send_idx.to(torch.int64))
    halo_rows = frame_rows(hc.cap + torch.arange(
        hc.n_halo_slots, device=maps.pool_src.device))
    got = _send_recv(comm, fields, maps, send_rows)
    out = []
    for k, f in enumerate(fields):
        f = f.clone()
        f[halo_rows] = torch.where(maps.pool_valid, got[k], f[halo_rows])
        out.append(f)
    return tuple(out)


def exchange_halos(comm: ShardComm, ps: Particles, box: Box,
                   hc: HilbertConfig):
    """The extended frame [cap + n_halo_slots] of every conserved field,
    and the maps for later refreshes."""
    maps = discover_halos(comm, ps, box, hc)
    names = _FIELDS[:-1]
    got = _send_recv(comm, [getattr(ps, f) for f in names], maps,
                     maps.send_idx.to(torch.int64))
    ext = {f: torch.cat([getattr(ps, f), got[k]])
           for k, f in enumerate(names)}
    ext_alive = torch.cat([ps.alive, maps.pool_valid])
    ext["h"] = torch.where(ext_alive, ext["h"], 1.0)
    return Particles(alive=ext_alive, **ext), maps
