"""Slab domain decomposition: z-slabs of the box, one per shard, and the
migration of particles between neighbouring slabs.

Counterpart of sphexa_tpu/domain/slab.py (SlabConfig :38, slab_of :56,
_pack :62, _pack_indices :77, HaloMaps :98, migrate :103,
exchange_halos :174, refresh_halo_fields :231). Each shard owns `cap`
particle slots (alive-masked); a particle that leaves its slab moves to
the neighbour shard on the +-1 ring, through fixed-capacity buffers of
mig_cap rows, exchanged with ShardComm.ring_pair (the two ppermutes). Every
shape is fixed and no count leaves the device.

The gather engine (propagator/ve_sharded.make_ve_step_sharded) extends
each shard's frame by the halo bands of its two neighbours
(exchange_halos: the owned rows within r_halo of the slab's faces, one
ring_pair for every field) and re-sends new payloads over the same
index maps at each stage (refresh_halo_fields), the reference's
repeated exchangeHalos calls (ve_hydro.hpp:156-187).

SlabConfig refuses n_slabs < 2. With one slab the JAX package's migrate
sends every particle to itself as well as keeping it (stay, go_r and
go_l all hold when (me +- 1) % 1 == me, slab.py:123-130): 100 random
particles come back as 164 alive and 136 lost. Its CLI adapter refuses
D < 2 (multichip.py:256-260); the port refuses it here.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from sphexa_tpu_torch.domain.mesh import ShardComm
from sphexa_tpu_torch.sfc.box import Box, Boundary
from sphexa_tpu_torch.state import _FIELDS, Particles

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class SlabConfig:
    n_slabs: int
    cap: int          # owned-particle capacity per shard
    halo_cap: int     # halo slots per side (the gather engine's)
    mig_cap: int      # migration slots per side per step

    def __post_init__(self):
        if self.n_slabs < 2:
            raise ValueError(
                f"n_slabs {self.n_slabs}: the slab domain needs at least 2 "
                f"slabs (with one, migrate would send every particle to "
                f"itself)")

    @property
    def ext(self) -> int:
        """The gather engine's extended frame: owned + left + right
        halos."""
        return self.cap + 2 * self.halo_cap


def slab_bounds(box: Box, n_slabs: int) -> float:
    """The z width of each of n_slabs slabs."""
    return box.lz / n_slabs


def slab_of(box: Box, sc: SlabConfig, z):
    """The slab of each z, in float32 as the JAX package bins it."""
    width = box.lz / sc.n_slabs
    s = torch.floor((z - box.zmin) / width).to(_I32)
    return torch.clamp(s, 0, sc.n_slabs - 1)


def _pack_pos(mask, cap: int):
    """Per row its packed position (cap where dropped), and the count."""
    pos = torch.cumsum(mask.to(_I32), 0, dtype=_I32) - 1
    pos = torch.where(mask & (pos < cap), pos, cap).to(torch.int64)
    count = torch.clamp_max(torch.sum(mask.to(_I32), dtype=_I32), cap)
    return pos, count


def _pack(mask, values_list, cap: int, fill=0.0):
    """Compact masked rows into a fixed-capacity buffer (order
    preserving). Returns (packed list, count). Rows beyond cap are
    dropped (written to a spare slot past cap)."""
    pos, count = _pack_pos(mask, cap)
    outs = []
    for v in values_list:
        buf = torch.full((cap + 1,) + tuple(v.shape[1:]), fill, dtype=v.dtype,
                         device=v.device)
        buf[pos] = v
        outs.append(buf[:cap])
    return outs, count


def _pack_indices(mask, cap: int):
    """Indices of masked rows, packed to fixed capacity. Returns
    (idx[cap], count); padding rows point at slot 0."""
    pos, count = _pack_pos(mask, cap)
    idx = torch.zeros(cap + 1, dtype=_I32, device=mask.device)
    idx[pos] = torch.arange(mask.shape[0], dtype=_I32, device=mask.device)
    return idx[:cap], count


def migrate(comm: ShardComm, ps: Particles, box: Box, sc: SlabConfig,
            extras=None):
    """Move owned particles whose z left this shard's slab to the
    adjacent shard. Runs inside SlabMesh.run, on every shard at once.

    `extras`: optional tuple of further float32 per-particle columns
    that travel with the rows (the BDT kick interval, global ids).

    Returns (particles, lost), or (particles, extras_out, lost) with
    extras; lost counts particles that had to move more than one slab
    or overflowed a capacity (must stay 0)."""
    me, D = comm.me, sc.n_slabs
    tgt = slab_of(box, sc, ps.z)
    stay = ps.alive & (tgt == me)
    go_r = ps.alive & (tgt == (me + 1) % D)
    go_l = ps.alive & (tgt == (me - 1) % D)
    if D == 2:
        # both directions reach the only neighbour: a mover travels once
        go_l = go_l & ~go_r
    lost_far = torch.sum(ps.alive & ~(stay | go_r | go_l), dtype=_I32)

    n_std = len(_FIELDS) - 1
    fields = [getattr(ps, f) for f in _FIELDS[:-1]] + list(extras or ())
    rows = torch.stack(fields)                       # [F, n]
    lane_r, n_r = _pack_pos(go_r, sc.mig_cap)
    lane_l, n_l = _pack_pos(go_l, sc.mig_cap)

    def pack(pos):
        buf = rows.new_zeros((rows.shape[0], sc.mig_cap + 1))
        buf[:, pos] = rows
        return buf[:, :sc.mig_cap]

    buf_r, buf_l = pack(lane_r), pack(lane_l)
    lost_cap = (torch.sum(go_r, dtype=_I32) - n_r
                + torch.sum(go_l, dtype=_I32) - n_l)

    # the ring exchange; with open z the wrap-around receives are dropped
    (recv_l, n_from_l), (recv_r, n_from_r) = comm.ring_pair((buf_r, n_r),
                                                            (buf_l, n_l))
    if box.bz != Boundary.periodic:
        if me == 0:
            n_from_l = torch.zeros_like(n_from_l)
        if me == D - 1:
            n_from_r = torch.zeros_like(n_from_r)

    # compact the survivors, then append what came in: the JAX package's
    # dynamic_update_slice at n_surv and n_surv + n_from_l, as index
    # arithmetic on the device
    pos_s, n_surv = _pack_pos(stay, sc.cap)
    ext = rows.new_zeros((rows.shape[0], sc.cap + 2 * sc.mig_cap))
    ext[:, pos_s] = rows
    ext[:, sc.cap] = 0.0                             # the dropped rows' slot
    lane = torch.arange(sc.mig_cap, device=rows.device)
    ext[:, n_surv + lane] = recv_l
    ext[:, n_surv + n_from_l + lane] = recv_r
    new_rows = ext[:, :sc.cap]

    n_own = n_surv + n_from_l + n_from_r
    lost_ovf = torch.clamp_min(n_own - sc.cap, 0)
    n_own = torch.clamp_max(n_own, sc.cap)
    alive = torch.arange(sc.cap, device=rows.device) < n_own
    cols = dict(zip(_FIELDS[:-1], new_rows[:n_std]))
    cols["h"] = torch.where(alive, cols["h"], 1.0)   # benign padding
    out = Particles(alive=alive, **cols)
    lost = lost_far + lost_cap + lost_ovf
    if extras is None:
        return out, lost
    return out, tuple(new_rows[n_std:]), lost


class HaloMaps(NamedTuple):
    """Index maps (in the shard's extended frame) of the per-stage halo
    refreshes."""
    send_lo_idx: torch.Tensor      # [H] owned rows of the low-z band
    send_hi_idx: torch.Tensor      # [H] owned rows of the high-z band
    n_send_lo: torch.Tensor
    n_send_hi: torch.Tensor
    halo_left_valid: torch.Tensor  # [H] the left-halo slots that hold rows
    halo_right_valid: torch.Tensor


def exchange_halos(comm: ShardComm, ps: Particles, box: Box, sc: SlabConfig,
                   r_halo):
    """The extended frame [cap + 2H]: the owned rows, then the left
    neighbour's high band and the right neighbour's low band (each
    neighbour's owned rows within r_halo of the shared face), every
    field in one ring_pair; and the maps of the later refreshes.
    r_halo: a 0-dim float32 tensor (2 h_max with slack)."""
    me, D = comm.me, sc.n_slabs
    # the slab's faces in float32, as the JAX package rounds them
    width = np.float32(box.lz / D)
    z_lo = float(np.float32(box.zmin) + width * np.float32(me))
    z_hi = float(np.float32(z_lo) + width)
    band_lo = ps.alive & (ps.z < z_lo + r_halo)
    band_hi = ps.alive & (ps.z >= z_hi - r_halo)
    if D == 2:
        # both neighbours are one shard: a row arrives there once
        band_hi = band_hi & ~band_lo
    send_lo_idx, n_send_lo = _pack_indices(band_lo, sc.halo_cap)
    send_hi_idx, n_send_hi = _pack_indices(band_hi, sc.halo_cap)

    rows = torch.stack([getattr(ps, f) for f in _FIELDS[:-1]])   # [F, cap]
    # from the left: its high band (sent right); from the right: its low
    (from_l, n_halo_l), (from_r, n_halo_r) = comm.ring_pair(
        (rows[:, send_hi_idx], n_send_hi), (rows[:, send_lo_idx], n_send_lo))
    if box.bz != Boundary.periodic:
        if me == 0:
            n_halo_l = torch.zeros_like(n_halo_l)
        if me == D - 1:
            n_halo_r = torch.zeros_like(n_halo_r)
    lane = torch.arange(sc.halo_cap, device=rows.device)
    halo_left_valid = lane < n_halo_l
    halo_right_valid = lane < n_halo_r

    ext_rows = torch.cat([rows, from_l, from_r], 1)
    ext_alive = torch.cat([ps.alive, halo_left_valid, halo_right_valid])
    cols = dict(zip(_FIELDS[:-1], ext_rows))
    cols["h"] = torch.where(ext_alive, cols["h"], 1.0)   # benign padding
    maps = HaloMaps(send_lo_idx, send_hi_idx, n_send_lo, n_send_hi,
                    halo_left_valid, halo_right_valid)
    return Particles(alive=ext_alive, **cols), maps


def refresh_halo_fields(comm: ShardComm, fields: tuple, maps: HaloMaps,
                        sc: SlabConfig, inv_perm=None) -> tuple:
    """Refresh the halo rows of per-stage fields over the extended
    frame (the reference's mid-pipeline exchangeHalos). Fields permuted
    by a cell sort take inv_perm (extended row -> sorted row), so the
    band gathers and halo writes address the right rows. All fields go
    in one ring_pair. Returns the refreshed fields, in the input's
    frame."""
    H, cap = sc.halo_cap, sc.cap
    dev = fields[0].device

    def frame(i):
        return i if inv_perm is None else inv_perm[i]

    lo_rows = frame(maps.send_lo_idx.to(torch.int64))
    hi_rows = frame(maps.send_hi_idx.to(torch.int64))
    halo_l = frame(torch.arange(cap, cap + H, device=dev))
    halo_r = frame(torch.arange(cap + H, cap + 2 * H, device=dev))
    stack = torch.stack(list(fields))
    from_l, from_r = comm.ring_pair(stack[:, hi_rows], stack[:, lo_rows])
    stack[:, halo_l] = torch.where(maps.halo_left_valid, from_l,
                                   stack[:, halo_l])
    stack[:, halo_r] = torch.where(maps.halo_right_valid, from_r,
                                   stack[:, halo_r])
    return tuple(stack.unbind(0))
