"""Host-side set-up of the slab-sharded engines: distribution of the
particles into slabs, and the slab planner.

Counterpart of `distribute` in sphexa_tpu/propagator/ve_sharded.py
(:196-234) and of `MultiChipAdapter._slab_setup` in
sphexa_tpu/propagator/multichip.py (:243-300), as the host function
plan_slab. The XLA gather engine of ve_sharded (make_ve_step_sharded,
exchange_halos) and the CLI adapter are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from sphexa_tpu_torch.domain.mesh import SlabMesh
from sphexa_tpu_torch.domain.slab import SlabConfig
from sphexa_tpu_torch.ops.cellmajor import CMGrid, choose_cm_grid
from sphexa_tpu_torch.sfc.box import Box
from sphexa_tpu_torch.state import _FIELDS, Particles


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


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


def plan_slab(host: dict, box: Box, h_max: float, n_slabs: int):
    """Slab-domain sizing of the slab-sharded engines (the JAX adapter's
    _slab_setup): halve n_slabs while a slab is thinner than 2 h_max
    (the one-plane z exchange must cover the search radius), the global
    grid of choose_cm_grid split into n // D z-planes a shard, the cell
    cap from the measured occupancy, and the slab caps from the measured
    slab counts. host: numpy arrays of the alive particles. Returns
    (local grid, SlabConfig); the SlabConfig's n_slabs is the D used."""
    D = n_slabs
    while D > 1 and box.lz / D < 2.0 * h_max * 1.05:
        D //= 2
    if D < 2:
        raise ValueError(f"slab width {box.lz:.4g}/D < 2*h_max "
                         f"{2 * h_max:.4g} even at D=2: problem too small "
                         f"for the slab-sharded engine")
    n_global = len(host["x"])
    n_per = n_global / D

    gref = choose_cm_grid(box, h_max * 1.25, n_global)
    nz_local = max(gref.n // D, 1)
    if box.lz / (D * nz_local) < 2.0 * h_max:
        nz_local = max(int(box.lz / D / (2.0 * h_max * 1.05)), 1)
    gx = np.clip(((host["x"] - box.xmin) / box.lx * gref.n)
                 .astype(np.int64), 0, gref.n - 1)
    gy = np.clip(((host["y"] - box.ymin) / box.ly * gref.n)
                 .astype(np.int64), 0, gref.n - 1)
    gz = np.clip(((host["z"] - box.zmin) / box.lz * D * nz_local)
                 .astype(np.int64), 0, D * nz_local - 1)
    cell = (gx * gref.n + gy) * (D * nz_local) + gz
    max_occ = int(np.bincount(cell).max())
    cap_cm = max(128, round_up(int(max_occ * 1.3) + 8, 128))
    grid = CMGrid(n=gref.n, cap=cap_cm, nzi=nz_local)

    # binned in the host arrays' own type, as the adapter does
    slab = np.clip(((host["z"] - box.zmin) / (box.lz / D))
                   .astype(np.int64), 0, D - 1)
    max_cnt = int(np.bincount(slab, minlength=D).max())
    sc = SlabConfig(
        n_slabs=D, cap=round_up(int(max_cnt * 1.5) + 64, 8),
        halo_cap=round_up(int(max_cnt * 0.6) + 64, 8),
        mig_cap=round_up(max(int(n_per * 0.25), 128), 8))
    return grid, sc
