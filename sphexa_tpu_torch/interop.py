"""Carry the JAX package's state into the port.

The inputs are plain numpy arrays, Python numbers and dicts (for
example `dataclasses.asdict(cfg)` or `np.asarray` of each field), so
this module imports nothing of JAX. The tests use it to run both
packages on identical inputs. The JAX package's sharded state (slab or
Hilbert domain) is one global array of D x (per-shard length) rows per
field; the sharded_* functions cut it into the port's per-shard states.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.domain.hilbert import HilbertConfig
from sphexa_tpu_torch.ops.cellmajor import CMGrid
from sphexa_tpu_torch.propagator.ve_bdt import BDTState
from sphexa_tpu_torch.propagator.ve_cellmajor import RVState
from sphexa_tpu_torch.propagator.ve_tiered import TierSpec
from sphexa_tpu_torch.sfc.box import Box, Boundary
from sphexa_tpu_torch.state import _FIELDS, Particles, SimState
from sphexa_tpu_torch.util.device import resolve_device


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(device)


def config_from_dict(d: dict) -> SphConfig:
    """SphConfig from a dict of its fields (unknown keys raise)."""
    names = {f.name for f in dataclasses.fields(SphConfig)}
    extra = set(d) - names
    if extra:
        raise ValueError(f"unknown SphConfig fields: {sorted(extra)}")
    return SphConfig(**d)


def box_from_numpy(bounds, boundaries) -> Box:
    """Box from [xmin, xmax, ymin, ymax, zmin, zmax] and the three
    boundary codes (Boundary values: 0 open, 1 periodic, 2 fixed)."""
    b = [float(v) for v in np.asarray(bounds, dtype=np.float64)]
    bx, by, bz = (Boundary(int(c)) for c in boundaries)
    return Box(*b, bx, by, bz)


def hilbert_config_from(hc) -> HilbertConfig:
    """The port's HilbertConfig from the JAX package's (read by
    attribute, every field of the port's dataclass)."""
    return HilbertConfig(**{f.name: getattr(hc, f.name)
                            for f in dataclasses.fields(HilbertConfig)})


def tiers_from_numpy(tiers) -> list:
    """The port's TierSpecs from the JAX package's (read by attribute:
    h_lo, h_hi, cutoff, grid (n, cap, nzi, nxi), sub (xmin ... zmax,
    bx, by, bz) and shift). The sub-box bounds keep their scalar types
    (float32 or float64 numpy scalars, or floats), so its edge lengths
    round as they did where the tiers were planned."""
    out = []
    for t in tiers:
        g, b = t.grid, t.sub
        sub = Box(b.xmin, b.xmax, b.ymin, b.ymax, b.zmin, b.zmax,
                  *(Boundary(int(c.value)) for c in (b.bx, b.by, b.bz)))
        out.append(TierSpec(
            h_lo=t.h_lo, h_hi=t.h_hi, cutoff=t.cutoff,
            grid=CMGrid(n=g.n, cap=g.cap, nzi=g.nzi, nxi=g.nxi), sub=sub,
            shift=tuple(t.shift)))
    return out


def state_from_numpy(fields: dict, ttot, dt, dt_m1, iteration,
                     device=None) -> SimState:
    """SimState from per-particle numpy fields (all of state._FIELDS)
    and the four scalars."""
    device = resolve_device(device)
    ps = Particles(**{f: _tensor(fields[f], device) for f in _FIELDS})
    f32 = dict(dtype=torch.float32, device=device)
    return SimState(p=ps, ttot=torch.tensor(float(ttot), **f32),
                    dt=torch.tensor(float(dt), **f32),
                    dt_m1=torch.tensor(float(dt_m1), **f32),
                    iteration=torch.tensor(int(iteration), dtype=torch.int32,
                                           device=device))


def resident_from_numpy(rv_fields: dict, device=None) -> RVState:
    """RVState from every field of a resident state turned into numpy
    (rows, valid, and the 0-dim drift/overflow/ttot/dt/dt_m1/iteration)."""
    device = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(RVState):
        a = np.asarray(rv_fields[f.name])
        if f.name in ("overflow", "iteration"):
            a = a.astype(np.int32)
        kw[f.name] = _tensor(a, device)
    return RVState(**kw)


def bdt_from_numpy(fields: dict, device=None) -> BDTState:
    """BDTState from a block-time-step state turned into numpy:
    fields["rv"] holds the resident fields (as resident_from_numpy
    takes them), every other key one BDTState row or 0-dim scalar."""
    device = resolve_device(device)
    kw = {"rv": resident_from_numpy(fields["rv"], device)}
    for f in dataclasses.fields(BDTState):
        if f.name == "rv":
            continue
        a = np.asarray(fields[f.name])
        if f.name == "substep":
            a = a.astype(np.int32)
        kw[f.name] = _tensor(a, device)
    return BDTState(**kw)


def _split(a, n_slabs: int) -> list:
    """A global sharded array (length D x the per-shard length) cut into
    its D shards; a 0-dim (replicated) value is repeated."""
    a = np.asarray(a)
    if a.ndim == 0:
        return [a] * n_slabs
    if a.shape[0] % n_slabs:
        raise ValueError(f"length {a.shape[0]} does not split into "
                         f"{n_slabs} shards")
    return np.split(a, n_slabs)


def sharded_states_from_numpy(fields: dict, ttot, dt, dt_m1, iteration,
                              mesh) -> list:
    """Per-shard SimStates from the JAX package's sharded state (slab or
    Hilbert domain):
    each field of state._FIELDS a global array of D x cap rows (as
    np.asarray gives it), cut at cap, shard i on mesh.devices[i]."""
    D = mesh.n_slabs
    parts = {f: _split(fields[f], D) for f in _FIELDS}
    return [state_from_numpy({f: parts[f][i] for f in _FIELDS}, ttot, dt,
                             dt_m1, iteration, device=mesh.devices[i])
            for i in range(D)]


def sharded_bdt_from_numpy(fields: dict, mesh) -> list:
    """Per-shard BDTStates from the JAX package's ShardedBdtVE state
    turned into numpy (as bdt_from_numpy takes it): every slot row a
    global array of D x n_slots, cut at n_slots; the 0-dim scalars are
    replicated."""
    D = mesh.n_slabs
    rv = {k: _split(v, D) for k, v in fields["rv"].items()}
    rest = {k: _split(v, D) for k, v in fields.items() if k != "rv"}
    return [bdt_from_numpy(dict({k: v[i] for k, v in rest.items()},
                                rv={k: v[i] for k, v in rv.items()}),
                           device=mesh.devices[i]) for i in range(D)]
