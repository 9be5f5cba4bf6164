"""HDF5 output and checkpoint/restart.

Counterpart of sphexa_tpu/io/hdf5.py, with the same layout (reference:
main/src/io/ifile_io_hdf5.cpp:49, the H5Part convention): one group
`Step#<n>` per output step, per-particle fields as datasets, step
attributes (iteration, time, minDt, minDt_m1, ...) as length-1 arrays
on the group and run settings as file attributes, so each package and
the reference's compare_*.py tooling read the other's dumps. A dump
holding every conserved field is a checkpoint. h5py is imported inside
the functions that need it.

The upsampled restart (load_split_checkpoint, --split > 1) is the HDF5
read of load_checkpoint followed by split_state, a host function on a
state, so that a state built without h5py (on a host that lacks it)
splits the same way.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.sfc.box import Box, Boundary
from sphexa_tpu_torch.state import SimState, make_particles, make_state
from sphexa_tpu_torch.util.device import host

CONSERVED_FIELDS = ["x", "y", "z", "x_m1", "y_m1", "z_m1", "vx", "vy", "vz",
                    "temp", "h", "m", "alpha", "du_m1"]


def _scalar(v):
    """Attr value -> python scalar (accepts both plain scalars and the
    H5Part length-1 array convention)."""
    return np.asarray(v).ravel()[0]


def _attrs_from_state(state: SimState, cfg: SphConfig, n_global: int):
    return dict(iteration=int(state.iteration), time=float(state.ttot),
                minDt=float(state.dt), minDt_m1=float(state.dt_m1),
                numParticlesGlobal=n_global, ng0=cfg.ng0, ngmax=cfg.ngmax,
                gravConstant=cfg.gravG, gamma=cfg.gamma, muiConst=cfg.mui,
                Kcour=cfg.kcour, Krho=cfg.krho, alphamin=cfg.alphamin,
                alphamax=cfg.alphamax, decay_constant=cfg.decay_constant,
                sincIndex=cfg.sinc_index, eps=cfg.eps, etaAcc=cfg.eta_acc)


class HDF5Writer:
    """Step-structured writer (reference: IFileWriter, ifile_io.hpp:51)."""

    def __init__(self, path: str):
        import h5py
        self.path = path
        self._file = h5py.File(path, "a")

    def write_step(self, state: SimState, cfg: SphConfig, box: Box,
                   fields: dict | None = None, turb_state: dict | None = None,
                   bdt_state: dict | None = None):
        """Write one output step. `fields` may add derived columns
        (rho, p, ...) beyond the conserved set; turb_state and bdt_state
        persist the turbulence driver and the block-time-step rungs."""
        ps = state.p
        alive = host(ps.alive)
        n = int(alive.sum())
        step_idx = len([k for k in self._file.keys() if k.startswith("Step#")])
        g = self._file.create_group(f"Step#{step_idx}")
        for k, v in _attrs_from_state(state, cfg, n).items():
            # H5Part convention: step attributes are length-1 arrays
            # (compare_solutions.py:64 indexes attrs["time"][0])
            g.attrs[k] = np.atleast_1d(v)
        g.attrs["box"] = [box.xmin, box.xmax, box.ymin, box.ymax,
                          box.zmin, box.zmax]
        g.attrs["boundary"] = [box.bx.value, box.by.value, box.bz.value]
        for name in CONSERVED_FIELDS:
            g.create_dataset(name, data=host(getattr(ps, name))[alive])
        for name, arr in (fields or {}).items():
            g.create_dataset(name, data=host(arr)[alive])
        if turb_state is not None:
            g.create_dataset("turbulence_phases",
                             data=np.asarray(turb_state["phases"]))
            g.attrs["turbulence_rng_state"] = json.dumps(
                turb_state["rng_state"])
        if bdt_state is not None:   # timestep.h:29-34 loadOrStore analog
            for k, v in bdt_state["fields"].items():
                g.create_dataset(k, data=host(v)[alive])
            for k, v in bdt_state["attrs"].items():
                g.attrs[k] = v
        self._file.flush()
        return step_idx

    def write_file_attrs(self, settings: dict):
        for k, v in settings.items():
            self._file.attrs[k] = v

    def close(self):
        self._file.close()


class HDF5Reader:
    def __init__(self, path: str):
        import h5py
        self._file = h5py.File(path, "r")

    def num_steps(self) -> int:
        return len([k for k in self._file.keys() if k.startswith("Step#")])

    def read_step(self, step: int = -1):
        if step < 0:
            step = self.num_steps() + step
        g = self._file[f"Step#{step}"]
        fields = {k: np.asarray(g[k]) for k in g.keys()}
        attrs = dict(g.attrs)
        return fields, attrs

    def close(self):
        self._file.close()


def save_checkpoint(path: str, state: SimState, cfg: SphConfig, box: Box,
                    extra_fields: dict | None = None,
                    turb_state: dict | None = None):
    w = HDF5Writer(path)
    try:
        return w.write_step(state, cfg, box, extra_fields,
                            turb_state=turb_state)
    finally:
        w.close()


def _step_group(f, step: int):
    """Group of output step `step` (negative counts from the last), the
    step HDF5Reader.read_step reads. Ordered by step number: the JAX
    package sorts the names as strings, so from 11 steps on its
    load_bdt_state and load_turbulence_state read another step than
    its load_checkpoint ("Step#9" sorts after "Step#10")."""
    steps = sorted((k for k in f.keys() if k.startswith("Step#")),
                   key=lambda k: int(k[5:]))
    return f[steps[step]]


def load_bdt_state(path: str, step: int = -1):
    """Block-time-step rung state of a dump, or None (reference:
    sph/timestep.h:29-34 Timestep::loadOrStore)."""
    import h5py

    with h5py.File(path, "r") as f:
        g = _step_group(f, step)
        if "bdt_rung" not in g:
            return None
        return dict(rung=np.asarray(g["bdt_rung"]),
                    dt_m1k=np.asarray(g["bdt_dt_m1k"]),
                    dt_min=float(_scalar(g.attrs["bdt_dt_min"])),
                    num_rungs=int(_scalar(g.attrs["bdt_num_rungs"])))


def load_turbulence_state(path: str, step: int = -1):
    """The turbulence OU driver state of a dump, or None."""
    import h5py

    with h5py.File(path, "r") as f:
        g = _step_group(f, step)
        if "turbulence_phases" not in g:
            return None
        return dict(phases=np.asarray(g["turbulence_phases"]),
                    rng_state=json.loads(g.attrs["turbulence_rng_state"]))


def load_checkpoint(path: str, cfg: SphConfig, step: int = -1,
                    capacity: int | None = None, device=None):
    """Restart from a dump (reference: init/file_init.hpp:75 FileInit),
    on `device` (default: the GPU)."""
    r = HDF5Reader(path)
    try:
        fields, attrs = r.read_step(step)
    finally:
        r.close()

    n = len(fields["x"])
    kw = {k: fields[k] for k in CONSERVED_FIELDS if k in fields}
    ps = make_particles(capacity or n, n, device=device, **kw)
    state = make_state(ps, dt0=float(_scalar(attrs["minDt"])),
                       ttot=float(_scalar(attrs["time"])))
    state = state.replace(
        dt_m1=torch.tensor(float(_scalar(attrs["minDt_m1"])),
                           dtype=torch.float32, device=ps.device),
        iteration=torch.tensor(int(_scalar(attrs["iteration"])),
                               dtype=torch.int32, device=ps.device))

    b = attrs["box"]
    bd = [Boundary(int(v)) for v in attrs["boundary"]]
    box = Box(float(b[0]), float(b[1]), float(b[2]), float(b[3]),
              float(b[4]), float(b[5]), bd[0], bd[1], bd[2])
    m = np.asarray(fields["m"]) if "m" in fields else np.ones(1)
    cfg = cfg.replace(ng0=int(_scalar(attrs["ng0"])),
                      ngmax=int(_scalar(attrs["ngmax"])),
                      gamma=float(_scalar(attrs["gamma"])),
                      mui=float(_scalar(attrs["muiConst"])),
                      gravG=float(_scalar(attrs["gravConstant"])),
                      kcour=float(_scalar(attrs["Kcour"])),
                      krho=float(_scalar(attrs["Krho"])),
                      uniform_mass=bool(m.min() == m.max()))
    return state, box, cfg


def split_state(state: SimState, box: Box, num_splits: int,
                capacity: int | None = None) -> SimState:
    """The FileSplitInit analog (reference: main/src/init/
    file_init.hpp:103-235) on a state: each alive particle becomes
    `num_splits` particles placed along the Hilbert curve between its
    key and its successor's (the last particle interpolates backward);
    m scales 1/S, h 1/cbrt(S), velocities/temp/alpha replicate, the
    Press-2 history resets (du_m1 = 0, x_m1 = v*dt), and dt shrinks by
    100*S for a gentle re-equilibration; iteration restarts at 1. Runs
    on the host in numpy (the keys by sfc/hilbert.py on CPU tensors), as
    the JAX load_split_checkpoint (io/hdf5.py:185-245) does, and returns
    the new state on the state's device."""
    from sphexa_tpu_torch.sfc.hilbert import (MAX_LEVEL, hilbert_decode,
                                              hilbert_encode)

    S = int(num_splits)
    if S < 1:
        raise ValueError(f"num_splits {num_splits} < 1")
    ps = state.p
    alive = host(ps.alive)
    f = {k: host(getattr(ps, k))[alive] for k in CONSERVED_FIELDS}
    n0 = f["x"].shape[0]

    side = 1 << MAX_LEVEL
    to_i = lambda v, lo, L: np.clip(((v - lo) / L * side).astype(np.int64),
                                    0, side - 1)
    keys = host(hilbert_encode(*(torch.from_numpy(v) for v in (
        to_i(f["x"], box.xmin, box.lx), to_i(f["y"], box.ymin, box.ly),
        to_i(f["z"], box.zmin, box.lz))))).astype(np.int64)
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    f = {k: v[order] for k, v in f.items()}

    # clone keys interpolate toward the next particle's key (the last
    # particle interpolates backward, as the reference does)
    delta = np.empty(n0, np.int64)
    delta[:-1] = (keys[1:] - keys[:-1]) // S
    delta[-1] = -(keys[-1] - keys[-2]) // (S + 1) if n0 > 1 else 0
    j = np.arange(S)
    ck = (keys[:, None] + delta[:, None] * j[None, :]).reshape(-1)
    ck = np.clip(ck, 0, (1 << (3 * MAX_LEVEL)) - 1)
    ix, iy, iz = (host(v) for v in hilbert_decode(torch.from_numpy(ck)))
    x = (box.xmin + ix.astype(np.float64) * box.lx / side).astype(np.float32)
    y = (box.ymin + iy.astype(np.float64) * box.ly / side).astype(np.float32)
    z = (box.zmin + iz.astype(np.float64) * box.lz / side).astype(np.float32)
    # the original particle keeps its exact position (clone j = 0)
    x[::S], y[::S], z[::S] = f["x"], f["y"], f["z"]

    rep = lambda v, scale=1.0: np.repeat(v * scale, S)
    n = n0 * S
    dt = float(state.dt) / (100.0 * S)
    fields = dict(
        x=x, y=y, z=z, m=rep(f["m"], 1.0 / S),
        h=rep(f["h"], S ** (-1.0 / 3.0)),
        vx=rep(f["vx"]), vy=rep(f["vy"]), vz=rep(f["vz"]),
        temp=rep(f["temp"]), alpha=rep(f["alpha"]),
        du_m1=np.zeros(n, np.float32))
    fields["x_m1"] = fields["vx"] * dt
    fields["y_m1"] = fields["vy"] * dt
    fields["z_m1"] = fields["vz"] * dt
    ps = make_particles(capacity or n, n, device=state.p.device, **fields)
    # make_state sets dt_m1 = dt and iteration 1, as the JAX loader does
    return make_state(ps, dt0=dt, ttot=float(state.ttot))


def load_split_checkpoint(path: str, cfg: SphConfig, num_splits: int,
                          step: int = -1, capacity: int | None = None,
                          device=None):
    """Upsampled restart (--split > 1): load_checkpoint, then
    split_state on the loaded state (JAX io/hdf5.py:185-245). Returns
    (state, box, cfg) on `device` (default: the GPU)."""
    state, box, cfg = load_checkpoint(path, cfg, step=step, device=device)
    return split_state(state, box, num_splits, capacity=capacity), box, cfg
