"""The port's std formulation (sphexa_tpu_torch/sph/hydro_std.py,
propagator/std.py) against the JAX package on the same inputs.

Frames: Sedov 10^3 and Noh 10^3 (open box, radial inflow), both with a
seeded position jitter and, for Sedov, random velocities, so that the
forces are real; cell_cap 128 holds their cells.
Tolerances, as tests/test_torch_gather.py holds the VE stages and step:
  - each stage (density, IAD, momentum + energy) at rtol 1e-5 of each
    output's scale (its largest magnitude over the alive rows), fed the
    JAX package's neighbour list and inputs;
  - make_std_step against the JAX make_std_step for 2 steps: max_nc and
    max_cell_count equal, dt, etot, eint and ecin at rtol 1e-5, the
    fields at 1e-4 of their scale.
The module runs on one torch thread (see tests/torch_threads.py).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.init.noh import init_noh as j_init_noh
from sphexa_tpu.init.sedov import init_sedov as j_init_sedov
from sphexa_tpu.neighbors import CellGrid as JGrid
from sphexa_tpu.neighbors import build_cell_list as j_cell_list
from sphexa_tpu.neighbors import build_neighbor_list as j_nbr_list
from sphexa_tpu.neighbors import choose_level as j_choose_level
from sphexa_tpu.propagator.std import make_std_step as j_make_std_step
from sphexa_tpu.sph import hydro_std as jh
from sphexa_tpu.sph.eos import eos_std as j_eos_std
from sphexa_tpu.sph.eos import polytropic_eos as j_polytropic
from sphexa_tpu.state import _FIELDS
from sphexa_tpu_torch.interop import (box_from_numpy, config_from_dict,
                                      state_from_numpy)
from sphexa_tpu_torch.neighbors import CellGrid
from sphexa_tpu_torch.propagator.std import make_std_step
from sphexa_tpu_torch.sph import hydro_std as th
from sphexa_tpu_torch.sph.eos import eos_std, polytropic_eos
from torch_threads import one_torch_thread  # noqa: F401

FRAMES = ("sedov", "noh")


def t(a):
    return torch.from_numpy(np.array(a))


def tbox(jb):
    return box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                           jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])


def close(what, got, want, rtol=1e-5, mask=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if mask is not None:
        got, want = got[mask], want[mask]
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rtol, f"{what}: {err:.3e} of scale > {rtol}"


def _state(name):
    if name == "sedov":
        state, box, cfg = j_init_sedov(10, JCfg(), dt0=1e-4)
    else:
        state, box, cfg = j_init_noh(10, JCfg())
    rng = np.random.default_rng(7 if name == "sedov" else 8)
    p = state.p
    n = p.x.shape[0]
    kw = {c: (np.asarray(getattr(p, c)) + 0.02 * rng.uniform(-1, 1, n))
          .astype(np.float32) for c in "xyz"}
    if name == "sedov":
        kw.update({c: (0.05 * rng.standard_normal(n)).astype(np.float32)
                   for c in ("vx", "vy", "vz")})
    state = state.replace(p=p.replace(**{k: jnp.asarray(v)
                                         for k, v in kw.items()}))
    return state, box, cfg.replace(cell_cap=128, ngpad=256,
                                   uniform_mass=True)


@functools.lru_cache(maxsize=None)
def frame(name):
    """The JAX stages' inputs and outputs on one frame."""
    state, box, cfg = _state(name)
    p = state.p
    alive = np.asarray(p.alive)
    grid = JGrid(j_choose_level(box, float(np.max(np.asarray(p.h)[alive]))
                                * 1.25))
    cl = j_cell_list(grid, box, p.x, p.y, p.z, alive=p.alive)
    ps = p.permute(cl.perm)
    nl = j_nbr_list(grid, box, cl, ps.x, ps.y, ps.z, ps.h, cfg,
                    adapt_h=True, alive=ps.alive)
    ps = ps.replace(h=nl.h)
    pos = (box, ps.x, ps.y, ps.z, ps.h)
    rho = jh.compute_density(*pos, ps.m, nl.idx, nl.nc, cfg)
    pr, c = j_eos_std(ps.temp, rho, cfg.mui, cfg.gamma)
    cij = jh.compute_iad_std(*pos, ps.m, rho, nl.idx, nl.nc, cfg)
    me = jh.compute_momentum_energy_std(box, ps.x, ps.y, ps.z, ps.vx, ps.vy,
                                        ps.vz, ps.h, ps.m, rho, pr, c, cij,
                                        nl.idx, nl.nc, cfg)
    return dict(state=state, box=box, cfg=cfg, ps=ps, nl=nl, rho=rho, p=pr,
                c=c, cij=cij, me=me)


def _inputs(f):
    ps, nl = f["ps"], f["nl"]
    d = {k: t(getattr(ps, k)) for k in ("x", "y", "z", "h", "m", "vx", "vy",
                                         "vz", "temp", "alive")}
    d.update(idx=t(nl.idx), nc=t(nl.nc),
             cfg=config_from_dict(dataclasses.asdict(f["cfg"])),
             box=tbox(f["box"]))
    return d


@pytest.mark.parametrize("name", FRAMES)
def test_density(name):
    f, d = frame(name), _inputs(frame(name))
    rho = th.compute_density(d["box"], d["x"], d["y"], d["z"], d["h"],
                             d["m"], d["idx"], d["nc"], d["cfg"])
    close(f"{name} rho", rho.numpy(), f["rho"], mask=d["alive"].numpy())


@pytest.mark.parametrize("name", FRAMES)
def test_eos_std(name):
    f, d = frame(name), _inputs(frame(name))
    p, c = eos_std(d["temp"], t(f["rho"]), d["cfg"].mui, d["cfg"].gamma)
    close(f"{name} p", p.numpy(), f["p"], rtol=1e-6)
    close(f"{name} c", c.numpy(), f["c"], rtol=1e-6)


def test_polytropic_eos():
    rho = np.geomspace(1e-2, 1e12, 257).astype(np.float32)
    for got, want in zip(polytropic_eos(t(rho)), j_polytropic(rho)):
        close("polytrope", got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("name", FRAMES)
def test_iad_std(name):
    f, d = frame(name), _inputs(frame(name))
    cij = th.compute_iad_std(d["box"], d["x"], d["y"], d["z"], d["h"],
                             d["m"], t(f["rho"]), d["idx"], d["nc"],
                             d["cfg"])
    # the IAD matrix at its own scale (the off-diagonal terms of a
    # near-lattice carry only sum-order noise)
    scale = max(np.abs(np.asarray(w)).max() for w in f["cij"])
    mask = d["alive"].numpy()
    for k, g, w in zip(("c11", "c12", "c13", "c22", "c23", "c33"), cij,
                       f["cij"]):
        err = np.abs(g.numpy()[mask] - np.asarray(w)[mask]).max() / scale
        assert err <= 1e-5, f"{name} {k}: {err:.3e}"


@pytest.mark.parametrize("name", FRAMES)
def test_momentum_energy_std(name):
    f, d = frame(name), _inputs(frame(name))
    me = th.compute_momentum_energy_std(
        d["box"], d["x"], d["y"], d["z"], d["vx"], d["vy"], d["vz"], d["h"],
        d["m"], t(f["rho"]), t(f["p"]), t(f["c"]),
        tuple(t(c) for c in f["cij"]), d["idx"], d["nc"], d["cfg"])
    mask = d["alive"].numpy()
    acc = max(np.abs(np.asarray(getattr(f["me"], k))[mask]).max()
              for k in ("ax", "ay", "az"))
    for k in ("ax", "ay", "az"):
        err = np.abs(getattr(me, k).numpy()[mask]
                     - np.asarray(getattr(f["me"], k))[mask]).max() / acc
        assert err <= 1e-5, f"{name} {k}: {err:.3e}"
    close(f"{name} du", me.du.numpy(), f["me"].du, mask=mask)
    close(f"{name} maxvsignal", me.maxvsignal.numpy(), f["me"].maxvsignal,
          mask=mask)


@pytest.mark.parametrize("name", FRAMES)
def test_std_step(name):
    js, jb, jc = _state(name)
    alive = np.asarray(js.p.alive)
    level = j_choose_level(jb, float(np.max(np.asarray(js.p.h)[alive]))
                           * 1.25)
    jstep = j_make_std_step(jb, JGrid(level), jc)
    tstep = make_std_step(tbox(jb), CellGrid(level),
                          config_from_dict(dataclasses.asdict(jc)),
                          device="cpu")
    ts = state_from_numpy({f: np.asarray(getattr(js.p, f)) for f in _FIELDS},
                          float(js.ttot), float(js.dt), float(js.dt_m1),
                          int(js.iteration), device="cpu")
    for i in range(2):
        js, jd = jstep(js)
        ts, td = tstep(ts)
        assert int(td.max_nc) == int(jd.max_nc), i
        assert int(td.max_cell_count) == int(jd.max_cell_count), i
        for k in ("dt", "etot", "eint", "ecin"):
            np.testing.assert_allclose(float(getattr(td, k)),
                                       float(getattr(jd, k)), rtol=1e-5,
                                       err_msg=f"{name} step {i} {k}")
    for c in ("x", "y", "z", "vx", "vy", "vz", "temp", "h"):
        close(f"{name} {c}", getattr(ts.p, c).numpy(), getattr(js.p, c),
              rtol=1e-4)
