"""The port's slab gather engine against the JAX package's: the slab
halo bands (domain/slab.exchange_halos, refresh_halo_fields) and the
sharded gather step (propagator/ve_sharded.make_ve_step_sharded).

The JAX side runs under jax.jit(jax.shard_map) on the conftest's
virtual CPU devices (the gather step is plain XLA, no Pallas); the port
runs its shards as SlabMesh threads on the CPU, under two torch
threads.

1. exchange_halos and refresh_halo_fields at D = 2, periodic and open
   z, on seeded random particles: the extended frames, the maps and the
   refreshed fields (through a random cell-sort permutation) bit-equal.
2. make_ve_step_sharded at Sedov 12^3, D = 2 (the size of the JAX
   package's tests/test_sharded.py), 2 steps from the same distributed
   state: lost, n_owned and max_nc exact; dt, ttot, etot, eint, h_max
   and halo_frac at rtol 1e-5, ecin at 1e-4 (a sum of squares of
   velocities that start at 0); each shard's alive rows row for row
   (the port's migrate and cell sort keep JAX's row order), every field
   within 1e-5 of its scale.
3. One step at Evrard 12 (self-gravity through the gathered direct sum,
   the open z of the slabs), the same checks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.domain import slab as jslab
from sphexa_tpu.init.evrard import init_evrard as j_init_evrard
from sphexa_tpu.init.sedov import init_sedov as j_init_sedov
from sphexa_tpu.neighbors import CellGrid as JCellGrid, choose_level
from sphexa_tpu.propagator.ve_sharded import (
    distribute as j_distribute, make_ve_step_sharded as j_make_step)
from sphexa_tpu.sfc.box import Box as JBox, Boundary as JB
from sphexa_tpu.state import Particles as JParticles, SimState as JSimState
from sphexa_tpu.state import _FIELDS
from sphexa_tpu_torch.domain import slab as tslab
from sphexa_tpu_torch.domain.mesh import SlabMesh
from sphexa_tpu_torch.domain.slab import SlabConfig
from sphexa_tpu_torch.interop import (box_from_numpy, config_from_dict,
                                      sharded_states_from_numpy)
from sphexa_tpu_torch.neighbors import CellGrid
from sphexa_tpu_torch.propagator.ve_sharded import make_ve_step_sharded
from sphexa_tpu_torch.state import Particles
from torch_threads import two_torch_threads  # noqa: F401

AXIS = jslab.AXIS
D = 2
ROWS = ("x", "y", "z", "x_m1", "y_m1", "z_m1", "vx", "vy", "vz", "temp",
        "h", "alpha", "du_m1")


def _tbox(jb):
    return box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                           jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])


def _jmesh():
    return Mesh(np.array(jax.devices()[:D]), (AXIS,))


# ---------------------------------------------------------------------------
# the halo bands
# ---------------------------------------------------------------------------

def _slab_particles(cap, seed):
    """Seeded rows in each shard's slab, about half of cap alive."""
    r = np.random.default_rng(seed)
    cols = {f: r.normal(0, 1, D * cap).astype(np.float32)
            for f in _FIELDS[:-1]}
    alive = np.zeros(D * cap, bool)
    for s in range(D):
        k = int(r.integers(cap // 3, 2 * cap // 3))
        sl = slice(s * cap, s * cap + k)
        alive[sl] = True
        cols["x"][sl] = r.uniform(-0.5, 0.5, k)
        cols["y"][sl] = r.uniform(-0.5, 0.5, k)
        cols["z"][sl] = (-0.5 + (s + r.uniform(0, 1, k)) / D).clip(
            -0.5, 0.5 - 1e-6)
        cols["h"][sl] = np.abs(cols["h"][sl]) + 0.1
    return cols, alive


@pytest.mark.parametrize("bz", [JB.periodic, JB.open], ids=["per", "open"])
def test_exchange_and_refresh_bit_equal(bz):
    """The extended frame, its maps and two refreshed fields (through a
    seeded permutation of the extended frame) bit-equal; some halo rows
    arrive on both sides, and on an open z the outer faces get none."""
    cap, H = 64, 40
    jb = JBox(-0.5, 0.5, -0.5, 0.5, -0.5, 0.5, JB.periodic, JB.periodic, bz)
    sc = jslab.SlabConfig(n_slabs=D, cap=cap, halo_cap=H, mig_cap=16)
    cols, alive = _slab_particles(cap, seed=11)
    r = np.random.default_rng(12)
    ext = cap + 2 * H
    perm = np.concatenate([r.permutation(ext) for _ in range(D)])
    inv = np.concatenate([np.argsort(perm[s * ext:(s + 1) * ext])
                          for s in range(D)])
    fields = [r.normal(0, 1, D * ext).astype(np.float32) for _ in range(2)]
    r_halo = np.float32(0.15)

    mesh = _jmesh()
    sh = NamedSharding(mesh, P(AXIS))
    ps = JParticles(alive=jax.device_put(alive, sh),
                    **{f: jax.device_put(cols[f], sh) for f in cols})
    spec = JParticles(**{f: P(AXIS) for f in _FIELDS})

    def local(p, f0, f1, pm, ip):
        e, maps = jslab.exchange_halos(p, jb, sc, jnp.float32(r_halo))
        ref = jslab.refresh_halo_fields((f0, f1), maps, sc, perm=pm,
                                        inv_perm=ip)
        return e, tuple(m if m.ndim else m[None] for m in maps), ref

    fn = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(spec,) + (P(AXIS),) * 4,
        out_specs=(spec, (P(AXIS),) * 6, (P(AXIS), P(AXIS))),
        check_vma=False))
    je, jmaps, jref = fn(ps, *(jax.device_put(a, sh) for a in
                               (*fields, perm.astype(np.int32),
                                inv.astype(np.int32))))

    tsc = SlabConfig(**dataclasses.asdict(sc))
    box = _tbox(jb)

    def part(a, s, n):
        return torch.from_numpy(np.ascontiguousarray(a[s * n:(s + 1) * n]))

    def run(comm, p, f0, f1, ip):
        e, maps = tslab.exchange_halos(comm, p, box, tsc,
                                       torch.tensor(r_halo))
        return e, maps, tslab.refresh_halo_fields(comm, (f0, f1), maps, tsc,
                                                  inv_perm=ip)

    res = SlabMesh(D, devices=["cpu"]).run(
        run, [Particles(alive=part(alive, s, cap),
                        **{f: part(cols[f], s, cap) for f in cols})
              for s in range(D)],
        *([part(f, s, ext) for s in range(D)] for f in fields),
        [part(inv, s, ext).to(torch.int64) for s in range(D)])
    for f in _FIELDS:
        np.testing.assert_array_equal(
            np.concatenate([getattr(x[0], f).numpy() for x in res]),
            np.asarray(getattr(je, f)), err_msg=f)
    for k, name in enumerate(tslab.HaloMaps._fields):
        np.testing.assert_array_equal(
            np.concatenate([np.atleast_1d(x[1][k].numpy()) for x in res]),
            np.asarray(jmaps[k]), err_msg=name)
    for k in range(2):
        np.testing.assert_array_equal(
            np.concatenate([x[2][k].numpy() for x in res]),
            np.asarray(jref[k]))
    valid = np.asarray(jmaps[4]).reshape(D, H), np.asarray(
        jmaps[5]).reshape(D, H)
    assert valid[0].sum() > 0 and valid[1].sum() > 0
    if bz == JB.open:
        assert not valid[0][0].any() and not valid[1][D - 1].any()


# ---------------------------------------------------------------------------
# the sharded gather step
# ---------------------------------------------------------------------------

def _run_both(state, jb, cfg, grid_h, sc, steps):
    host = {f: np.asarray(getattr(state.p, f))[np.asarray(state.p.alive)]
            for f in _FIELDS[:-1]}
    mesh = _jmesh()
    js = JSimState(p=j_distribute(host, jb, sc, mesh), ttot=state.ttot,
                   dt=state.dt, dt_m1=state.dt_m1, iteration=state.iteration)
    level = choose_level(jb, grid_h)
    tmesh = SlabMesh(D, devices=["cpu"])
    ts = sharded_states_from_numpy(
        {f: np.asarray(getattr(js.p, f)) for f in _FIELDS},
        float(state.ttot), float(state.dt), float(state.dt_m1),
        int(state.iteration), tmesh)
    jstep = j_make_step(jb, JCellGrid(level), cfg, sc, mesh)
    tstep = make_ve_step_sharded(
        _tbox(jb), CellGrid(level), config_from_dict(dataclasses.asdict(cfg)),
        SlabConfig(**dataclasses.asdict(sc)), tmesh)
    jd, td = [], []
    for _ in range(steps):
        js, d = jstep(js)
        jd.append({k: float(v) for k, v in d._asdict().items()})
        ts, d = tstep(ts)
        td.append({k: float(v) for k, v in d._asdict().items()})
    jf = {f: np.split(np.asarray(getattr(js.p, f)), D) for f in _FIELDS}
    tf = {f: [getattr(s.p, f).numpy() for s in ts] for f in _FIELDS}
    return dict(jd=jd, td=td, jf=jf, tf=tf, n=len(host["x"]))


@pytest.fixture(scope="module")
def sedov():
    state, jb, cfg = j_init_sedov(12, JCfg(chunk=512, cell_cap=256,
                                           ngpad=256), dt0=2e-4)
    n = 12 ** 3
    sc = jslab.SlabConfig(n_slabs=D, cap=int(n / D * 2.5) + 64,
                          halo_cap=int(n / D * 2.0) + 64, mig_cap=256)
    return _run_both(state, jb, cfg, float(state.p.h[0]) * 1.4, sc, 2)


@pytest.fixture(scope="module")
def evrard():
    state, jb, cfg = j_init_evrard(12, JCfg(chunk=512, cell_cap=256,
                                           ngpad=256), dt0=1e-4)
    assert cfg.gravG != 0.0
    h = np.asarray(state.p.h)[np.asarray(state.p.alive)]
    n = int(np.asarray(state.p.alive).sum())
    sc = jslab.SlabConfig(n_slabs=D, cap=n + 64, halo_cap=n + 64,
                          mig_cap=256)
    return _run_both(state, jb, cfg, float(h.max()) * 1.3, sc, 1)


def _check_diag(run, step):
    a, b = run["jd"][step], run["td"][step]
    for k in ("lost", "n_owned", "max_nc"):
        assert b[k] == a[k], k
    assert b["lost"] == 0 and b["halo_frac"] < 1.0
    for k in ("dt", "ttot", "etot", "eint", "h_max", "halo_frac"):
        np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(b["ecin"], a["ecin"], rtol=1e-4)
    assert b["max_cell_count"] <= 256


def _check_rows(run, shard):
    ja, ta = run["jf"]["alive"][shard], run["tf"]["alive"][shard]
    np.testing.assert_array_equal(ta, ja)
    assert ja.sum() > 0
    for f in ROWS:
        a = run["jf"][f][shard][ja]
        b = run["tf"][f][shard][ja]
        scale = max(np.abs(np.concatenate(run["jf"][f])).max(), 1e-12)
        err = np.abs(b - a).max() / scale
        assert err < 1e-5, (f, err)


@pytest.mark.parametrize("step", [0, 1])
def test_sedov_diagnostics(sedov, step):
    _check_diag(sedov, step)
    assert sedov["td"][step]["n_owned"] == 12 ** 3


@pytest.mark.parametrize("shard", [0, 1])
def test_sedov_shard_rows(sedov, shard):
    _check_rows(sedov, shard)


def test_evrard_gravity(evrard):
    """Self-gravity through the slabs (the gathered direct sum): egrav
    in etot, the rows of both shards."""
    _check_diag(evrard, 0)
    a, b = evrard["jd"][0], evrard["td"][0]
    assert a["etot"] < a["ecin"] + a["eint"]       # egrav < 0 counted
    for shard in range(D):
        _check_rows(evrard, shard)
