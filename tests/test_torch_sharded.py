"""The slab domain of the port against the JAX package: K1z (the ghost
refresh with refresh_z=False), the z-plane exchange, migration,
distribution and the slab planner, and the refusals of the sharded
engines.

The JAX side runs under jax.shard_map on the conftest's virtual CPU
devices, with Pallas in interpret mode; the port runs its shards as
SlabMesh threads on the CPU with the kernels' plain versions. Inputs
are seeded numpy arrays. K1z, the exchange, migration and distribution
move and shift float32 values without arithmetic of their own beyond
the +-L shifts, so all are held bit for bit, and the planner's integer
plans exactly.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sphexa_tpu.domain import slab as jslab
from sphexa_tpu.init.sedov import init_sedov as j_init_sedov
from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.ops import cellmajor as jcm
from sphexa_tpu.ops import pallas_ve as jpv
from sphexa_tpu.propagator import multichip as jmc
from sphexa_tpu.propagator.ve_bdt_sharded import make_zxchg as j_make_zxchg
from sphexa_tpu.propagator.ve_sharded import distribute as j_distribute
from sphexa_tpu.sfc.box import Box as JBox, Boundary as JB
from sphexa_tpu.state import Particles as JParticles, _FIELDS
from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.domain import slab as tslab
from sphexa_tpu_torch.domain.mesh import ShardError, SlabMesh
from sphexa_tpu_torch.domain.slab import SlabConfig, migrate
from sphexa_tpu_torch.interop import box_from_numpy
from sphexa_tpu_torch.ops import cellmajor as tcm
from sphexa_tpu_torch.ops import pair_ve as tpv
from sphexa_tpu_torch.physics.turbulence import TurbulenceData
from sphexa_tpu_torch.propagator.ve_bdt_sharded import (ShardedBdtVE,
                                                         TurbShardedBdtVE)
from sphexa_tpu_torch.propagator.ve_pallas_sharded import (
    make_ve_step_pallas_sharded, make_zxchg)
from sphexa_tpu_torch.propagator.ve_sharded import distribute, plan_slab
from sphexa_tpu_torch.state import Particles
from torch_threads import one_torch_thread  # noqa: F401

AXIS = jslab.AXIS


def _tbox(jb):
    return box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                           jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])


def _tgrid(g):
    return tcm.CMGrid(n=g.n, cap=g.cap, nzi=g.nzi, nxi=g.nxi)


def _jmesh(D):
    return Mesh(np.array(jax.devices()[:D]), (AXIS,))


def _box(bxy, bz):
    return JBox(-0.5, 0.5, -0.5, 0.5, -0.5, 0.5, bxy, bxy, bz)


# ---------------------------------------------------------------------------
# K1z
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bxy", [JB.periodic, JB.open], ids=["per", "open"])
@pytest.mark.parametrize("grid", [jcm.CMGrid(n=3, cap=8, nzi=2),
                                  jcm.CMGrid(n=3, cap=8, nzi=2, nxi=4)],
                         ids=["cubic_xy", "nxi4"])
@pytest.mark.parametrize("xyz_rows", [(0, 1, 2), None], ids=["xyz", "copy"])
def test_k1z_bit_equal(bxy, grid, xyz_rows):
    """K1z against make_ghost_refresh(refresh_z=False) on the sharded
    engines' box (z open), on a random stack with random z-ghost lanes:
    bit-equal, in place, and the z-ghost lanes of interior columns and
    every interior cell untouched."""
    jb = _box(bxy, JB.open)
    nrows = 5
    stack = np.random.default_rng(3).normal(
        0, 1, (nrows, grid.n_slots)).astype(np.float32)
    a = np.asarray(jpv.make_ghost_refresh(
        grid, jb, nrows, xyz_rows=xyz_rows, interpret=True,
        refresh_z=False)(jnp.asarray(stack)))
    t = torch.from_numpy(stack.copy())
    b = tpv.ghost_refresh_xy(t, _tgrid(grid), _tbox(jb), xyz_rows)
    assert b is t
    np.testing.assert_array_equal(b.numpy(), a)
    cx, cy, _ = tcm._cell_coords_all(_tgrid(grid))
    col = (cx >= 1) & (cx <= grid.nx) & (cy >= 1) & (cy <= grid.n)
    np.testing.assert_array_equal(b.numpy()[:, np.repeat(col, grid.cap)],
                                  stack[:, np.repeat(col, grid.cap)])
    changed = (b.numpy() != stack).any(0)
    assert changed[np.repeat(~col, grid.cap)].mean() > 0.9
    if bxy == JB.open and xyz_rows:
        assert (b.numpy() == np.float32(tpv.FILL_POS)).any()


def test_k1z_differs_from_k1():
    """On the same stack K1 (refresh_z=True) rewrites the interior
    columns' z-ghost lanes and K1z leaves them: the two maps differ."""
    g = tcm.CMGrid(n=3, cap=8, nzi=2)
    box = _tbox(_box(JB.periodic, JB.open))
    stack = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (3, g.n_slots)).astype(np.float32))
    k1 = tpv.ghost_refresh(stack.clone(), g, box, (0, 1, 2))
    k1z = tpv.ghost_refresh_xy(stack.clone(), g, box, (0, 1, 2))
    cx, cy, cz = tcm._cell_coords_all(g)
    zghost = np.repeat((cx >= 1) & (cx <= 3) & (cy >= 1) & (cy <= 3)
                       & ((cz == 0) | (cz == g.npz - 1)), g.cap)
    assert torch.equal(k1z[:, zghost], stack[:, zghost])
    assert (k1[2, zghost] == tpv.FILL_POS).all()     # open z: K1 fills


# ---------------------------------------------------------------------------
# the z-plane exchange
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("bz", [JB.periodic, JB.open], ids=["per", "open"])
@pytest.mark.parametrize("zrow", [2, -1])
def test_zxchg_bit_equal(D, bz, zrow):
    grid = jcm.CMGrid(n=3, cap=8, nzi=2)
    jb = _box(JB.periodic, bz)
    nrows = 4
    stack = np.random.default_rng(7).normal(
        0, 1, (nrows, D * grid.n_slots)).astype(np.float32)
    zx = j_make_zxchg(grid, jb, D)
    fn = jax.jit(jax.shard_map(lambda st: zx(st, zrow=zrow), mesh=_jmesh(D),
                               in_specs=P(None, AXIS),
                               out_specs=P(None, AXIS), check_vma=False))
    a = np.asarray(fn(jnp.asarray(stack)))

    mesh = SlabMesh(D, devices=["cpu"])
    tzx = make_zxchg(_tgrid(grid), _tbox(jb), mesh)
    parts = [torch.from_numpy(p.copy()) for p in np.split(stack, D, axis=1)]
    out = mesh.run(lambda comm, st: tzx(comm, st, zrow), parts)
    np.testing.assert_array_equal(np.concatenate(
        [o.numpy() for o in out], axis=1), a)


# ---------------------------------------------------------------------------
# migration and distribution
# ---------------------------------------------------------------------------

def _moving_particles(D, cap, seed, far=True):
    """Per shard: a random alive count, x/y uniform, z inside the slab,
    then a third of the alive rows moved by up to 0.6 slab widths (across
    the slab edges and, for the outer slabs, across the box faces) and,
    with far, a few by 1.6 widths; dead rows hold noise. Two extra
    payload columns."""
    r = np.random.default_rng(seed)
    W = 1.0 / D
    cols = {f: r.normal(0, 1, D * cap).astype(np.float32)
            for f in _FIELDS[:-1]}
    alive = np.zeros(D * cap, bool)
    for s in range(D):
        k = int(r.integers(cap // 3, 2 * cap // 3))
        sl = slice(s * cap, s * cap + k)
        alive[sl] = True
        cols["x"][sl] = r.uniform(-0.5, 0.5, k)
        cols["y"][sl] = r.uniform(-0.5, 0.5, k)
        z = -0.5 + W * (s + r.uniform(0, 1, k))
        mv = r.random(k) < 0.35
        z[mv] += r.uniform(-0.6 * W, 0.6 * W, mv.sum())
        if far:
            z[:3] += 1.6 * W
        cols["z"][sl] = np.clip(z, -0.5, 0.5 - 1e-6).astype(np.float32)
        cols["h"][sl] = np.abs(cols["h"][sl]) + 0.1
    extras = tuple(r.normal(0, 1, D * cap).astype(np.float32)
                   for _ in range(2))
    return cols, alive, extras


def _jax_migrate(cols, alive, extras, jb, sc):
    mesh = _jmesh(sc.n_slabs)
    sh = NamedSharding(mesh, P(AXIS))
    ps = JParticles(alive=jax.device_put(alive, sh),
                    **{f: jax.device_put(cols[f], sh) for f in cols})
    spec = JParticles(**{f: P(AXIS) for f in _FIELDS})

    def local(p, e0, e1):
        p, ex, lost = jslab.migrate(p, jb, sc, extras=(e0, e1))
        return p, ex, lost[None]

    fn = jax.jit(jax.shard_map(local, mesh=mesh,
                               in_specs=(spec, P(AXIS), P(AXIS)),
                               out_specs=(spec, (P(AXIS), P(AXIS)), P(AXIS)),
                               check_vma=False))
    p, ex, lost = fn(ps, *(jax.device_put(e, sh) for e in extras))
    return ({f: np.asarray(getattr(p, f)) for f in _FIELDS},
            [np.asarray(e) for e in ex], np.asarray(lost))


def _torch_migrate(cols, alive, extras, jb, sc):
    D, cap = sc.n_slabs, sc.cap
    mesh = SlabMesh(D, devices=["cpu"])
    box = _tbox(jb)
    tsc = SlabConfig(**dataclasses.asdict(sc))

    def part(a, s):
        return torch.from_numpy(a[s * cap:(s + 1) * cap].copy())

    ps = [Particles(alive=part(alive, s), **{f: part(cols[f], s)
                                              for f in cols})
          for s in range(D)]
    ex = [tuple(part(e, s) for e in extras) for s in range(D)]
    res = mesh.run(lambda comm, p, e: migrate(comm, p, box, tsc, extras=e),
                   ps, ex)
    fields = {f: np.concatenate([getattr(r[0], f).numpy() for r in res])
              for f in _FIELDS}
    exo = [np.concatenate([r[1][k].numpy() for r in res]) for k in range(2)]
    return fields, exo, np.array([int(r[2]) for r in res])


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("bz", [JB.periodic, JB.open], ids=["per", "open"])
@pytest.mark.parametrize("mig_cap", [64, 4], ids=["fits", "overflow"])
def test_migrate_bit_equal(D, bz, mig_cap):
    """Alive rows, counts, extras and lost equal the JAX package's, on
    every row (the dead rows too: the port writes the received buffers
    where dynamic_update_slice does). mig_cap 4 overflows.

    At D = 2 with an open z both packages drop, uncounted, the rows
    that move from slab 1 down to slab 0: the n_slabs == 2 guard sends
    every mover as go_r (slab.py:127-130), so slab 1's movers cross the
    ring's seam, and the open-z discard of wrap-around receives
    (:147-149) drops them at slab 0 (ROADMAP Queue 3)."""
    cap = 96
    jb = _box(JB.periodic, bz)
    sc = jslab.SlabConfig(n_slabs=D, cap=cap, halo_cap=8, mig_cap=mig_cap)
    cols, alive, extras = _moving_particles(D, cap, seed=D + mig_cap,
                                            far=D > 2)
    ja, jex, jlost = _jax_migrate(cols, alive, extras, jb, sc)
    ta, tex, tlost = _torch_migrate(cols, alive, extras, jb, sc)
    np.testing.assert_array_equal(tlost, jlost)
    for f in _FIELDS:
        np.testing.assert_array_equal(ta[f], ja[f], err_msg=f)
    for a, b in zip(tex, jex):
        np.testing.assert_array_equal(a, b)
    if mig_cap == 4 or D > 2:
        assert jlost.sum() > 0
        return
    assert jlost.sum() == 0
    z = cols["z"][alive]
    down = np.sum((np.arange(D * cap)[alive] >= cap) & (z < 0.0))
    dropped = down if bz == JB.open else 0
    assert down > 0
    assert ta["alive"].sum() == alive.sum() - dropped


@pytest.mark.parametrize("D", [2, 4])
def test_distribute_equal(D):
    state, jb, _ = j_init_sedov(8, JCfg(), dt0=1e-4)
    host = {f: np.asarray(getattr(state.p, f)) for f in _FIELDS[:-1]}
    ext = {"gid": np.arange(512, dtype=np.float32),
           "dt_m1k": np.full(512, 3e-5, np.float32)}
    sc = jslab.SlabConfig(n_slabs=D, cap=512 // D + 64, halo_cap=8,
                          mig_cap=64)
    jps, jext = j_distribute(host, jb, sc, _jmesh(D), extras=ext)
    mesh = SlabMesh(D, devices=["cpu"])
    tps, text = distribute(host, _tbox(jb),
                           SlabConfig(**dataclasses.asdict(sc)), mesh,
                           extras=ext)
    assert len(tps) == D
    for f in _FIELDS:
        np.testing.assert_array_equal(
            np.concatenate([getattr(p, f).numpy() for p in tps]),
            np.asarray(getattr(jps, f)), err_msg=f)
    for k in ext:
        np.testing.assert_array_equal(
            np.concatenate([t.numpy() for t in text[k]]),
            np.asarray(jext[k]))


def _jax_slab_setup(host, jb, h_max, D):
    ad = jmc.MultiChipAdapter.__new__(jmc.MultiChipAdapter)
    ad.D, ad.n_global = D, len(host["x"])
    grid, sc, _, _ = ad._slab_setup(host, jb, h_max, list(jax.devices()[:D]),
                                    quiet=True)
    return grid, sc


@pytest.mark.parametrize("case", ["sedov12_D2", "sedov12_D4", "uniform_D4",
                                  "uniform_D8"])
def test_plan_slab_equal(case):
    """plan_slab gives MultiChipAdapter._slab_setup's grid and
    SlabConfig on the same host arrays (Sedov 12^3 at D = 4 halves to
    2: its slabs are thinner than 2 h_max)."""
    src, D = case.split("_D")
    D = int(D)
    if src == "sedov12":
        state, jb, _ = j_init_sedov(12, JCfg(), dt0=1e-4)
        host = {f: np.asarray(getattr(state.p, f)) for f in ("x", "y", "z")}
        h_max = float(np.asarray(state.p.h).max())
    else:
        r = np.random.default_rng(11)
        jb = _box(JB.periodic, JB.periodic)
        host = {c: r.uniform(-0.5, 0.5, 20000).astype(np.float32)
                for c in "xyz"}
        h_max = 0.03
    jg, jsc = _jax_slab_setup(host, jb, h_max, D)
    tg, tsc = plan_slab(host, _tbox(jb), h_max, D)
    assert (tg.n, tg.cap, tg.nzi, tg.nxi) == (jg.n, jg.cap, jg.nzi, jg.nxi)
    assert dataclasses.asdict(tsc) == dataclasses.asdict(jsc)
    if case == "sedov12_D4":
        assert tsc.n_slabs == 2


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_one_slab_refused():
    """SlabConfig refuses n_slabs < 2. The JAX package's migrate at
    n_slabs == 1 sends every particle to itself as well as keeping it:
    stay, go_r and go_l all hold when (me +- 1) % 1 == me (slab.py:
    123-130). On 100 random particles (run under shard_map on the CPU)
    it returned 164 alive and 136 lost; D = 2 returned 100 alive and 0
    lost. The JAX CLI adapter refuses D < 2 (multichip.py:256-260);
    make_ve_step_pallas_sharded and ShardedBdtVE accept it. The port
    refuses it. Here the JAX migrate at D = 1 is run on this test's own
    particles, which it duplicates too."""
    with pytest.raises(ValueError, match="at least 2"):
        SlabConfig(n_slabs=1, cap=64, halo_cap=8, mig_cap=16)
    with pytest.raises(ValueError):
        SlabConfig(n_slabs=0, cap=64, halo_cap=8, mig_cap=16)
    jb = _box(JB.periodic, JB.periodic)
    sc = jslab.SlabConfig(n_slabs=1, cap=256, halo_cap=8, mig_cap=256)
    cols, alive, extras = _moving_particles(1, 256, seed=1, far=False)
    ja, _, jlost = _jax_migrate(cols, alive, extras, jb, sc)
    assert ja["alive"].sum() > alive.sum() and jlost.sum() > 0


def test_entry_points_refuse_silent_cpu(monkeypatch):
    """Without a card and without devices, SlabMesh raises, as the
    other entry points do."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SlabMesh(2)
    SlabMesh(2, devices=["cpu"])


def test_gravity_and_stirring_refused():
    """The sharded engines took self-gravity in (the name is kept from
    when they refused it): all three build with gravG = 1, and a step of
    the resident sharded engine at Sedov 8^3 (direct sum, D = 2) gives
    the gravitational energy of the direct sum over every particle on
    one device (rtol 1e-5), with no lost row."""
    from sphexa_tpu_torch.gravity.direct import direct_gravity, egrav
    from sphexa_tpu_torch.init.sedov import init_sedov
    from sphexa_tpu_torch.propagator.multichip import _host_fields
    from sphexa_tpu_torch.state import SimState

    box = _tbox(_box(JB.periodic, JB.periodic))
    grid = tcm.CMGrid(n=4, cap=64, nzi=2)
    sc = SlabConfig(n_slabs=2, cap=384, halo_cap=8, mig_cap=64)
    mesh = SlabMesh(2, devices=["cpu"])
    state, box, cfg = init_sedov(8, SphConfig(), device="cpu")
    cfg = cfg.replace(gravG=1.0)
    step = make_ve_step_pallas_sharded(box, grid, cfg, sc, mesh)
    ShardedBdtVE(box, grid, cfg, sc, mesh)
    TurbShardedBdtVE(box, grid, cfg, sc, mesh)
    host = _host_fields(state.p)
    states = [SimState(p=p, ttot=state.ttot, dt=state.dt,
                       dt_m1=state.dt_m1, iteration=state.iteration)
              for p in distribute(host, box, sc, mesh)]
    _, d = step(states)
    assert int(d.lost) == 0 and int(d.overflow) == 0
    p = state.p
    g = direct_gravity(p.x, p.y, p.z, p.m, p.alive, 1.0, cfg.eps)
    want = float(egrav(p.m, g.pot, p.alive))
    assert want < 0.0
    np.testing.assert_allclose(float(d.etot) - float(d.ecin)
                               - float(d.eint), want, rtol=1e-5)


def test_stirring_modes_set_once():
    """TurbShardedBdtVE puts the stirring modes of its own OU state on
    each shard when it is built; a plain ShardedBdtVE's shards have none,
    and run_cycle_stirred (the JAX package's name) takes only the
    engine's own OU state."""
    box = _tbox(_box(JB.periodic, JB.periodic))
    grid = tcm.CMGrid(n=4, cap=64, nzi=2)
    sc = SlabConfig(n_slabs=2, cap=256, halo_cap=8, mig_cap=64)
    mesh = SlabMesh(2, devices=["cpu"])
    plain = ShardedBdtVE(box, grid, SphConfig(), sc, mesh)
    assert plain.turb is None
    assert all(e.turb is None and e.stir is None for e in plain.shards)
    stirred = TurbShardedBdtVE(box, grid, SphConfig(), sc, mesh)
    km = torch.from_numpy(stirred.turb.modes.astype(np.float32))
    assert all(torch.equal(e.stir.km, km) for e in stirred.shards)
    for eng in (plain, stirred):
        with pytest.raises(ValueError, match="own OU state"):
            eng.run_cycle_stirred([], TurbulenceData.create(verbose=False))


def test_shard_exception_reaches_caller():
    """An exception in one shard comes back to the caller with the
    shard's index; the other shards, waiting at a collective, stop
    instead of hanging; the mesh runs again afterwards."""
    mesh = SlabMesh(4, devices=["cpu"], timeout=60.0)

    def body(comm, _):
        x = comm.psum(torch.ones(()))
        if comm.me == 2:
            raise KeyError("boom")
        return comm.psum(x)

    t0 = time.perf_counter()
    with pytest.raises(ShardError, match="shard 2: KeyError") as ei:
        mesh.run(body, [None] * 4)
    assert ei.value.shard == 2
    assert time.perf_counter() - t0 < 30.0
    assert threading.active_count() < 20
    out = mesh.run(lambda comm, v: comm.psum(v),
                   [torch.tensor(float(i)) for i in range(4)])
    assert [float(o) for o in out] == [6.0] * 4


def test_shard_missing_a_collective_times_out():
    """A shard that never reaches the collective makes the others time
    out: the run fails with the timeout, it does not hang."""
    mesh = SlabMesh(2, devices=["cpu"], timeout=0.5)

    def body(comm, _):
        if comm.me == 0:
            return comm.pmin(torch.ones(()))
        time.sleep(1.5)
        return None

    with pytest.raises(ShardError, match="waited more than"):
        mesh.run(body, [None] * 2)


def test_collectives_in_shard_order():
    """psum, pmin and pmax reduce in shard order on every shard, so all
    shards hold the same bits; ring_pair follows ppermute's direction
    both ways."""
    mesh = SlabMesh(4, devices=["cpu"])
    vals = [torch.tensor([1e8, 1.0, -1e8, 3.0][i], dtype=torch.float32)
            for i in range(4)]

    def body(comm, v):
        right, left = comm.ring_pair(v + 100.0, v - 100.0)
        return comm.psum(v), comm.pmin(v), comm.pmax(v), right, left

    out = mesh.run(body, vals)
    want = ((np.float32(1e8) + np.float32(1.0)) + np.float32(-1e8)) \
        + np.float32(3.0)
    for i, (s, lo, hi, right, left) in enumerate(out):
        assert float(s) == float(want)
        assert float(lo) == -1e8 and float(hi) == 1e8
        assert float(right) == float(vals[(i - 1) % 4] + 100.0)
        assert float(left) == float(vals[(i + 1) % 4] - 100.0)


@pytest.mark.parametrize("cap", [16, 64])
def test_pack_equal(cap):
    """_pack and _pack_indices against the JAX package's, with rows past
    cap dropped (cap 16)."""
    r = np.random.default_rng(cap)
    mask = r.random(50) < 0.6
    vals = r.normal(0, 1, 50).astype(np.float32)
    (jp,), jn = jslab._pack(jnp.asarray(mask), [jnp.asarray(vals)], cap)
    ji, jin = jslab._pack_indices(jnp.asarray(mask), cap)
    (tp,), tn = tslab._pack(torch.from_numpy(mask), [torch.from_numpy(vals)],
                            cap)
    ti, tin = tslab._pack_indices(torch.from_numpy(mask), cap)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert int(tn) == int(jn) == int(tin) == int(jin) == min(mask.sum(), cap)
