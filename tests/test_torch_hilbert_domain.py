"""The port's Hilbert domain (sphexa_tpu_torch/domain/hilbert.py) against
the JAX package's (sphexa_tpu/domain/hilbert.py), bit for bit.

The JAX side runs once a configuration under jax.jit(jax.shard_map) on
the conftest's virtual CPU devices; the port's shards are SlabMesh
threads on the CPU. Inputs: seeded numpy particles, a clustered cloud
(a Gaussian core on a uniform background, so the splits are unequal in
volume) in an open box, every shard holding a random alive count of
particles from anywhere in the box, with noise in its dead rows. Every
step moves, compares or counts float32 values without arithmetic of its
own, so everything is held equal:

  - the 30-bit keys, the histogram splits and owners, and the 64-bit
    (hi, lo) radix splits and owners;
  - migrate: every row of every shard in order, alive, lost and the
    owned count, with a roomy mig_cap and with one so small that rows
    are lost;
  - the halo maps (send rows, valid lanes, pool sources and validity,
    lost), the extended frame of exchange_halos, and
    refresh_halo_fields of a new payload, plain and through a
    permutation (inv_perm);
  - at D = 2 and 4 with dense halo frames, and at D = 8 with the pooled
    frame on a small cloud.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from sphexa_tpu.domain import hilbert as jh
from sphexa_tpu.sfc.box import Box as JBox, Boundary as JB
from sphexa_tpu.sfc.hilbert64 import keys64_from_positions as j_keys64
from sphexa_tpu.state import Particles as JParticles, _FIELDS
from sphexa_tpu_torch.domain import hilbert as th
from sphexa_tpu_torch.domain.mesh import SlabMesh
from sphexa_tpu_torch.interop import box_from_numpy
from sphexa_tpu_torch.sfc.hilbert64 import keys64_from_positions
from sphexa_tpu_torch.state import Particles
from torch_threads import two_torch_threads  # noqa: F401

AXIS = jh.AXIS
JBOX = JBox(-1.0, 1.0, -1.0, 1.0, -1.0, 1.0, JB.open, JB.open, JB.open)
TBOX = box_from_numpy([-1, 1, -1, 1, -1, 1], [0, 0, 0])

# (D, cap, mig_cap, halo_cap, pool, key64)
CASES = {
    "d2": (2, 256, 192, 256, 0, False),
    "d2_k64": (2, 256, 192, 256, 0, True),
    "d2_lossy": (2, 256, 8, 24, 0, False),
    "d4": (4, 160, 96, 160, 0, False),
    "d4_k64": (4, 160, 96, 160, 0, True),
    "d8_pool": (8, 64, 48, 64, 160, False),
}


def _cloud(D, cap, seed):
    """Per shard a random alive count of rows from a clustered cloud;
    every field noise, dead rows noise too."""
    r = np.random.default_rng(seed)
    cols = {f: r.normal(0, 1, D * cap).astype(np.float32)
            for f in _FIELDS[:-1]}
    cols["h"] = r.uniform(0.02, 0.05, D * cap).astype(np.float32)
    alive = np.zeros(D * cap, bool)
    for s in range(D):
        k = int(r.integers(cap // 3, cap // 2))
        alive[s * cap:s * cap + k] = True
    n = D * cap
    core = r.random(n) < 0.6
    for c in "xyz":
        v = np.where(core, r.normal(0.2, 0.12, n), r.uniform(-1, 1, n))
        cols[c] = np.clip(v, -0.999, 0.999).astype(np.float32)
    return cols, alive


def _hc(key, mod=th):
    D, cap, mig, halo, pool, k64 = CASES[key]
    return mod.HilbertConfig(n_ranks=D, cap=cap, halo_cap=halo, mig_cap=mig,
                             split_bits=10, coarse=8, dilate=1,
                             key64=k64, halo_pool=pool)


def _jax_run(key, cols, alive):
    hc = _hc(key, jh)
    D = hc.n_ranks

    def local(ps):
        me = jax.lax.axis_index(AXIS)
        keys = jh.hilbert_keys(JBOX, ps.x, ps.y, ps.z)
        if hc.key64:
            hi, lo = j_keys64(JBOX, ps.x, ps.y, ps.z)
            s_hi, s_lo = jh.balance_splits64(hi, lo, ps.alive, hc)
            owner = jh.owner_of64(hi, lo, s_hi, s_lo)
            splits = jnp.concatenate([s_hi, s_lo]).astype(jnp.int32)
            keyrows = jnp.stack([hi, lo]).astype(jnp.int32)
        else:
            splits = jh.balance_splits(keys, ps.alive, hc)
            owner = jh.owner_of(keys, splits)
            splits = splits.astype(jnp.int32)
            keyrows = keys.astype(jnp.int32)[None]
        ps2, lost, n_own = jh.migrate(ps, JBOX, splits if not hc.key64
                                      else None, hc, owner=owner)
        ext, maps = jh.exchange_halos(ps2, JBOX, hc)
        pay = ext.temp + me.astype(jnp.float32)
        (r1,) = jh.refresh_halo_fields((pay,), maps, hc)
        perm = jnp.argsort(ext.x, stable=True).astype(jnp.int32)
        inv = jnp.zeros_like(perm).at[perm].set(
            jnp.arange(hc.ext, dtype=jnp.int32))
        (r2,) = jh.refresh_halo_fields((pay[perm],), maps, hc, inv_perm=inv)
        rows = jnp.stack([getattr(ps2, f) for f in _FIELDS[:-1]])
        erows = jnp.stack([getattr(ext, f) for f in _FIELDS[:-1]])
        return dict(
            keys=keyrows, splits=splits[None], owner=owner,
            rows=rows, alive=ps2.alive,
            counts=jnp.stack([lost, n_own, maps.send_lost])[None],
            erows=erows, ealive=ext.alive,
            send_idx=maps.send_idx[None], send_valid=maps.send_valid[None],
            pool_src=maps.pool_src, pool_valid=maps.pool_valid,
            r1=r1, r2=r2)

    spec = dict(keys=P(None, AXIS), splits=P(AXIS), owner=P(AXIS),
                rows=P(None, AXIS), alive=P(AXIS), counts=P(AXIS),
                erows=P(None, AXIS), ealive=P(AXIS), send_idx=P(AXIS),
                send_valid=P(AXIS), pool_src=P(AXIS), pool_valid=P(AXIS),
                r1=P(AXIS), r2=P(AXIS))
    ps = JParticles(alive=jnp.asarray(alive),
                    **{f: jnp.asarray(cols[f]) for f in _FIELDS[:-1]})
    mesh = Mesh(np.array(jax.devices()[:D]), (AXIS,))
    fn = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(JParticles(**{f: P(AXIS)
                                                  for f in _FIELDS}),),
        out_specs=spec, check_vma=False))
    return {k: np.asarray(v) for k, v in fn(ps).items()}


def _torch_run(key, cols, alive):
    hc = _hc(key)
    D = hc.n_ranks
    mesh = SlabMesh(D, devices=["cpu"])
    cap = hc.cap
    parts = [Particles(alive=torch.from_numpy(alive[s * cap:(s + 1) * cap]),
                       **{f: torch.from_numpy(
                           cols[f][s * cap:(s + 1) * cap].copy())
                          for f in _FIELDS[:-1]}) for s in range(D)]

    def local(comm, ps):
        keys = th.hilbert_keys(TBOX, ps.x, ps.y, ps.z)
        if hc.key64:
            hi, lo = keys64_from_positions(TBOX, ps.x, ps.y, ps.z)
            s_hi, s_lo = th.balance_splits64(comm, hi, lo, ps.alive, hc)
            owner = th.owner_of64(hi, lo, s_hi, s_lo)
            splits, keyrows = torch.cat([s_hi, s_lo]), torch.stack([hi, lo])
            ps2, lost, n_own = th.migrate(comm, ps, TBOX, None, hc,
                                          owner=owner)
        else:
            splits = th.balance_splits(comm, keys, ps.alive, hc)
            owner = th.owner_of(keys, splits)
            keyrows = keys[None]
            ps2, lost, n_own = th.migrate(comm, ps, TBOX, splits, hc)
        ext, maps = th.exchange_halos(comm, ps2, TBOX, hc)
        pay = ext.temp + float(comm.me)
        (r1,) = th.refresh_halo_fields(comm, (pay,), maps, hc)
        perm = torch.argsort(ext.x, stable=True)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(hc.ext)
        (r2,) = th.refresh_halo_fields(comm, (pay[perm],), maps, hc,
                                       inv_perm=inv)
        return dict(
            keys=keyrows, splits=splits[None], owner=owner,
            rows=torch.stack([getattr(ps2, f) for f in _FIELDS[:-1]]),
            alive=ps2.alive,
            counts=torch.stack([lost, n_own, maps.send_lost])[None],
            erows=torch.stack([getattr(ext, f) for f in _FIELDS[:-1]]),
            ealive=ext.alive, send_idx=maps.send_idx[None],
            send_valid=maps.send_valid[None], pool_src=maps.pool_src,
            pool_valid=maps.pool_valid, r1=r1, r2=r2)

    res = mesh.run(local, parts)
    out = {}
    for k in res[0]:
        ax = 1 if k in ("keys", "rows", "erows") else 0
        out[k] = np.concatenate([r[k].numpy() for r in res], axis=ax)
    return out


@functools.lru_cache(maxsize=None)
def _both(key):
    D, cap = CASES[key][:2]
    cols, alive = _cloud(D, cap, seed=list(CASES).index(key))
    return _jax_run(key, cols, alive), _torch_run(key, cols, alive)


@pytest.mark.parametrize("key", list(CASES))
def test_domain_bit_equal(key):
    a, b = _both(key)
    for k in a:
        np.testing.assert_array_equal(
            b[k].astype(a[k].dtype) if a[k].dtype != bool else b[k], a[k],
            err_msg=k)
    hc = _hc(key)
    counts = a["counts"]
    if key == "d2_lossy":
        assert (counts[:, 0] > 0).any() and (counts[:, 2] > 0).any()
    else:
        assert (counts[:, 0] == 0).all()
        assert counts[:, 1].sum() == int(a["alive"].sum())
        # every halo slot in use came from a send
        assert a["pool_valid"].sum() > 0
    if hc.halo_pool:
        assert a["pool_valid"].shape[0] == hc.n_ranks * hc.halo_pool


def test_splits_balance():
    """The quantile splits leave every shard within one histogram bin of
    the ideal load on the clustered cloud (30-bit), and the exact 64-bit
    splits within a few rows."""
    a30, _ = _both("d4")
    a64, _ = _both("d4_k64")
    for a, tol in ((a30, 0.2), (a64, 0.02)):
        n = int(a["alive"].sum())
        per = a["counts"][:, 1]
        assert per.sum() == n
        assert np.abs(per - n / 4).max() <= tol * n / 4 + 2, per.tolist()


def test_pooled_frame_is_compact():
    """With halo_pool, the frame's halo slots are filled from the front
    (pool_valid a prefix) and hold every received row."""
    a, _ = _both("d8_pool")
    hc = _hc("d8_pool")
    for s in range(hc.n_ranks):
        pv = a["pool_valid"][s * hc.halo_pool:(s + 1) * hc.halo_pool]
        k = int(pv.sum())
        assert pv[:k].all() and not pv[k:].any()
