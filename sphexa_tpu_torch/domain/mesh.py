"""The shard group of the slab-sharded engines and its collectives.

Counterpart of sphexa_tpu/domain/mesh.py (make_slab_mesh) and of the
jax.lax collectives that the sharded engines call inside
jax.shard_map: ppermute on the +-1 ring (ShardComm.ring_pair: both
directions at once), pmin, pmax, psum, all_gather, all_to_all (the
Hilbert domain's one-hop exchange, domain/hilbert.py) and axis_index
(ShardComm.me). The Hilbert domain runs on the same group: SlabMesh is
the port's one mesh of shards, whatever the domain.

JAX runs these engines single-controller: one Python process drives
every device of the mesh (the JAX tests on 8 virtual CPU devices). The
port does the same. SlabMesh.run starts one thread per shard, and shard
i lives on devices[i % len(devices)]: on the CPU all shards share
`cpu`, on a host with one card all share `cuda:0`, with more cards each
shard gets its own. A collective is a rendezvous of every shard on one
threading.Barrier: each posts its tensor, all wait, each reads what it
needs, all wait again before the slots are reused. Tensors stay on the
device (no .item(), no host sync); a reduction runs in shard order
0..D-1 on every shard, so every shard gets the same bits.

An exception in one shard aborts the barrier, so the other shards stop
at their next collective, and run() raises it again in the caller with
the shard's index. A barrier wait that exceeds `timeout` seconds breaks
the barrier the same way: the run fails, it does not hang.

CUDA: PyTorch's current device and stream are per thread. Each worker
enters the caller's current device and stream, so a tensor handed from
one shard to another is read on the stream that wrote it, after the
write.

Not ported: the slice-major device order of make_slab_mesh (TPU
multi-slice `slice_index`, DCN). Like the JAX package, which has no
multi-host path (no jax.distributed), the port runs its shards in one
process on one host.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from sphexa_tpu_torch.util.device import resolve_device


class ShardError(RuntimeError):
    """A shard of SlabMesh.run failed; `shard` is its index."""

    def __init__(self, shard: int, msg: str):
        super().__init__(f"shard {shard}: {msg}")
        self.shard = shard


class _Rendezvous:
    def __init__(self, n: int, timeout: float):
        self.barrier = threading.Barrier(n, timeout=timeout)
        self.slots = [None] * n


class ShardComm:
    """One shard's view of the group: its index (`me`, the axis_index),
    its device, and the collectives. Every shard must call the same
    collectives in the same order, as under shard_map."""

    def __init__(self, mesh: "SlabMesh", me: int, rdv: _Rendezvous):
        self.mesh = mesh
        self.me = me
        self.n = mesh.n_slabs
        self.device = mesh.devices[me]
        self._rdv = rdv

    def exchange(self, obj) -> list:
        """All-gather of one object per shard (tensors or tuples of
        them), in shard order."""
        rdv = self._rdv
        rdv.slots[self.me] = obj
        rdv.barrier.wait()
        out = list(rdv.slots)
        rdv.barrier.wait()
        return out

    def _here(self, x):
        return x.to(self.device)

    def ring_pair(self, to_right, to_left):
        """The two ppermutes of the +-1 ring in one rendezvous: every
        shard sends `to_right` to shard me + 1 and `to_left` to shard
        me - 1 (mod n), and gets back (what its left neighbour sent
        right, what its right neighbour sent left). Each argument is a
        tensor or a tuple of tensors."""
        vals = self.exchange((to_right, to_left))
        a = vals[(self.me - 1) % self.n][0]
        b = vals[(self.me + 1) % self.n][1]
        return self._move(a), self._move(b)

    def _move(self, x):
        if isinstance(x, tuple):
            return tuple(self._here(v) for v in x)
        return self._here(x)

    def _reduce(self, x, op):
        vals = self.exchange(x)
        acc = self._here(vals[0])
        for v in vals[1:]:
            acc = op(acc, self._here(v))
        return acc

    def psum(self, x):
        return self._reduce(x, torch.add)

    def all_gather(self, x):
        """jax.lax.all_gather: every shard's x stacked [D, ...] in shard
        order. x is a tensor or a tuple of tensors (one rendezvous for
        all of them; a tuple comes back as a tuple of stacks)."""
        vals = self.exchange(x)
        if isinstance(x, tuple):
            return tuple(torch.stack([self._here(v[k]) for v in vals])
                         for k in range(len(x)))
        return torch.stack([self._here(v) for v in vals])

    def all_to_all(self, x):
        """jax.lax.all_to_all(split_axis=0, concat_axis=0) of a [D, ...]
        buffer, one row per destination: shard s gets row s of every
        shard's buffer, stacked in source order. x is a tensor or a
        tuple of tensors (one rendezvous for all of them)."""
        vals = self.exchange(x)
        me = self.me
        if isinstance(x, tuple):
            return tuple(torch.stack([self._here(v[k][me]) for v in vals])
                         for k in range(len(x)))
        return torch.stack([self._here(v[me]) for v in vals])

    def pmin(self, x):
        return self._reduce(x, torch.minimum)

    def pmax(self, x):
        return self._reduce(x, torch.maximum)


class SlabMesh:
    """n_slabs shards along one ring axis. devices=None takes the port's
    default device (the GPU; it raises without one, as the other entry
    points do). `timeout` bounds each wait at a collective, in seconds.
    comms[i] is shard i's ShardComm, the same object in every run, so a
    per-shard engine can hold it."""

    def __init__(self, n_slabs: int, devices=None, timeout: float = 600.0):
        if n_slabs < 1:
            raise ValueError(f"n_slabs {n_slabs}: at least one shard")
        devs = [resolve_device(d) for d in (devices or [None])]
        self.n_slabs = n_slabs
        self.devices = [devs[i % len(devs)] for i in range(n_slabs)]
        self.timeout = timeout
        self._rdv = _Rendezvous(n_slabs, timeout)
        self.comms = [ShardComm(self, i, self._rdv) for i in range(n_slabs)]
        self._running = threading.Lock()

    def run(self, fn, *args) -> list:
        """fn(comms[i], *(a[i] for a in args)) on every shard i, each in
        its own thread; each of `args` holds one entry per shard. Returns
        the n_slabs results in shard order."""
        D = self.n_slabs
        for a in args:
            if len(a) != D:
                raise ValueError(f"expected {D} per-shard arguments, "
                                 f"got {len(a)}")
        if not self._running.acquire(blocking=False):
            raise RuntimeError("SlabMesh.run called from inside a run")
        try:
            return self._run(fn, args)
        finally:
            self._running.release()

    def _run(self, fn, args):
        D = self.n_slabs
        rdv = self._rdv
        rdv.barrier.reset()          # broken by an earlier failed run
        rdv.slots = [None] * D
        streams = {d: torch.cuda.current_stream(d)
                   for d in set(self.devices) if d.type == "cuda"}
        results, errors = [None] * D, [None] * D

        def work(i):
            dev = self.devices[i]
            try:
                with contextlib.ExitStack() as stack:
                    if dev.type == "cuda":
                        stack.enter_context(torch.cuda.device(dev))
                        stack.enter_context(torch.cuda.stream(streams[dev]))
                    results[i] = fn(self.comms[i], *(a[i] for a in args))
            except BaseException as e:      # re-raised in the caller
                errors[i] = e
                rdv.barrier.abort()

        threads = [threading.Thread(target=work, args=(i,), daemon=True,
                                    name=f"slab-shard-{i}") for i in range(D)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, e in enumerate(errors):
            if e is not None and not isinstance(e,
                                                threading.BrokenBarrierError):
                raise ShardError(i, f"{type(e).__name__}: {e}") from e
        for i, e in enumerate(errors):
            if e is not None:
                raise ShardError(i, f"a collective waited more than "
                                    f"{self.timeout} s") from e
        return results
