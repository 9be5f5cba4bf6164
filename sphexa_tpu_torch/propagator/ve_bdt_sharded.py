"""Block time-steps on the slab domain: the multi-device HydroVeBdtProp
(reference: main/src/propagator/ve_hydro_bdt.hpp:171-212, rungs on the
full distributed domain, sync() at cycle starts, partialSync() halo
refreshes inside the cycle).

Counterpart of sphexa_tpu/propagator/ve_bdt_sharded.py (make_zxchg :51,
_ShardedRefreshers :91, ShardedBdtVE :116). Each shard runs the
single-device BdtVE substep (propagator/ve_bdt.py) unchanged, through
two hooks, as the JAX package runs BdtVE._substep inside shard_map:

  - refresh: the z-plane exchange of the resident sharded step
    (ve_pallas_sharded.make_zxchg), then K1z on the x-y ghost columns,
    with the coordinate rows' shifts;
  - the global reductions _gmin, _gmax and _gsum: pmin, pmax and psum
    over the shards (the MPI_Allreduce points of rungTimestep/minDt).

Rung harmonization stays a local per-cell min: every global cell
belongs to one shard. A cycle starts with a full sync: unpack the
resident frame to the particle frame, migrate (gid and the per-slot
kick interval dt_m1k ride as payload), rebuild the local layout, rebind.

The shards are SlabMesh threads, each with its own engine object bound
to its ShardComm and device (_ShardBdtVE). States are lists of one
BDTState per shard. Turbulence stirring (run_cycle_stirred,
TurbShardedBdtVE): the OU phases are drawn once a substep on the host
and given to every shard's substep, replicated. Self-gravity
(_gravity, JAX :146-165) runs every substep across the shards with the
slab FMM (or the gathered direct or Ewald sum) on the valid interior
slots, compacted to the slab's particle capacity so every shard hands
the collectives rows of one length; its fail-stop count rides
`overflow`.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.domain.mesh import ShardComm, SlabMesh
from sphexa_tpu_torch.domain.slab import SlabConfig, _pack, migrate
from sphexa_tpu_torch.ops.cellmajor import CMGrid, build_layout, to_cm
from sphexa_tpu_torch.ops.pair_ve import ghost_refresh_xy
from sphexa_tpu_torch.propagator.ve_bdt import BDTState, BdtVE
from sphexa_tpu_torch.propagator.ve_cellmajor import _RVROWS
from sphexa_tpu_torch.propagator.ve_pallas_sharded import (local_frame_z,
                                                           make_zxchg)
from sphexa_tpu_torch.propagator.ve_sharded import (_sharded_gravity,
                                                    distribute)
from sphexa_tpu_torch.sfc.box import Box, Boundary, put_in_box
from sphexa_tpu_torch.state import _FIELDS, Particles, SimState

_I32 = torch.int32
# the rows a local bind refreshes: every row the pair stages read as
# j-inputs (an open-z local layout leaves the z-ghost planes empty)
_BIND_ROWS = ("x", "y", "z", "h", "gid", "m", "vx", "vy", "vz", "temp",
              "alpha", "du_m1", "x_m1", "y_m1", "z_m1")


class _ShardedRefreshers:
    """The refresh of one shard: the z-plane exchange, then K1z (the
    x-y ghost columns; corners compose). Drop-in for the single-device
    engine's K1 refresh, rf(stack, xyz_rows)."""

    def __init__(self, grid: CMGrid, box: Box, zxchg, comm: ShardComm):
        self._grid = grid
        self._box_loc = dataclasses.replace(box, bz=Boundary.open)
        self._zxchg = zxchg
        self._comm = comm

    def __call__(self, stack, xyz_rows=None):
        zrow = xyz_rows[2] if xyz_rows is not None else -1
        return ghost_refresh_xy(self._zxchg(self._comm, stack, zrow),
                                self._grid, self._box_loc, xyz_rows)


class _ShardBdtVE(BdtVE):
    """One shard's engine: BdtVE with the sharded refresh and the
    collective hooks, bound to the shard's comm and device."""

    def __init__(self, box: Box, grid: CMGrid, cfg: SphConfig,
                 sc: SlabConfig, comm: ShardComm, zxchg, num_rungs: int):
        super().__init__(box, grid, cfg, num_rungs=num_rungs,
                         device=comm.device)
        self.sc = sc
        self.comm = comm
        self.rf = _ShardedRefreshers(grid, box, zxchg, comm)

    def _gmin(self, v):
        return self.comm.pmin(v)

    def _gmax(self, v):
        return self.comm.pmax(v)

    def _gsum(self, v):
        return self.comm.psum(v)

    def _gravity(self, out, x, y, z, m, valid):
        """Per-substep self-gravity across the shards (the syncGrav
        composition, ve_hydro_bdt.hpp:171 + 277-288) on the drifted
        positions of the valid interior slots. They are compacted to
        sc.cap rows (a slab owns at most that many), dead rows after
        them. The solver bins by global position, so slots that drifted
        past the slab boundary between resyncs still land in their
        global cells; the ring-coverage count fail-stops otherwise.
        Returns (out, egrav, fail count), both psum'd."""
        idx = self.gravity_index(valid)
        cap = self.sc.cap
        k = idx.shape[0]
        if k > cap:
            raise RuntimeError(f"{k} valid slots on shard {self.comm.me} "
                               f"> slab cap {cap}")

        def rows(v):
            return torch.cat([v[idx], v.new_zeros(cap - k)])

        alive = torch.arange(cap, device=x.device) < k
        ps = types.SimpleNamespace(x=rows(x), y=rows(y), z=rows(z),
                                   m=rows(m), alive=alive)
        gax, gay, gaz, egrav, govf = _sharded_gravity(self.comm, ps,
                                                      self.box, self.cfg,
                                                      dim=2)

        def scatter(v):
            return torch.zeros_like(x).index_copy_(0, idx, v[:k])

        out = dict(out, ax=out["ax"] + scatter(gax),
                   ay=out["ay"] + scatter(gay), az=out["az"] + scatter(gaz))
        return out, egrav, govf

    def _bind_local(self, ps: Particles, gid, dt_m1k, scalars: dict,
                    overflow0) -> BDTState:
        """Local layout and cell-major gather (ResidentVE.bind +
        BdtVE.bind_bdt on the shard's slab)."""
        box = self.box
        z_fake = local_frame_z(box, self.sc.n_slabs, self.comm.me, ps.z)
        box_loc = dataclasses.replace(box, bz=Boundary.open)
        layout = build_layout(self.grid, box_loc, ps.x, ps.y, z_fake,
                              alive=ps.alive)
        fields = {f: getattr(ps, f) for f in _RVROWS}
        sc_scalars = dict(
            drift=torch.zeros((), dtype=torch.float32, device=self.device),
            overflow=overflow0 + self._gsum(layout.overflow.to(_I32)),
            **scalars)
        rv = self._gather(layout, fields, sc_scalars, gid)
        st = self.rf(torch.stack([getattr(rv, f) for f in _BIND_ROWS]),
                     xyz_rows=(0, 1, 2))
        rv = self._indexed(rv.replace(
            **{f: st[i] for i, f in enumerate(_BIND_ROWS)}))
        dt_m1k_cm = to_cm(layout, dt_m1k, fill=1.0)
        return self._fresh(rv, torch.where(rv.valid, dt_m1k_cm, 1.0),
                           scalars["dt"])

    def _unpack_local(self, bst: BDTState):
        """Resident frame -> the shard's particle frame [cap], with the
        gid and dt_m1k payload, and the psum'd count of rows that did
        not fit (must be 0). Only at cycle boundaries, where every slot
        sits at its kick point."""
        rv = bst.rv
        validint = rv.valid & self.intmask
        x, y, z = put_in_box(self.box, rv.x, rv.y, rv.z)
        pos = {"x": x, "y": y, "z": z}
        cols = [pos.get(f, getattr(rv, f)) for f in _FIELDS[:-1]]
        cols += [rv.gid, bst.dt_m1k]
        packed, n_own = _pack(validint, cols, self.sc.cap)
        lost_pack = self._gsum(torch.sum(validint, dtype=_I32) - n_own)
        alive = torch.arange(self.sc.cap, device=self.device) < n_own
        fields = dict(zip(_FIELDS[:-1], packed[:len(_FIELDS) - 1]))
        fields["h"] = torch.where(alive, fields["h"], 1.0)
        return Particles(alive=alive, **fields), packed[-2], packed[-1], \
            lost_pack

    def _resync_local(self, bst: BDTState):
        """Cycle-start full sync: unpack, migrate, rebind (the
        reference's sync(), ve_hydro_bdt.hpp:178). Returns the rebound
        state and the psum'd lost count (must be 0)."""
        ps, gid, dt_m1k, lost_pack = self._unpack_local(bst)
        ps, (gid, dt_m1k), lost_mig = migrate(self.comm, ps, self.box,
                                              self.sc, extras=(gid, dt_m1k))
        rv = bst.rv
        scalars = dict(ttot=rv.ttot, dt=rv.dt, dt_m1=rv.dt_m1,
                       iteration=rv.iteration)
        new = self._bind_local(ps, gid, dt_m1k, scalars, rv.overflow)
        return new.replace(dt_min=bst.dt_min), \
            lost_pack + self._gsum(lost_mig)


class ShardedBdtVE:
    """Slab-sharded resident BDT engine. `grid` is the per-shard local
    grid (n x n x nz_local); the global grid is n x n x (nz_local * D),
    plane-aligned with the slabs of migration. A state is a list of one
    BDTState per shard; diagnostics are reduced over the shards and
    come from shard 0."""

    def __init__(self, box: Box, grid: CMGrid, cfg: SphConfig,
                 sc: SlabConfig, mesh: SlabMesh, num_rungs: int = 4):
        if mesh.n_slabs != sc.n_slabs:
            raise ValueError(f"mesh of {mesh.n_slabs} shards, SlabConfig "
                             f"of {sc.n_slabs} slabs")
        self.box, self.grid, self.cfg, self.sc = box, grid, cfg, sc
        self.mesh = mesh
        self.num_rungs = num_rungs
        zxchg = make_zxchg(grid, box, mesh)
        self.shards = [_ShardBdtVE(box, grid, cfg, sc, comm, zxchg,
                                   num_rungs) for comm in mesh.comms]
        self.turb = None      # the OU state of TurbShardedBdtVE

    def _run(self, fn, *args):
        return self.mesh.run(lambda comm, eng, *a: fn(eng, *a), self.shards,
                             *args)

    # ---- host -> shards ----------------------------------------------------
    def distribute_bind(self, state: SimState) -> list:
        """Distribute the alive rows of a single-frame state into slabs
        and bind each shard's resident frame."""
        alive = state.p.alive.cpu().numpy()
        host = {f: getattr(state.p, f).cpu().numpy()[alive]
                for f in _FIELDS[:-1]}
        n = len(host["x"])
        gid_h = np.arange(n, dtype=np.float32)
        dtm1_h = np.full(n, float(state.dt_m1), np.float32)
        ps, extras = distribute(host, self.box, self.sc, self.mesh,
                                extras={"gid": gid_h, "dt_m1k": dtm1_h})

        def bind(eng, p, g, dk):
            dev = eng.device
            scalars = dict(ttot=state.ttot.to(dev).clone(),
                           dt=state.dt.to(dev).clone(),
                           dt_m1=state.dt_m1.to(dev).clone(),
                           iteration=state.iteration.to(dev).clone())
            return eng._bind_local(p, g, dk, scalars,
                                   torch.zeros((), dtype=_I32, device=dev))

        return self._run(bind, ps, extras["gid"], extras["dt_m1k"])

    # ---- the cycle ---------------------------------------------------------
    def resync(self, bsts: list):
        """Cycle-start sync on every shard: (states, lost)."""
        res = self._run(_ShardBdtVE._resync_local, bsts)
        return [r[0] for r in res], res[0][1]

    def substep(self, bsts: list, phases=None):
        """One substep of dt_min on every shard: (states, BDTDiag). With
        phases (one (real, imag) pair a shard, TurbulenceData.
        device_phases) it adds the stirring. No host sync."""
        res = self._run(lambda eng, b, ph: BdtVE.substep(eng, b, *ph), bsts,
                        phases or [()] * len(self.shards))
        return [r[0] for r in res], res[0][1]

    def run_cycle(self, bsts: list):
        """Full sync, then one rung hierarchy (2^(num_rungs-1)
        substeps). With stirring (TurbShardedBdtVE; TurbVeBdtProp under
        MPI, turb_ve.hpp:114-118) the OU noise advances on the host once
        a substep with the cycle's base dt, read from shard 0 as
        BdtVE.run_cycle reads it, and the projected phases go to every
        shard's substep replicated, never drawn per shard. Fail-stops on
        any migration or pack loss and on slot overflow."""
        bsts, lost = self.resync(bsts)
        if int(lost) != 0:
            raise RuntimeError(f"sharded BDT sync lost {int(lost)} rows")
        turb = self.turb
        dt_min = None if turb is None else float(bsts[0].dt_min)
        devices = [eng.device for eng in self.shards]
        diags = []
        for s in range(1 << (self.num_rungs - 1)):
            phases = None
            if turb is not None:
                turb.update_noise(dt_min)
                phases = turb.device_phases(devices)
            bsts, d = self.substep(bsts, phases)
            diags.append(d)
            if s == 0 and turb is not None:
                dt_min = float(bsts[0].dt_min)  # the cycle's base dt
        if any(int(d.overflow) != 0 for d in diags):
            raise RuntimeError("sharded BDT slot overflow")
        return bsts, diags

    def run_cycle_stirred(self, bsts: list, turb):
        """The JAX package's name for the stirred cycle: run_cycle of a
        TurbShardedBdtVE whose OU state is `turb`."""
        if turb is None or turb is not self.turb:
            raise ValueError("run_cycle_stirred takes the engine's own OU "
                             "state (TurbShardedBdtVE.turb)")
        return self.run_cycle(bsts)

    # ---- shards -> host ----------------------------------------------------
    def _slot_rows(self, bsts: list, rows):
        """Per shard, numpy (gid, row values) of its interior valid
        slots, for each row name of the BDTState (or of its rv)."""
        out = []
        for eng, b in zip(self.shards, bsts):
            vi = (b.rv.valid & eng.intmask).cpu().numpy()
            gid = b.rv.gid.cpu().numpy()[vi].astype(np.int64)
            out.append((gid, [getattr(b, r).cpu().numpy()[vi]
                              for r in rows]))
        return out

    def checkpoint_rungs(self, bsts: list, n_capacity: int) -> dict:
        """Particle-frame rung state (indexed by gid), at a cycle
        boundary only, as BdtVE.checkpoint_rungs."""
        if int(bsts[0].substep) != 0:
            raise ValueError("BDT checkpoints only at cycle boundaries")
        dev = self.mesh.devices[0]
        rung = np.zeros(n_capacity, np.float32)
        dtm = np.zeros(n_capacity, np.float32)
        for gid, (r, d) in self._slot_rows(bsts, ("rung", "dt_m1k")):
            rung[gid], dtm[gid] = r, d
        return {"fields": {"bdt_rung": torch.from_numpy(rung).to(dev),
                           "bdt_dt_m1k": torch.from_numpy(dtm).to(dev)},
                "attrs": {"bdt_dt_min": float(bsts[0].dt_min),
                          "bdt_num_rungs": self.num_rungs}}

    def restore_rungs(self, bsts: list, rung_pf, dt_m1k_pf,
                      dt_min: float) -> list:
        """Install checkpointed particle-frame rung state into freshly
        distributed states; each shard re-harmonizes its own cells."""
        return self._run(lambda eng, b: BdtVE.restore_rungs(
            eng, b, rung_pf, dt_m1k_pf, dt_min), bsts)

    def unbind(self, bsts: list, n_capacity: int) -> SimState:
        """Gather the shards' resident frames back into one particle
        frame in the original order (by gid), on shard 0's device."""
        res = self._run(lambda eng, b: eng._unpack_local(b)[:2], bsts)
        fields = {f: np.zeros(n_capacity, np.float32) for f in _FIELDS[:-1]}
        fields["h"][:] = 1.0
        alive = np.zeros(n_capacity, bool)
        for ps, gid in res:
            a = ps.alive.cpu().numpy()
            g = gid.cpu().numpy()[a].astype(np.int64)
            for f in _FIELDS[:-1]:
                fields[f][g] = getattr(ps, f).cpu().numpy()[a]
            alive[g] = True
        dev = self.mesh.devices[0]
        p = Particles(alive=torch.from_numpy(alive).to(dev),
                      **{f: torch.from_numpy(v).to(dev)
                         for f, v in fields.items()})
        rv = bsts[0].rv
        return SimState(p=p, ttot=rv.ttot.clone(), dt=rv.dt.clone(),
                        dt_m1=rv.dt_m1.clone(),
                        iteration=rv.iteration.clone())


class TurbShardedBdtVE(ShardedBdtVE):
    """Turbulence-stirred sharded BDT, the JAX package's production
    composition (ve_bdt_sharded.py:427-450; reference TurbVeBdtProp under
    MPI, turb_ve.hpp:114-118 with ve_hydro_bdt.hpp:171-288), self-gravity
    included. The OU state is global and small (112 modes from the
    reference constants), so it lives on the host and every shard's
    substep gets the same phases, as every MPI rank of the reference
    updates them from one shared RNG sequence. Each shard's engine holds
    the stirring modes on its device."""

    def __init__(self, box: Box, grid: CMGrid, cfg: SphConfig,
                 sc: SlabConfig, mesh: SlabMesh, turb=None,
                 num_rungs: int = 4, verbose: bool = False):
        from sphexa_tpu_torch.physics.turbulence import (StirModes,
                                                         TurbulenceData)
        super().__init__(box, grid, cfg, sc, mesh, num_rungs=num_rungs)
        self.turb = turb or TurbulenceData.create(verbose=verbose)
        for eng in self.shards:
            eng.stir = StirModes(self.turb, eng.device)
