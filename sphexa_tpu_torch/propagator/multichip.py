"""The command line's multi-device adapter: it builds the shard group
and drives the sharded engines from the main loop,

    SPHEXA_NUM_DEVICES=2 python -m sphexa_tpu_torch.main --init evrard \\
        -n 20 --prop ve-hilbert

the analog of the reference's `mpiexec -np N sphexa ...` (reference:
main/src/sphexa/sphexa.cpp:66-194). Counterpart of
sphexa_tpu/propagator/multichip.py. The adapter distributes the initial
state from the host, carries the shards' state between steps and maps
the sharded diagnostics onto what the main loop reads.

Shards: SPHEXA_NUM_DEVICES=D (the JAX CLI's variable) gives D shards,
placed round robin over the devices the port runs on (domain/mesh.
SlabMesh: on one card every shard is a thread on cuda:0); unset, D is
the number of those devices (torch.cuda.device_count() on the GPU, 1
on the CPU). Below 2 the adapter exits, as the JAX adapter does.

The state the main loop sees is the JAX CLI's: every shard's frame of
`cap` rows, concatenated in shard order (padding rows dead), on shard
0's device; each call cuts it back into the shards' frames. The
block-time-step props hand back the gathered frame of the initial
particles (ShardedBdtVE.unbind).

Capacities come from the measured initial distribution: per-shard
counts set the caps (x 1.7 margin), and with the FMM solver on the
Hilbert domain the gravity band cap comes from fmm.estimate_band_cap on
the realized leaf occupancy. Every overflow is a runtime fail-stop.

ve-pallas-tiles (the 2-D tile domain) is sized as the JAX adapter sizes
it off the TPU (multichip.py:198-241: the grid of choose_cap_and_grid
with cap_max 4096, the pair kernels' MAX_CAP), with three differences:
the halo cap rises to 1.3 x the measured halo (plan_tile_halo) + 64
where the JAX rule's max(0.6 N / D, 256) is below it; a shard count
that R x C tiles do not factor exactly is refused (the JAX rule
R = 2^floor(floor(log2 D) / 2), C = D // R runs 8 of 9 devices); and a
step whose tiles outgrew their static windows (TileDiag.span_ok false,
which the JAX adapter does not read) is handed back to the main loop as
a re-plan (`_MCDiag.replan`): the loop restores the state and builds a
new adapter, which re-plans the windows from it (ROADMAP Queue 3). The
slab props take the JAX slab plan wherever its cap is within MAX_CAP
(ve_sharded.plan_slab).
"""

from __future__ import annotations

import os
import types

import numpy as np
import torch

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.domain.mesh import SlabMesh
from sphexa_tpu_torch.propagator.ve_pallas_tiles import tile_factors
from sphexa_tpu_torch.propagator.ve_sharded import plan_slab, round_up
from sphexa_tpu_torch.sfc.box import Box
from sphexa_tpu_torch.state import _FIELDS, Particles, SimState

# the JAX package's multi-device props (multichip.py:31)
MULTICHIP_PROPS = ("ve-hilbert", "ve-pallas-sharded", "ve-bdt-sharded",
                   "ve-tiered-sharded", "turbulence-ve-bdt-sharded",
                   "ve-pallas-tiles")
# the rungs of the BDT props, the JAX adapter's (ShardedBdtVE's default)
BDT_RUNGS = 4


def shard_devices(device: torch.device) -> tuple:
    """(D, devices): the shard count and the devices the shards are
    placed on, round robin (SPHEXA_NUM_DEVICES, else one shard a
    device)."""
    if device.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [device]
    env = os.environ.get("SPHEXA_NUM_DEVICES")
    return (int(env) if env else len(devices)), devices


class _MCDiag:
    """The diagnostics the main loop reads (ipropagator.hpp:100)."""

    nc_mean = 0.0
    h_nonconv = None
    bounds = None           # open-box growth: single-device only
    maxvsignal = 0.0

    def __init__(self, d, replan: bool = False):
        self.dt, self.ttot = d.dt, d.ttot
        self.etot, self.ecin, self.eint = d.etot, d.ecin, d.eint
        self.egrav = float(d.etot) - float(d.ecin) - float(d.eint)
        self.h_max = d.h_max
        self.max_nc = d.max_nc
        # the tiered fold rides max_cell_count, so the main loop's
        # re-tier branch fires on any nonzero value; ve-hilbert's densest
        # cell does, so the loop re-grids past cell_cap as it does for
        # the single-device gather step
        self.max_cell_count = int(getattr(d, "fold", 0)
                                  or getattr(d, "max_cell_count", 0))
        # the tiles outgrew their windows: the step is void, re-plan
        self.replan = replan
        self.raw = d


def _host_fields(p: Particles) -> dict:
    """Alive rows of a (concatenated, padded) frame as host numpy."""
    alive = p.alive.cpu().numpy()
    return {f: getattr(p, f).cpu().numpy()[alive] for f in _FIELDS[:-1]}


def _cells_at_level(host: dict, box: Box, level: int):
    nn = 1 << level
    g = np.stack([
        np.clip(((host[c] - lo) / ln * nn).astype(np.int64), 0, nn - 1)
        for c, lo, ln in (("x", box.xmin, box.lx), ("y", box.ymin, box.ly),
                          ("z", box.zmin, box.lz))], 1)
    return (g[:, 0] * nn + g[:, 1]) * nn + g[:, 2]


class MultiChipAdapter:
    def __init__(self, prop: str, box: Box, cfg: SphConfig,
                 state: SimState, h_max: float, quiet: bool = True,
                 extras: dict | None = None, device=None):
        extras = extras or {}
        device = torch.device(device or state.p.device)
        D, devices = shard_devices(device)
        if D < 2:
            raise SystemExit(
                f"--prop {prop} needs >= 2 devices (got {D}); for tests "
                "set SPHEXA_PLATFORM=cpu SPHEXA_NUM_DEVICES=8")
        self.prop, self.box, self.cfg, self.D = prop, box, cfg, D
        self._bdt_restore = extras.get("bdt")
        self.bdt = None
        host = _host_fields(state.p)
        self.n_global = len(host["x"])
        n_per = self.n_global / D
        states0 = None

        if prop in ("ve-hilbert", "ve-tiered-sharded"):
            from sphexa_tpu_torch.domain.hilbert import (HilbertConfig,
                                                         hilbert_keys)
            from sphexa_tpu_torch.propagator.ve_hilbert import \
                distribute_hilbert
            cap = round_up(int(n_per * 1.7) + 128, 8)
            halo_cap = round_up(int(n_per) + 128, 8)
            # pooled halo frame past ~6 shards: the extended frame stops
            # growing with D (domain/hilbert.py)
            pool = 0 if D <= 6 else round_up(6 * halo_cap, 8)
            hc = HilbertConfig(
                n_ranks=D, cap=cap, halo_cap=halo_cap,
                mig_cap=round_up(max(int(n_per * 0.5), 256), 8),
                coarse=8, dilate=3, halo_pool=pool)
            self.hc = hc
            if cfg.gravG != 0.0 and cfg.gravity_solver == "fmm" \
                    and cfg.gravity_band_cap == 0:
                from sphexa_tpu_torch.gravity.fmm import estimate_band_cap
                keys = hilbert_keys(box, *(torch.from_numpy(
                    np.asarray(host[c], np.float32)) for c in "xyz"))
                order = np.argsort(keys.numpy(), kind="stable")
                bounds = [int(round(self.n_global * d / D))
                          for d in range(D + 1)]
                cells = _cells_at_level(host, box, cfg.fmm_level)
                bc = estimate_band_cap(
                    [cells[order[bounds[d]:bounds[d + 1]]]
                     for d in range(D)], cfg.fmm_level)
                cfg = self.cfg = cfg.replace(gravity_band_cap=min(bc, cap))
                if not quiet:
                    print(f"# gravity band_cap={cfg.gravity_band_cap} "
                          f"(measured, cap={cap})")
            mesh = self.mesh = SlabMesh(D, devices)
            parts = distribute_hilbert(host, box, hc, mesh)
            if prop == "ve-tiered-sharded":
                # the global tier set from the initial state; each shard
                # runs it gated over its own rows
                from sphexa_tpu_torch.propagator.ve_tiered import \
                    choose_tiers_auto
                from sphexa_tpu_torch.propagator.ve_tiered_sharded import \
                    make_ve_step_tiered_hilbert
                tiers = choose_tiers_auto(box, host["x"], host["y"],
                                          host["z"], host["h"])
                if not quiet:
                    print("# tiers: " + "; ".join(
                        f"h[{t.h_lo:.3g},{t.h_hi:.3g}) n={t.grid.n} "
                        f"cap={t.grid.cap}" for t in tiers))
                self.grid = tiers
                self._step = make_ve_step_tiered_hilbert(box, tiers, cfg,
                                                         hc, mesh)
            else:
                from sphexa_tpu_torch.neighbors import CellGrid, choose_level
                from sphexa_tpu_torch.propagator.ve_hilbert import \
                    make_ve_step_hilbert
                self.grid = CellGrid(choose_level(box, h_max * 1.3))
                self._step = make_ve_step_hilbert(box, self.grid, cfg, hc,
                                                  mesh)
            states0 = parts
        elif prop in ("ve-pallas-sharded", "ve-bdt-sharded",
                      "turbulence-ve-bdt-sharded"):
            grid, sc = self._slab_setup(host, box, h_max, quiet)
            mesh = self.mesh = SlabMesh(self.D, devices)
            if prop == "ve-pallas-sharded":
                from sphexa_tpu_torch.propagator.ve_pallas_sharded import \
                    make_ve_step_pallas_sharded
                from sphexa_tpu_torch.propagator.ve_sharded import distribute
                states0 = distribute(host, box, sc, mesh)
                self._step = make_ve_step_pallas_sharded(box, grid, cfg, sc,
                                                         mesh)
            elif prop == "ve-bdt-sharded":
                # rungs on the whole distributed domain
                # (ve_hydro_bdt.hpp:171-212), gravity in the substep
                from sphexa_tpu_torch.propagator.ve_bdt_sharded import \
                    ShardedBdtVE
                self.bdt = ShardedBdtVE(box, grid, cfg, sc, mesh,
                                        num_rungs=BDT_RUNGS)
            else:
                # domain x BDT x gravity x turbulence (TurbVeBdtProp
                # under MPI)
                from sphexa_tpu_torch.physics.turbulence import \
                    TurbulenceData
                from sphexa_tpu_torch.propagator.ve_bdt_sharded import \
                    TurbShardedBdtVE
                turb = TurbulenceData.create(verbose=not quiet)
                if "turb" in extras:   # restart: the OU phases and RNG
                    turb.restore(extras["turb"])
                self.bdt = TurbShardedBdtVE(box, grid, cfg, sc, mesh,
                                            turb=turb, num_rungs=BDT_RUNGS)
                self.turb = turb
            self.bst = None
        elif prop == "ve-pallas-tiles":
            states0 = self._tile_setup(host, box, h_max, devices, quiet)
        else:
            raise ValueError(f"unknown multi-device propagator {prop}")

        self._states0 = states0
        if not quiet:
            print(f"# multichip: {prop} on {self.D} shards over "
                  f"{[str(d) for d in devices]}, grid={self.grid}")

    def _slab_setup(self, host, box, h_max, quiet):
        """The slab engines' sizing (plan_slab): the halo-width shrink of
        the shard count (below 2 shards the adapter exits, as the JAX
        one does), measured cell and slab caps: the JAX plan wherever its
        cell cap is within the pair kernels' ceiling MAX_CAP (4096), else
        a finer grid (none fitting raises RuntimeError, a fail-stop)."""
        try:
            grid, sc = plan_slab(host, box, h_max, self.D)
        except ValueError as e:
            raise SystemExit(str(e)) from None
        if sc.n_slabs < self.D and not quiet:
            print(f"# multichip: shrunk mesh to {sc.n_slabs} shards (slab "
                  f"halo-width constraint at h_max={h_max:.3g})")
        self.D = sc.n_slabs
        self.grid, self.sc = grid, sc
        return grid, sc

    def _tile_setup(self, host, box, h_max, devices, quiet):
        """The tile domain's sizing (plan_tile_domain: the JAX adapter's
        off the TPU, with the halo cap at least the measured halo's and
        R x C = D exactly, else an exit); returns the initial shards."""
        from sphexa_tpu_torch.propagator.ve_pallas_tiles import (
            distribute_tiles, make_ve_step_pallas_tiles, plan_tile_domain)
        try:
            grid, td = plan_tile_domain(box, host, h_max, self.n_global,
                                        self.D)
        except ValueError as e:
            raise SystemExit(f"--prop ve-pallas-tiles: {e}") from None
        self.td = td
        if not quiet:
            print(f"# tiles: R={td.n_rows} C={td.n_cols} "
                  f"rows_cap={td.rows_cap} zcols_cap={td.zcols_cap}")
        mesh = self.mesh = SlabMesh(self.D, devices)
        self.grid = grid
        self._step = make_ve_step_pallas_tiles(box, td, grid.cap, self.cfg,
                                               mesh)
        return distribute_tiles(host, box, td, mesh)

    def checkpoint_state(self, n_capacity):
        """Rung state for the writer (timestep.h:29-34), block-time-step
        props only, at a cycle boundary."""
        if self.bdt is None or self.bst is None:
            return None
        return self.bdt.checkpoint_rungs(self.bst, n_capacity)

    def _call_bdt(self, state: SimState):
        if self.bst is None:
            self.bst = self.bdt.distribute_bind(state)
            if self._bdt_restore is not None:
                # restart: resume the checkpointed rung assignment
                r = self._bdt_restore
                self.bst = self.bdt.restore_rungs(
                    self.bst, r["rung"], r["dt_m1k"], r["dt_min"])
        self.bst, diags = self.bdt.run_cycle(self.bst)
        d = diags[-1]
        out = self.bdt.unbind(self.bst, self.n_global)
        fr = float(np.mean([float(x.active_frac) for x in diags]))
        print(f"# bdt: active fraction {fr:.2f}, rungs "
              f"{d.rung_hist.cpu().tolist()}")
        diag = types.SimpleNamespace(
            dt=d.dt, ttot=d.ttot, etot=d.etot, ecin=d.ecin, eint=d.eint,
            egrav=float(d.etot) - float(d.ecin) - float(d.eint),
            h_max=torch.max(torch.where(out.p.alive, out.p.h, 0.0)),
            nc_mean=0.0, max_nc=0, max_cell_count=0, h_nonconv=None,
            bounds=None, maxvsignal=0.0, raw=d, diags=diags)
        return out, diag

    def _split(self, state: SimState) -> list:
        """The concatenated frame cut into the shards' frames."""
        D = self.mesh.n_slabs
        n = state.p.n // D
        out = []
        for i, dev in enumerate(self.mesh.devices):
            rows = slice(i * n, (i + 1) * n)
            p = Particles(**{f: getattr(state.p, f)[rows].to(dev)
                             for f in _FIELDS})
            out.append(self._scalars(state, p, dev))
        return out

    @staticmethod
    def _scalars(state: SimState, p: Particles, dev) -> SimState:
        return SimState(p=p, ttot=state.ttot.to(dev), dt=state.dt.to(dev),
                        dt_m1=state.dt_m1.to(dev),
                        iteration=state.iteration.to(dev))

    def _join(self, states: list) -> SimState:
        dev = self.mesh.devices[0]
        p = Particles(**{f: torch.cat([getattr(s.p, f).to(dev)
                                       for s in states]) for f in _FIELDS})
        s0 = states[0]
        return SimState(p=p, ttot=s0.ttot, dt=s0.dt, dt_m1=s0.dt_m1,
                        iteration=s0.iteration)

    def __call__(self, state: SimState):
        if self.bdt is not None:
            return self._call_bdt(state)
        if self._states0 is not None:   # first call: the distribution
            states = [self._scalars(state, p, p.device)
                      for p in self._states0]
            self._states0 = None
        else:
            states = self._split(state)
        states, d = self._step(states)
        if not bool(getattr(d, "span_ok", True)):
            # a tile outgrew its window: the step's clipped rows void it
            # (its lost and overflow counts too); the loop re-plans
            return self._join(states), _MCDiag(d, replan=True)
        # fail-stops (the reference throws on a capacity or exchange loss)
        lost = int(d.lost)
        if lost != 0:
            raise RuntimeError(
                f"multichip fail-stop: {lost} particles lost to "
                "migration/halo/gravity-band overflow: raise the caps")
        ovf = int(getattr(d, "overflow", 0))
        if ovf != 0:
            raise RuntimeError(
                f"multichip fail-stop: {ovf} cell-major slot overflows")
        # the column and tile diags report the largest shard's count as
        # n_owned and the sum as n_total
        n_owned = int(getattr(d, "n_total", d.n_owned))
        if n_owned != self.n_global:
            raise RuntimeError(
                f"conservation violation: {n_owned} owned vs "
                f"{self.n_global} initial")
        return self._join(states), _MCDiag(d)
