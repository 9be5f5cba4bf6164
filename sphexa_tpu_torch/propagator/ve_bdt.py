"""Block time-steps on the resident cell-major engine.

Counterpart of sphexa_tpu/propagator/ve_bdt.py (BdtVE; reference:
main/src/propagator/ve_hydro_bdt.hpp, sph/include/sph/ts_rungs.hpp:
117-157). Single device, avClean off; the moment-matmul options
(mxu_moments, mxu_momentum) run their gated bodies. TurbBdtVE adds the
turbulence stirring (ve_bdt.py:424-451 of the JAX package). Self-gravity
(gravG != 0) is recomputed every substep on the drifted positions of
all slots and committed with the active slots' kick forces; its
acceleration limits each particle's dt at the rung assignment.

  - Rungs are per cell: rung_i = clip(floor(log2(dt_i / dt_i_min)), 0,
    num_rungs - 1), min-reduced over each cell at the cycle start.
  - A cycle is 2**(num_rungs-1) substeps of dt_min. At substep s the
    slots with s % 2**rung == 0 are at their kick points. The five pair
    stages run on the gated driver K2g (ops/pair_ve.py GATED_KERNELS):
    a z-supercell with no active slot keeps its frozen outputs, and the
    inactive cells of an active supercell are recomputed, exactly as
    the JAX package does. The per-slot freeze/commit below then keeps
    every inactive slot at its last kick values.
  - Every substep re-derives x, v and temp of all slots from their kick
    state at elapsed time ticks * dt_min; slots whose interval ends
    commit the advance as their new kick state.

The substep takes no host sync: every branch of the JAX substep is a
torch.where on device tensors. The cycle-start resync rebins the layout
(one host sync, as ResidentVE's rebin).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.ops.cellmajor import CMGrid, to_cm
from sphexa_tpu_torch.ops.pair_ve import FILL_POS, PairVE
from sphexa_tpu_torch.propagator.ve_cellmajor import (ResidentVE, RVState,
                                                      _add_gravity, _masked)
from sphexa_tpu_torch.sfc.box import Box
from sphexa_tpu_torch.sph import timestep as ts
from sphexa_tpu_torch.sph.eos import eos_ve, ideal_gas_cv
from sphexa_tpu_torch.sph.kernels import ts_k_courant, update_h
from sphexa_tpu_torch.sph.positions import position_update, temp_update
from sphexa_tpu_torch.state import SimState
from sphexa_tpu_torch.util.fp import rdiv
from sphexa_tpu_torch.util.kahan import kahan_sum


@dataclasses.dataclass
class BDTState:
    """Resident rows plus the per-slot kick state and frozen fields."""
    rv: RVState            # resident rows; x/v/temp are the drifted values
    # per-slot kick state (values committed at the slot's last kick)
    xk: torch.Tensor
    yk: torch.Tensor
    zk: torch.Tensor
    tempk: torch.Tensor
    dxk: torch.Tensor      # Press-2 displacement history at the kick
    dyk: torch.Tensor
    dzk: torch.Tensor
    axk: torch.Tensor      # acceleration committed at the kick
    ayk: torch.Tensor
    azk: torch.Tensor
    duk: torch.Tensor
    du_m1k: torch.Tensor
    dt_m1k: torch.Tensor   # per-slot previous kick interval
    rung: torch.Tensor     # per-slot rung (cell-harmonized), f32
    ticks: torch.Tensor    # substeps since last kick, f32
    # frozen dependent fields (last kick values, used as j-inputs)
    xm: torch.Tensor
    kx: torch.Tensor
    gradh: torch.Tensor
    c11: torch.Tensor
    c12: torch.Tensor
    c13: torch.Tensor
    c22: torch.Tensor
    c23: torch.Tensor
    c33: torch.Tensor
    divv: torch.Tensor
    dt_min: torch.Tensor   # cycle base timestep, 0-dim f32
    substep: torch.Tensor  # position within the cycle, 0-dim int32

    def replace(self, **kw) -> "BDTState":
        return dataclasses.replace(self, **kw)


class BDTDiag(NamedTuple):
    dt: torch.Tensor
    ttot: torch.Tensor
    etot: torch.Tensor
    ecin: torch.Tensor
    eint: torch.Tensor
    active_frac: torch.Tensor      # fraction of particles recomputed
    active_cell_frac: torch.Tensor
    rung_hist: torch.Tensor        # [num_rungs] particle counts
    overflow: torch.Tensor


class BdtVE(ResidentVE):
    """Resident engine with per-cell block time-steps. One cycle is
    2**(num_rungs-1) calls of .substep(); .run_cycle() advances a whole
    hierarchy. No method writes into a BDTState it is given (leaves
    alias each other after bind_bdt and resync)."""

    def __init__(self, box: Box, grid: CMGrid, cfg: SphConfig,
                 num_rungs: int = 4, device=None):
        super().__init__(box, grid, cfg, device=device)
        self.num_rungs = num_rungs
        # refuses av_clean, as the JAX substep asserts (ve_bdt.py:217)
        self.pve_gated = PairVE(grid, cfg, gated=True)
        # the OU state and its stirring modes on the device: set by
        # TurbBdtVE (the modes on each shard by TurbShardedBdtVE), None
        # without stirring
        self.turb = self.stir = None

    def _indexed(self, rst: RVState) -> RVState:
        # the stirring runs on the valid interior slots, as self-gravity
        if self.stir is not None:
            self.gravity_index(rst.valid)
        return super()._indexed(rst)

    # ---- global-reduction hooks: identity on one device (the sharded
    # engine of the JAX package swaps in pmin/pmax/psum) -----------------
    def _gmin(self, v):
        return v

    def _gmax(self, v):
        return v

    def _gsum(self, v):
        return v

    def _gravity(self, out, x, y, z, m, valid):
        """Per-substep self-gravity on the drifted positions
        (ve_hydro_bdt.hpp:277-288) over the valid interior slots of the
        occupancy row `valid`. Returns (out, egrav, nf_truncated)."""
        out, eg, nf = _add_gravity(out, x, y, z, m,
                                   self.gravity_index(valid), self.box,
                                   self.cfg)
        return out, self._gsum(eg), nf

    # ---- state management -------------------------------------------------
    def _fresh(self, rv: RVState, dt_m1k, dt_min) -> BDTState:
        """Every slot at its kick point, frozen fields at their neutral
        values (rebuilt by the all-active first substep)."""
        zero = torch.zeros_like(rv.x)
        one = torch.ones_like(rv.x)
        return BDTState(
            rv=rv, xk=rv.x, yk=rv.y, zk=rv.z, tempk=rv.temp,
            dxk=rv.x_m1, dyk=rv.y_m1, dzk=rv.z_m1,
            axk=zero, ayk=zero, azk=zero, duk=zero, du_m1k=rv.du_m1,
            dt_m1k=dt_m1k, rung=zero, ticks=zero,
            xm=one, kx=one, gradh=one, c11=zero, c12=zero, c13=zero,
            c22=zero, c23=zero, c33=zero, divv=zero,
            dt_min=dt_min, substep=torch.zeros((), dtype=torch.int32,
                                               device=rv.x.device))

    def bind_bdt(self, state: SimState) -> BDTState:
        rv = self.bind(state)
        return self._fresh(rv, state.dt_m1.expand_as(rv.x).clone(),
                           state.dt.clone())

    def _cell_min(self, row, validint, big=1e30):
        """Min-reduce a slot row over each cell (rung harmonization)."""
        cap = self.grid.cap
        per_cell = torch.where(validint, row, big).reshape(-1, cap).amin(1)
        return per_cell[:, None].expand(-1, cap).reshape(-1)

    def _resync_1chip(self, bst: BDTState):
        """Cycle-start full layout rebin (the reference's sync() at every
        cycle start, ve_hydro_bdt.hpp:178). At substep 0 every slot sits
        at its kick point, so only dt_m1k rides the rebin."""
        rv2, layout = self._rebin(bst.rv)
        dt_m1k = torch.where(rv2.valid, to_cm(layout, bst.dt_m1k, fill=1.0),
                             1.0)
        lost = torch.zeros((), dtype=torch.int32, device=self.device)
        return self._fresh(rv2, dt_m1k, bst.dt_min), lost

    def resync(self, bst: BDTState):
        """Cycle-start sync; returns (state, lost), lost always 0 on one
        device (kept for parity with the sharded engine)."""
        return self._resync_1chip(bst)

    # ---- one substep -------------------------------------------------------
    def substep(self, bst: BDTState, phases_real=None, phases_imag=None):
        """One substep of dt_min: the five gated stages and five ghost
        refreshes. With phases (the projected OU phases [M, 3] as float32
        tensors on the engine's device) it adds the turbulence stirring
        (TurbBdtVE). Returns (new state, BDTDiag); takes no host sync
        (the stirring's slot index is built at the resync)."""
        cfg = self.cfg
        rv = bst.rv
        validint = rv.valid & self.intmask
        s = bst.substep

        # kick points: slots whose tick counter wrapped to zero
        cycle_start = s == 0
        active = validint & ((bst.ticks < 0.5) | cycle_start)
        act_row = active.to(torch.float32)

        # ---- gated force pipeline: frozen fields ride as prev outputs ----
        base = [rv.x, rv.y, rv.z, rv.h, rv.gid]
        out = _run_pipeline_gated(
            self.pve_gated, self.rf, base, rv.m, rv.vx, rv.vy, rv.vz,
            rv.temp, rv.alpha, bst.dt_min, validint, act_row,
            prev=dict(xm=bst.xm, h=rv.h, kx=bst.kx, gradh=bst.gradh,
                      cij=(bst.c11, bst.c12, bst.c13, bst.c22, bst.c23,
                           bst.c33), divv=bst.divv, alpha=rv.alpha,
                      ax=bst.axk, ay=bst.ayk, az=bst.azk, du=bst.duk))
        if phases_real is not None:
            # turbulence stirring on the drifted positions (TurbVeBdtProp,
            # turb_ve.hpp:114-118: driveTurbulence after the force step),
            # committed with the active slots' kick acceleration. The JAX
            # package sums it over every slot; here over the valid
            # interior slots, the only ones whose kick state takes it.
            if self.stir is None:
                raise ValueError("phases given to an engine without "
                                 "stirring modes (use TurbBdtVE)")
            idx = self.gravity_index(rv.valid)
            stirred = self.stir.stir(rv.x[idx], rv.y[idx], rv.z[idx],
                                     phases_real, phases_imag)
            out = dict(out, **{
                k: out[k] + torch.zeros_like(rv.x).index_copy_(0, idx, a)
                for k, a in zip(("ax", "ay", "az"), stirred)})
        # self-gravity recomputed every substep from the drifted
        # positions; inactive slots keep their frozen kick acceleration,
        # gravity included
        egrav = torch.zeros((), dtype=torch.float32, device=rv.x.device)
        grav_nf = torch.zeros((), dtype=torch.int32, device=rv.x.device)
        if cfg.gravG != 0.0:
            out, egrav, grav_nf = self._gravity(out, rv.x, rv.y, rv.z, rv.m,
                                                rv.valid)

        # per-slot freeze/commit (the kernel gate is the compute skip at
        # supercell granularity)
        def pick(new, old):
            return torch.where(active, new, old)

        axk = pick(out["ax"], bst.axk)
        ayk = pick(out["ay"], bst.ayk)
        azk = pick(out["az"], bst.azk)
        duk = pick(out["du"], bst.duk)
        cij = tuple(pick(out[k], getattr(bst, k))
                    for k in ("c11", "c12", "c13", "c22", "c23", "c33"))
        alpha = pick(out["alpha"], rv.alpha)
        h = pick(out["h"], rv.h)

        # ---- rung (re)assignment at cycle start: ratios relative to the
        # unclamped min particle dt (ts_rungs.hpp:134-146) ----
        dt_i = ts_k_courant(out["maxvsignal"], h, out["c"], cfg.kcour)
        if cfg.gravG != 0.0:
            # per-particle acceleration limit (groupAccTimestep,
            # ve_hydro_bdt.hpp:289; ts_global.hpp:46)
            acc = torch.sqrt(out["ax"] ** 2 + out["ay"] ** 2
                             + out["az"] ** 2)
            dt_acc = cfg.eta_acc * torch.sqrt(
                rdiv(cfg.eps, torch.clamp_min(acc, 1e-30)))
            dt_i = torch.minimum(dt_i, dt_acc)
        dt_i_min = self._gmin(torch.min(torch.where(validint, dt_i, 1e30)))
        dt_rho = self._gmin(ts.rho_timestep(out["divv"], validint, cfg.krho))
        dt_min_new = torch.minimum(torch.minimum(dt_i_min, dt_rho),
                                   cfg.max_dt_increase * bst.dt_min)
        rung_new = torch.clamp(torch.floor(torch.log2(torch.clamp_min(
            dt_i / torch.clamp_min(dt_i_min, 1e-30), 1.0))),
            0.0, float(self.num_rungs - 1))
        rung_new = self._cell_min(rung_new, validint)
        rung = torch.where(cycle_start, rung_new, bst.rung)
        dt_min = torch.where(cycle_start, dt_min_new, bst.dt_min)
        ticks = torch.where(cycle_start, 0.0, bst.ticks)

        # ---- drift/kick: re-derive everyone from the kick state ----
        tau = (ticks + 1.0) * dt_min
        xn, yn, zn, vxn, vyn, vzn, dxn, dyn, dzn = position_update(
            tau, bst.dt_m1k, bst.xk, bst.yk, bst.zk, axk, ayk, azk,
            bst.dxk, bst.dyk, bst.dzk, self.box,
            h=h, vx=rv.vx, vy=rv.vy, vz=rv.vz, fold=False)
        temp_n = temp_update(bst.tempk, tau, bst.dt_m1k, duk, bst.du_m1k,
                             cfg.mui, cfg.gamma)

        kick_done = (ticks + 1.0) >= (2.0 ** rung) - 0.5

        def pickk(new, old):
            return torch.where(kick_done, new, old)

        last = (1 << (self.num_rungs - 1)) - 1
        new_bst = bst.replace(
            xk=pickk(xn, bst.xk), yk=pickk(yn, bst.yk), zk=pickk(zn, bst.zk),
            dxk=pickk(dxn, bst.dxk), dyk=pickk(dyn, bst.dyk),
            dzk=pickk(dzn, bst.dzk), tempk=pickk(temp_n, bst.tempk),
            du_m1k=pickk(duk, bst.du_m1k), dt_m1k=pickk(tau, bst.dt_m1k),
            axk=axk, ayk=ayk, azk=azk, duk=duk,
            ticks=torch.where(kick_done, 0.0, ticks + 1.0),
            rung=rung, dt_min=dt_min,
            substep=torch.where(s >= last, torch.zeros_like(s), s + 1),
            xm=pick(out["xm"], bst.xm), kx=pick(out["kx"], bst.kx),
            gradh=pick(out["gradh"], bst.gradh), c11=cij[0], c12=cij[1],
            c13=cij[2], c22=cij[3], c23=cij[4], c33=cij[5],
            divv=pick(out["divv"], bst.divv))

        # h controller at the particle's active substep, where nc is
        # freshly counted; no h_cap here (ve_bdt.py:327 of the JAX package)
        h_new = torch.where(active, update_h(cfg.ng0, out["nc_sph"], h), h)

        # drift accounting + ghost refresh of the mutated rows
        disp2 = (xn - rv.x) ** 2 + (yn - rv.y) ** 2 + (zn - rv.z) ** 2
        step_disp = self._gmax(torch.sqrt(torch.max(_masked(disp2,
                                                            validint))))
        st = self.rf(torch.stack([xn, yn, zn, h_new, vxn, vyn, vzn, temp_n,
                                  duk, dxn, dyn, dzn]), xyz_rows=(0, 1, 2))
        rv = rv.replace(
            x=st[0], y=st[1], z=st[2], h=st[3], vx=st[4], vy=st[5],
            vz=st[6], temp=st[7], du_m1=st[8], x_m1=st[9], y_m1=st[10],
            z_m1=st[11], alpha=alpha, drift=rv.drift + step_disp,
            ttot=rv.ttot + dt_min, dt=dt_min, dt_m1=bst.dt_min,
            iteration=rv.iteration + 1)
        new_bst = new_bst.replace(rv=rv)

        # ---- diagnostics ----
        cv = ideal_gas_cv(cfg.mui, cfg.gamma)
        ecin = self._gsum(0.5 * kahan_sum(_masked(
            rv.m * (rv.vx ** 2 + rv.vy ** 2 + rv.vz ** 2), validint)))
        eint = self._gsum(kahan_sum(_masked(rv.m * cv * rv.temp, validint)))
        nvalid = torch.clamp_min(self._gsum(torch.sum(validint)),
                                 1).to(torch.float32)
        cap = self.grid.cap
        cell_act = act_row.reshape(-1, cap).amax(1)
        cell_occ = validint.reshape(-1, cap).any(1)
        rung_hist = self._gsum(torch.stack([
            torch.sum(validint & (torch.round(rung) == r))
            for r in range(self.num_rungs)]).to(torch.int32))
        diag = BDTDiag(
            dt=dt_min, ttot=rv.ttot, etot=ecin + eint + egrav, ecin=ecin,
            eint=eint,
            active_frac=self._gsum(torch.sum(act_row)) / nvalid,
            active_cell_frac=(self._gsum(torch.sum(cell_act))
                              / torch.clamp_min(
                                  self._gsum(torch.sum(cell_occ)), 1)),
            rung_hist=rung_hist, overflow=rv.overflow + grav_nf)
        return new_bst, diag

    def run_cycle(self, bst: BDTState):
        """Cycle-start sync (layout rebin), then one rung hierarchy of
        2**(num_rungs-1) substeps (ve_hydro_bdt.hpp:171-212). With
        stirring (TurbBdtVE) the OU noise advances on the host before
        each substep with the cycle's base dt, as the JAX package's
        TurbBdtVE (ve_bdt.py:424-451): the resync's dt_min before
        substep 0, the one substep 0 assigns before each later one; so
        such a cycle reads the device dt_min twice and its substeps
        take no host sync. Returns (state, list of BDTDiag)."""
        bst, _ = self.resync(bst)
        turb = self.turb
        dt_min = None if turb is None else float(bst.dt_min)
        diags = []
        for s in range(1 << (self.num_rungs - 1)):
            phases = ()
            if turb is not None:
                turb.update_noise(dt_min)
                (phases,) = turb.device_phases([self.device])
            bst, d = self.substep(bst, *phases)
            diags.append(d)
            if s == 0 and turb is not None:
                dt_min = float(bst.dt_min)      # the cycle's base dt
        return bst, diags

    # ---- rung-state checkpointing (sph/timestep.h:29-34: a restarted
    # run resumes the same rung assignment) ------------------------------
    def checkpoint_rungs(self, bst: BDTState, n_capacity: int) -> dict:
        """Particle-frame rung state. Only at a cycle boundary
        (bst.substep == 0), where the kick state is the state."""
        if int(bst.substep) != 0:
            raise ValueError("BDT checkpoints only at cycle boundaries")
        rv = bst.rv
        validint = rv.valid & self.intmask
        idx = torch.where(validint, rv.gid,
                          float(n_capacity)).to(torch.int64)

        def back(row, fill=0.0):
            # one spare row takes the writes of invalid slots
            out = torch.full((n_capacity + 1,), fill, dtype=row.dtype,
                             device=row.device)
            out[idx] = _masked(row, validint, fill)
            return out[:n_capacity]

        return {"fields": {"bdt_rung": back(bst.rung),
                           "bdt_dt_m1k": back(bst.dt_m1k)},
                "attrs": {"bdt_dt_min": float(bst.dt_min),
                          "bdt_num_rungs": self.num_rungs}}

    def restore_rungs(self, bst: BDTState, rung_pf, dt_m1k_pf,
                      dt_min: float) -> BDTState:
        """Install checkpointed rung state into a freshly bound BDTState
        (particle-frame arrays in the order bind() consumed)."""
        rv = bst.rv
        f32 = dict(dtype=torch.float32, device=self.device)
        gid = torch.where(rv.valid, rv.gid, 0.0).to(torch.int64)
        rung_cm = torch.as_tensor(rung_pf, **f32)[gid]
        dt_m1k_cm = torch.as_tensor(dt_m1k_pf, **f32)[gid]
        validint = rv.valid & self.intmask
        # re-harmonize per cell (slots may land in other cells after the
        # rebind's fold)
        rung_cm = self._cell_min(rung_cm, validint)
        dt_min = torch.full((), dt_min, **f32)
        return bst.replace(rung=torch.where(validint, rung_cm, 0.0),
                           dt_m1k=torch.where(validint, dt_m1k_cm, dt_min),
                           ticks=torch.zeros_like(bst.ticks),
                           dt_min=dt_min,
                           substep=torch.zeros_like(bst.substep))


class TurbBdtVE(BdtVE):
    """Turbulence-stirred block-time-step engine (reference:
    TurbVeBdtProp, main/src/propagator/turb_ve.hpp:114-118): BdtVE with
    an OU state (.turb) and its stirring modes on the device, so that
    run_cycle draws the projected phases once a substep on the host and
    each substep commits the stirring with the active slots' kick
    forces."""

    def __init__(self, box: Box, grid: CMGrid, cfg: SphConfig, turb=None,
                 num_rungs: int = 4, verbose: bool = False, device=None):
        from sphexa_tpu_torch.physics.turbulence import (StirModes,
                                                         TurbulenceData)
        super().__init__(box, grid, cfg, num_rungs=num_rungs, device=device)
        self.turb = turb or TurbulenceData.create(verbose=verbose)
        self.stir = StirModes(self.turb, self.device)


def _run_pipeline_gated(pve: PairVE, refresh, base, m, vx, vy, vz, temp,
                        alpha, dt, validint, act_row, prev):
    """The five pair stages with supercell gating: inactive supercells
    keep their frozen previous outputs. Refreshes as the JAX package's
    _run_pipeline_gated (ve_bdt.py:454-502): [xm, h], [kx, gradh],
    [cij, divv] (curlv is not read) and [alpha]."""
    cfg = pve.cfg
    zero = torch.zeros_like(m)

    def gate(*prevs):
        return act_row, prevs

    xm, h_new, nc, _ = pve.xmass_h(
        base, m, gate=gate(prev["xm"], prev["h"], zero, zero))
    h_new = torch.where(validint, h_new, base[3])
    st = refresh(torch.stack([xm, h_new]))
    xm, h_new = st[0], st[1]
    base = [base[0], base[1], base[2], h_new, base[4]]
    nc_sph = nc + 1.0

    kx, gradh = pve.gradh(base, m, xm, gate=gate(prev["kx"], prev["gradh"]))
    st = refresh(torch.stack([kx, gradh]))
    kx, gradh = st[0], st[1]

    # frame contract: invalid slots stream finite, divide-safe values
    rho, p, c, prho = eos_ve(temp, m, kx, xm, gradh, cfg.mui, cfg.gamma)
    va = base[0] < 0.5 * FILL_POS
    rho = torch.where(va, rho, 1.0)
    c = torch.where(va, c, 1.0)
    prho = torch.where(va, prho, 0.0)

    cij, divv, _, _ = pve.iad_divv(
        base, kx, xm, vx, vy, vz, gate=gate(*prev["cij"], prev["divv"]))
    st = refresh(torch.stack(list(cij) + [divv]))
    cij = tuple(st[i] for i in range(6))
    divv = st[6]

    alpha_out = pve.av_switches(base, c, kx, xm, divv, vx, vy, vz, cij,
                                alpha, dt, gate=gate(prev["alpha"]))
    alpha_new = torch.where(validint, alpha_out, alpha)
    alpha_new = refresh(alpha_new[None].contiguous())[0]

    ax, ay, az, du, mvs = pve.momentum(
        base, vx, vy, vz, c, prho, rho, xm, alpha_new, m, cij,
        gate=gate(prev["ax"], prev["ay"], prev["az"], prev["du"]))
    return dict(h=h_new, nc_sph=nc_sph, xm=xm, kx=kx, gradh=gradh, c=c,
                prho=prho, rho=rho, divv=divv, alpha=alpha_new,
                c11=cij[0], c12=cij[1], c13=cij[2], c22=cij[3],
                c23=cij[4], c33=cij[5],
                ax=ax, ay=ay, az=az, du=du, maxvsignal=mvs)
