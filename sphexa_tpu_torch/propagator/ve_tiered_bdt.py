"""Block time-steps on the h-tier zoom grids.

Counterpart of sphexa_tpu/propagator/ve_tiered_bdt.py (reference: the
BDT propagator on the focused octree, main/src/propagator/
ve_hydro_bdt.hpp; rung groups, sph/include/sph/ts_rungs.hpp:117-157).
The particle-frame variant:

  - rungs live per tier cell (the min over the owner tier's cell, the
    compute-skip granularity of the gated tier kernels);
  - a substep runs the five tiered pair stages (_tiered_forces) on the
    gated driver K2g (PairVE(gated=True) on each tier grid): only
    supercells holding an active particle compute. At every merge point
    the inactive rows are overwritten from the frozen kick-state store
    (h, xm, kx, gradh, cij, divv, alpha); the EOS is recomputed from the
    frozen inputs and the drifted temp;
  - integration re-derives x, v and temp of every particle from its kick
    state at elapsed time ticks * dt_min and commits the particles whose
    interval ends (the drift-back scheme of positions_gpu.cu:47-90);
    the tier layouts rebuild from the drifted positions every substep;
  - self-gravity is recomputed every substep on the alive rows
    (ve_hydro_bdt.hpp:277-288) and committed with the active particles'
    kick forces.

A substep takes no host sync once the gravity index exists (built by
bind). run_cycle(check=False) leaves the fold to the caller, which reads
it once a cycle.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.ops.cellmajor import from_cm, to_cm
from sphexa_tpu_torch.propagator.ve_cellmajor import _add_gravity
from sphexa_tpu_torch.propagator.ve_tiered import (_build_layouts,
                                                   _GravityIndex,
                                                   _tier_engines,
                                                   _tier_sels,
                                                   _tiered_forces)
from sphexa_tpu_torch.sfc.box import Box, put_in_box
from sphexa_tpu_torch.sph import timestep as ts
from sphexa_tpu_torch.sph.eos import ideal_gas_cv
from sphexa_tpu_torch.sph.kernels import ts_k_courant, update_h
from sphexa_tpu_torch.sph.positions import position_update, temp_update
from sphexa_tpu_torch.state import Particles, SimState
from sphexa_tpu_torch.util.device import resolve_device
from sphexa_tpu_torch.util.fp import rdiv
from sphexa_tpu_torch.util.kahan import kahan_sum

_FROZEN = ("h", "xm", "kx", "gradh", "c0", "c1", "c2", "c3", "c4", "c5",
           "divv", "alpha", "ax", "ay", "az", "du", "maxvsignal")


@dataclasses.dataclass
class TBDTState:
    """Particle-frame BDT state: drifted fields, the per-particle kick
    state, the frozen dependent-field store and the rung bookkeeping."""
    p: Particles           # drifted x/y/z/vx/vy/vz/temp; h/alpha at kick
    xk: torch.Tensor       # kick state (committed at the last kick)
    yk: torch.Tensor
    zk: torch.Tensor
    tempk: torch.Tensor
    dxk: torch.Tensor      # Press-2 displacement history at the kick
    dyk: torch.Tensor
    dzk: torch.Tensor
    du_m1k: torch.Tensor
    dt_m1k: torch.Tensor   # per-particle previous kick interval
    rung: torch.Tensor
    ticks: torch.Tensor
    frozen: dict           # name -> [n] row (see _FROZEN)
    dt_min: torch.Tensor
    substep: torch.Tensor
    ttot: torch.Tensor
    iteration: torch.Tensor

    def replace(self, **kw) -> "TBDTState":
        return dataclasses.replace(self, **kw)


class TBDTDiag(NamedTuple):
    dt: torch.Tensor
    ttot: torch.Tensor
    etot: torch.Tensor
    ecin: torch.Tensor
    eint: torch.Tensor
    egrav: torch.Tensor
    active_frac: torch.Tensor
    rung_hist: torch.Tensor
    fold: torch.Tensor       # tier overflow/unowned/clamp/miss fail-stop
    fold_parts: torch.Tensor  # [overflow, band-unowned, miss, clamped]
    nf_truncated: torch.Tensor


class TieredBdtVE:
    """Tiered block-time-step engine. One cycle is 2**(num_rungs-1)
    substeps; run_cycle() advances a whole hierarchy. No method writes
    into a TBDTState it is given."""

    def __init__(self, box: Box, tiers, cfg: SphConfig, num_rungs: int = 4,
                 device=None):
        if cfg.av_clean:
            raise NotImplementedError("avClean + block time-steps is not "
                                      "supported (as in the JAX package)")
        self.device = resolve_device(device)
        self.box = box
        self.tiers = tiers
        self.cfg = cfg
        self.num_rungs = num_rungs
        self.engines = _tier_engines(tiers, cfg, self.device, gated=True)
        self.gindex = _GravityIndex()

    # ---- state management ------------------------------------------------
    def bind(self, state: SimState) -> TBDTState:
        p = state.p
        if p.device != self.device:
            raise ValueError(f"state on {p.device}, engine on {self.device}")
        if self.cfg.gravG != 0.0:
            self.gindex(p.alive)
        zero = torch.zeros_like(p.x)
        frozen = {k: zero for k in _FROZEN}
        frozen["h"] = p.h
        for k in ("xm", "kx", "gradh"):
            frozen[k] = torch.ones_like(p.x)
        frozen["alpha"] = p.alpha
        return TBDTState(
            p=p, xk=p.x, yk=p.y, zk=p.z, tempk=p.temp,
            dxk=p.x_m1, dyk=p.y_m1, dzk=p.z_m1,
            du_m1k=p.du_m1, dt_m1k=state.dt_m1.expand_as(p.x).clone(),
            rung=zero, ticks=zero, frozen=frozen,
            dt_min=state.dt.clone(),
            substep=torch.zeros((), dtype=torch.int32, device=self.device),
            ttot=state.ttot.clone(), iteration=state.iteration.clone())

    def unbind(self, bst: TBDTState) -> SimState:
        return SimState(p=bst.p, ttot=bst.ttot, dt=bst.dt_min,
                        dt_m1=bst.dt_min, iteration=bst.iteration)

    def _tier_cell_min(self, row_pf, ps, sels, layouts, big=1e30):
        """Min-reduce a particle row over each particle's owner-tier cell
        (rung harmonization at the adaptive grid's granularity)."""
        out = row_pf
        for ti, e in enumerate(self.engines):
            lay = layouts[ti]
            cap = e.spec.grid.cap
            v = torch.where(lay.valid & e.intmask, to_cm(lay, row_pf, big),
                            big)
            per_cell = v.reshape(-1, cap).amin(1)
            cm = per_cell[:, None].expand(-1, cap).reshape(-1)
            pf = from_cm(lay, cm, ps.n, big)
            out = torch.where(sels[ti], torch.minimum(pf, row_pf), out)
        return out

    # ---- one substep -----------------------------------------------------
    def substep(self, bst: TBDTState):
        cfg = self.cfg
        box = self.box
        ps = bst.p
        alive = ps.alive
        s = bst.substep

        cycle_start = s == 0
        active = alive & ((bst.ticks < 0.5) | cycle_start)
        act_pf = active.to(torch.float32)
        frozen = dict(bst.frozen)

        def freeze_refresh(d: dict) -> dict:
            """Inactive rows keep their kick values; the store takes the
            new rows as the stages land."""
            out = {}
            for k, v in d.items():
                if k in frozen:
                    v = torch.where(active, v, frozen[k])
                    frozen[k] = v
                out[k] = v
            return out

        layouts = _build_layouts(self.engines, box, ps)
        fo = _tiered_forces(ps, bst.dt_min, layouts, self.engines, box, cfg,
                            refresh=freeze_refresh, act_pf=act_pf)

        def pick(new, old):
            return torch.where(active, new, old)

        ax = pick(fo["ax"], frozen["ax"])
        ay = pick(fo["ay"], frozen["ay"])
        az = pick(fo["az"], frozen["az"])
        du = pick(fo["du"], frozen["du"])
        mvs = pick(fo["maxvsignal"], frozen["maxvsignal"])
        egrav = torch.zeros((), dtype=torch.float32, device=self.device)
        nf = torch.zeros((), dtype=torch.int32, device=self.device)
        if cfg.gravG != 0.0:
            # every substep on the drifted positions, committed with the
            # active kicks (ve_hydro_bdt.hpp:277-288)
            g, egrav, nf = _add_gravity(dict(ax=ax, ay=ay, az=az), ps.x,
                                        ps.y, ps.z, ps.m, self.gindex(alive),
                                        box, cfg)
            ax = pick(g["ax"], frozen["ax"])
            ay = pick(g["ay"], frozen["ay"])
            az = pick(g["az"], frozen["az"])
        frozen["ax"], frozen["ay"], frozen["az"] = ax, ay, az
        frozen["du"], frozen["maxvsignal"] = du, mvs

        # ---- rung (re)assignment at cycle start ----
        dt_i = ts_k_courant(mvs, fo["h"], fo["c"], cfg.kcour)
        if cfg.gravG != 0.0:
            acc = torch.sqrt(ax ** 2 + ay ** 2 + az ** 2)
            dt_i = torch.minimum(dt_i, cfg.eta_acc * torch.sqrt(
                rdiv(cfg.eps, torch.clamp_min(acc, 1e-30))))
        dt_i_min = torch.min(torch.where(alive, dt_i, 1e30))
        dt_rho = ts.rho_timestep(fo["divv"], alive, cfg.krho)
        dt_min_new = torch.minimum(torch.minimum(dt_i_min, dt_rho),
                                   cfg.max_dt_increase * bst.dt_min)
        rung_new = torch.clamp(torch.floor(torch.log2(torch.clamp_min(
            dt_i / torch.clamp_min(dt_i_min, 1e-30), 1.0))),
            0.0, float(self.num_rungs - 1))
        sels = _tier_sels(self.engines, ps, ps.h)
        rung_new = self._tier_cell_min(rung_new, ps, sels, layouts)
        rung = torch.where(cycle_start, rung_new, bst.rung)
        dt_min = torch.where(cycle_start, dt_min_new, bst.dt_min)
        ticks = torch.where(cycle_start, 0.0, bst.ticks)

        # ---- drift/kick from the kick state ----
        tau = (ticks + 1.0) * dt_min
        xn, yn, zn, vxn, vyn, vzn, dxn, dyn, dzn = position_update(
            tau, bst.dt_m1k, bst.xk, bst.yk, bst.zk, ax, ay, az,
            bst.dxk, bst.dyk, bst.dzk, box,
            h=fo["h"], vx=ps.vx, vy=ps.vy, vz=ps.vz, fold=False)
        temp_n = temp_update(bst.tempk, tau, bst.dt_m1k, du, bst.du_m1k,
                             cfg.mui, cfg.gamma)

        kick_done = (ticks + 1.0) >= (2.0 ** rung) - 0.5

        def pk(new, old):
            return torch.where(kick_done, new, old)

        # the h controller as in the plain tiered step: one update_h on
        # top of the kernel's h iteration for the active rows (fresh nc);
        # inactive rows keep the frozen kick h. A value past the tier
        # bound is clamp-counted at the next active kernel pass.
        h_new = torch.where(active, update_h(cfg.ng0, fo["nc_sph"], fo["h"]),
                            fo["h"])
        frozen["h"] = h_new

        xf, yf, zf = put_in_box(box, xn, yn, zn)
        p_new = ps.replace(x=xf, y=yf, z=zf, vx=vxn, vy=vyn, vz=vzn,
                           temp=temp_n, h=h_new, alpha=frozen["alpha"],
                           du_m1=torch.where(kick_done, du, ps.du_m1),
                           x_m1=dxn, y_m1=dyn, z_m1=dzn)
        last = (1 << (self.num_rungs - 1)) - 1
        new_bst = bst.replace(
            p=p_new,
            xk=pk(xf, bst.xk), yk=pk(yf, bst.yk), zk=pk(zf, bst.zk),
            dxk=pk(dxn, bst.dxk), dyk=pk(dyn, bst.dyk),
            dzk=pk(dzn, bst.dzk), tempk=pk(temp_n, bst.tempk),
            du_m1k=pk(du, bst.du_m1k), dt_m1k=pk(tau, bst.dt_m1k),
            ticks=torch.where(kick_done, 0.0, ticks + 1.0),
            rung=rung, dt_min=dt_min, frozen=frozen,
            substep=torch.where(s >= last, torch.zeros_like(s), s + 1),
            ttot=bst.ttot + dt_min, iteration=bst.iteration + 1)

        # ---- diagnostics ----
        cv = ideal_gas_cv(cfg.mui, cfg.gamma)
        ecin = 0.5 * kahan_sum(torch.where(
            alive, ps.m * (vxn ** 2 + vyn ** 2 + vzn ** 2), 0.0))
        eint = kahan_sum(torch.where(alive, ps.m * cv * temp_n, 0.0))
        nvalid = torch.clamp_min(torch.sum(alive), 1).to(torch.float32)
        rung_hist = torch.stack([
            torch.sum(alive & (torch.round(rung) == r))
            for r in range(self.num_rungs)]).to(torch.int32)
        diag = TBDTDiag(
            dt=dt_min, ttot=new_bst.ttot, etot=ecin + eint + egrav,
            ecin=ecin, eint=eint, egrav=egrav,
            active_frac=torch.sum(act_pf) / nvalid, rung_hist=rung_hist,
            fold=fo["fold"], fold_parts=fo["fold_parts"], nf_truncated=nf)
        return new_bst, diag

    def run_cycle(self, bst: TBDTState, check: bool = True):
        """One full rung hierarchy; substep 0 reassigns the rungs. With
        check=False the caller owns the fold fail-stop (the CLI routes it
        through the main loop's re-tier path instead of raising)."""
        diags = []
        for _ in range(1 << (self.num_rungs - 1)):
            bst, d = self.substep(bst)
            diags.append(d)
        if check:
            fold = max(int(d.fold) for d in diags)
            if fold != 0:
                raise RuntimeError(
                    f"tiered-BDT fold={fold} (overflow/unowned/clamp/miss) "
                    "— re-tier needed")
        return bst, diags
