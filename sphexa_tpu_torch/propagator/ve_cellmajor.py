"""VE propagator on the cell-major layout with the port's CUDA kernels.

Counterpart of sphexa_tpu/propagator/ve_pallas.py. Two entry points:

  - make_ve_step_cellmajor: particle-frame step, layout rebuilt per call
    (counterpart of make_ve_step_pallas).
  - ResidentVE: the state lives in the cell-major slot frame between
    steps; a drift margin triggers a layout rebin only when
    2*(h_max + accumulated drift) approaches the cell edge. The periodic
    fold is deferred to rebin time (ghost images carry the shifts).

Step choreography (ghost refreshes at the reference's exchangeHalos
points, ve_hydro.hpp:132-205): xmass+h-iter -> [xm, h] -> gradh ->
[kx, gradh] -> EOS -> IAD/divv -> [cij, divv, curlv (+ gradv under
av_clean)] -> AV -> [alpha] -> momentum+energy -> integrate ->
[positions, velocities, ...]. The pair bodies follow SphConfig's
mxu_moments / mxu_momentum / av_clean as PairVE selects them.

The rebin decision is a Python `if` on a device scalar: one host sync
per step (the JAX engine branches in-graph with lax.cond).

Self-gravity (gravG != 0) is coupled after the pair stages
(_add_gravity, ve_pallas.py:129 of the JAX package) with the solver
SphConfig.gravity_solver names: "direct", "fmm" (open cubic box) or
"ewald" (periodic cubic box). The solver sees the valid interior slots
only, compacted by an index built where their count is known (at bind
and at each rebin); its accelerations are scattered back and every
other slot gets 0 (the JAX package runs the solver over every slot and
leaves its invalid slots' values unread).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.gravity.direct import direct_gravity, egrav
from sphexa_tpu_torch.ops.cellmajor import (CMGrid, build_layout, from_cm,
                                            interior_mask, positions_cm, to_cm)
from sphexa_tpu_torch.ops.pair_ve import FILL_POS, PairVE, ghost_refresh
from sphexa_tpu_torch.propagator.common import finish_step
from sphexa_tpu_torch.sfc.box import Box, put_in_box
from sphexa_tpu_torch.sph import timestep as ts
from sphexa_tpu_torch.sph.eos import eos_ve, ideal_gas_cv
from sphexa_tpu_torch.sph.kernels import update_h
from sphexa_tpu_torch.sph.positions import position_update, temp_update
from sphexa_tpu_torch.state import Particles, SimState
from sphexa_tpu_torch.util.device import resolve_device
from sphexa_tpu_torch.util.kahan import kahan_sum


def _add_gravity(out, x, y, z, m, idx, box: Box, cfg: SphConfig):
    """Couple self-gravity into the force step (reference:
    ve_hydro.hpp:195-204) with the solver cfg.gravity_solver names
    ("fmm", "ewald", else the direct sum): it runs on the slots `idx`
    (the valid interior slots), and its accelerations are added there.
    Returns (out, egrav, nf_truncated)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.gravG == 0.0:
        return out, zero, zero.to(torch.int32)
    xs, ys, zs, ms = x[idx], y[idx], z[idx], m[idx]
    alive = torch.ones(idx.shape, dtype=torch.bool, device=x.device)
    nf = zero.to(torch.int32)   # dropped near-field pairs: the FMM's only
    if cfg.gravity_solver == "fmm":
        from sphexa_tpu_torch.gravity.fmm import FmmConfig, fmm_gravity
        gax, gay, gaz, pot, nf = fmm_gravity(
            xs, ys, zs, ms, alive, box, cfg.gravG,
            FmmConfig(level=cfg.fmm_level, min_sep=cfg.fmm_min_sep),
            eps=cfg.eps)
    elif cfg.gravity_solver == "ewald":
        from sphexa_tpu_torch.gravity.ewald import ewald_gravity
        gax, gay, gaz, pot = ewald_gravity(xs, ys, zs, ms, alive, box,
                                           cfg.gravG, eps=cfg.eps)
    else:
        gax, gay, gaz, pot = direct_gravity(xs, ys, zs, ms, alive,
                                            cfg.gravG, cfg.eps)

    def scatter(v):
        return torch.zeros_like(x).index_copy_(0, idx, v)

    out = dict(out, ax=out["ax"] + scatter(gax), ay=out["ay"] + scatter(gay),
               az=out["az"] + scatter(gaz))
    return out, egrav(ms, pot, alive), nf


class _Refreshers:
    """K1 ghost refresh bound to one (grid, box)."""

    def __init__(self, grid: CMGrid, box: Box):
        self._grid = grid
        self._box = box

    def __call__(self, stack, xyz_rows=None):
        return ghost_refresh(stack, self._grid, self._box, xyz_rows)


def _run_pipeline(pve: PairVE, refresh, base, m, vx, vy, vz, temp, alpha,
                  dt, validint):
    """The five pair stages with ghost refreshes between them. base[3]
    (h) is replaced by the xmass-stage adapted h. Returns a dict of cm
    frame results."""
    cfg = pve.cfg

    xm, h_new, nc, nonconv = pve.xmass_h(base, m)
    h_new = torch.where(validint, h_new, base[3])
    st = refresh(torch.stack([xm, h_new]))
    xm, h_new = st[0], st[1]
    base = [base[0], base[1], base[2], h_new, base[4]]
    nc_sph = nc + 1.0

    kx, gradh = pve.gradh(base, m, xm)
    st = refresh(torch.stack([kx, gradh]))
    kx, gradh = st[0], st[1]

    # EOS is elementwise on ghost-correct rows: no refresh needed.
    # Invalid slots must stream finite, divide-safe rho/c/prho.
    rho, p, c, prho = eos_ve(temp, m, kx, xm, gradh, cfg.mui, cfg.gamma)
    va = base[0] < 0.5 * FILL_POS
    rho = torch.where(va, rho, 1.0)
    c = torch.where(va, c, 1.0)
    prho = torch.where(va, prho, 0.0)

    cij, divv, curlv, gradv = pve.iad_divv(base, kx, xm, vx, vy, vz)
    if cfg.av_clean:
        # the momentum stage reads the j-side gradv rows too
        st = refresh(torch.stack(list(cij) + [divv, curlv] + list(gradv)))
        gradv = tuple(st[8 + i] for i in range(6))
    else:
        st = refresh(torch.stack(list(cij) + [divv, curlv]))
    cij = tuple(st[i] for i in range(6))
    divv, curlv = st[6], st[7]

    alpha_out = pve.av_switches(base, c, kx, xm, divv, vx, vy, vz, cij,
                                alpha, dt)
    alpha_new = torch.where(validint, alpha_out, alpha)
    alpha_new = refresh(alpha_new[None].contiguous())[0]

    mom_kw = {}
    if cfg.av_clean:
        mom_kw = dict(gradv=gradv, eta_crit_cm=eta_crit(nc_sph))
    ax, ay, az, du, mvs = pve.momentum(base, vx, vy, vz, c, prho, rho, xm,
                                       alpha_new, m, cij, **mom_kw)
    return dict(h=h_new, nc_sph=nc_sph, xm=xm, kx=kx, rho=rho, p=p, c=c,
                prho=prho, divv=divv, curlv=curlv, alpha=alpha_new,
                ax=ax, ay=ay, az=az, du=du, maxvsignal=mvs,
                h_nonconv=nonconv)


def eta_crit(nc_sph):
    """The avClean critical eta, cbrt(32 pi / 3 / max(nc_sph, 1))
    (ve_pallas.py:119)."""
    return torch.pow(32.0 * math.pi / 3.0 / torch.clamp_min(nc_sph, 1.0),
                     1.0 / 3.0)


def _masked(x, mask, fill=0.0):
    return torch.where(mask, x, torch.full((), fill, dtype=x.dtype,
                                           device=x.device))


# ---------------------------------------------------------------------------
# particle-frame step (layout rebuilt per call)
# ---------------------------------------------------------------------------

def make_ve_step_cellmajor(box: Box, grid: CMGrid, cfg: SphConfig,
                           device=None):
    """step(state) -> (state, StepDiagnostics), with the same contract
    as make_ve_step_pallas. Runs on `device` (default: the GPU); the
    state must live there."""
    device = resolve_device(device)
    pve = PairVE(grid, cfg)
    refresh = _Refreshers(grid, box)
    intmask = interior_mask(grid, device)

    def step(state: SimState):
        ps = state.p
        if ps.device != device:
            raise ValueError(f"state on {ps.device}, step built for {device}")
        n = ps.n
        layout = build_layout(grid, box, ps.x, ps.y, ps.z, alive=ps.alive)
        base = pve.base_rows(layout, ps.x, ps.y, ps.z, ps.h)
        validint = layout.valid & intmask

        def cm(f, fill=0.0):
            return to_cm(layout, f, fill)

        out = _run_pipeline(pve, refresh, base, cm(ps.m), cm(ps.vx),
                            cm(ps.vy), cm(ps.vz), cm(ps.temp), cm(ps.alpha),
                            state.dt, validint)
        out, eg, nf = _add_gravity(
            out, base[0], base[1], base[2], cm(ps.m),
            torch.nonzero(validint).reshape(-1) if cfg.gravG != 0.0 else None,
            box, cfg)

        def back(f, fill=0.0):
            return from_cm(layout, f, n, fill)

        ps = ps.replace(h=back(out["h"], 1.0),
                        alpha=back(out["alpha"], cfg.alphamin))
        max_nc = torch.max(_masked(out["nc_sph"] - 1.0, validint))
        return finish_step(
            state, ps, back(out["ax"]), back(out["ay"]), back(out["az"]),
            back(out["du"]), back(out["maxvsignal"]), back(out["c"], 1.0),
            back(out["divv"]), back(out["nc_sph"], 1.0), box, cfg,
            max_nc=max_nc.to(torch.int32),
            max_cell_count=layout.overflow.to(torch.int32),
            egrav=eg, nf_truncated=nf,
            rho=back(out["rho"], 1.0), p=back(out["p"]))

    return step


# ---------------------------------------------------------------------------
# resident engine
# ---------------------------------------------------------------------------

_RVROWS = ("x", "y", "z", "h", "m", "vx", "vy", "vz", "temp", "alpha",
           "du_m1", "x_m1", "y_m1", "z_m1")


@dataclasses.dataclass
class RVState:
    """Simulation state resident in the cell-major slot frame."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    temp: torch.Tensor
    alpha: torch.Tensor
    du_m1: torch.Tensor
    x_m1: torch.Tensor
    y_m1: torch.Tensor
    z_m1: torch.Tensor
    gid: torch.Tensor       # f32 original particle id; -1 on invalid slots
    valid: torch.Tensor     # bool slot occupancy (static between rebins)
    drift: torch.Tensor     # accumulated max displacement since rebin
    overflow: torch.Tensor  # sticky rebin slot-overflow count (must stay 0)
    ttot: torch.Tensor
    dt: torch.Tensor
    dt_m1: torch.Tensor
    iteration: torch.Tensor

    def replace(self, **kw) -> "RVState":
        return dataclasses.replace(self, **kw)


class ResidentDiag(NamedTuple):
    dt: torch.Tensor
    ttot: torch.Tensor
    etot: torch.Tensor
    ecin: torch.Tensor
    eint: torch.Tensor
    h_max: torch.Tensor
    nc_mean: torch.Tensor
    max_nc: torch.Tensor
    overflow: torch.Tensor
    maxvsignal: torch.Tensor
    drift: torch.Tensor
    rebinned: torch.Tensor
    need_regrid: torch.Tensor
    h_nonconv: torch.Tensor   # particles whose h controller hit h_iter
    nf_truncated: torch.Tensor
    n_hclamped: torch.Tensor  # particles riding the SphConfig.h_cap roof


class ResidentVE:
    """Cell-major-resident VE stepper.

    The layout rebin runs when the drift margin is exhausted:
    2*(h_max + drift) >= REBIN_FRAC * cell_edge keeps every true
    neighbour pair inside the 27-stencil of its (stale) binned cells.
    `step` returns a new RVState and never writes into its input."""

    REBIN_FRAC = 0.95

    def __init__(self, box: Box, grid: CMGrid, cfg: SphConfig, device=None):
        self.device = resolve_device(device)
        self.box = box
        self.grid = grid
        self.cfg = cfg
        self.pve = PairVE(grid, cfg)
        self.rf = _Refreshers(grid, box)
        self.intmask = interior_mask(grid, self.device)
        self.cell_edge = min(box.lx / grid.nx, box.ly / grid.n,
                             box.lz / grid.nz)
        self._gidx = (None, None)   # (valid row, its interior slot index)

    def _scalar(self, v, dtype=torch.float32):
        return torch.tensor(v, dtype=dtype, device=self.device)

    # ---- frame conversion ------------------------------------------------
    def _gather(self, layout, fields: dict, scalars: dict,
                gid_src) -> RVState:
        xs, ys, zs = positions_cm(layout, fields["x"], fields["y"],
                                  fields["z"])
        fillv = _masked(torch.zeros_like(xs), layout.valid, FILL_POS)
        rows = {"x": xs + fillv, "y": ys + fillv, "z": zs + fillv}
        rows["h"] = to_cm(layout, fields["h"], fill=1.0)
        for f in _RVROWS[4:]:
            rows[f] = to_cm(layout, fields[f])
        gid = to_cm(layout, gid_src, fill=-1.0)
        return RVState(gid=gid, valid=layout.valid, **rows, **scalars)

    def bind(self, state: SimState) -> RVState:
        ps = state.p
        if ps.device != self.device:
            raise ValueError(f"state on {ps.device}, engine on {self.device}")
        layout = build_layout(self.grid, self.box, ps.x, ps.y, ps.z,
                              alive=ps.alive)
        fields = {f: getattr(ps, f) for f in _RVROWS}
        gid_src = torch.arange(ps.n, dtype=torch.float32, device=self.device)
        # clones: the resident frame shares no buffer with the caller
        scalars = dict(drift=self._scalar(0.0),
                       overflow=layout.overflow.to(torch.int32),
                       ttot=state.ttot.clone(), dt=state.dt.clone(),
                       dt_m1=state.dt_m1.clone(),
                       iteration=state.iteration.clone())
        return self._indexed(self._gather(layout, fields, scalars, gid_src))

    def _rebin(self, rst: RVState):
        """(rebinned state, the layout it was gathered with)."""
        x, y, z = put_in_box(self.box, rst.x, rst.y, rst.z)
        alive = rst.valid & self.intmask
        layout = build_layout(self.grid, self.box, x, y, z, alive=alive)
        fields = {f: getattr(rst, f) for f in _RVROWS}
        fields.update(x=x, y=y, z=z)
        scalars = dict(
            drift=self._scalar(0.0),
            overflow=rst.overflow + layout.overflow.to(torch.int32),
            ttot=rst.ttot, dt=rst.dt, dt_m1=rst.dt_m1,
            iteration=rst.iteration)
        return (self._indexed(self._gather(layout, fields, scalars, rst.gid)),
                layout)

    def unbind(self, rst: RVState, n_capacity: int) -> SimState:
        validint = rst.valid & self.intmask
        idx = torch.where(validint, rst.gid.to(torch.int64),
                          torch.full_like(rst.gid, n_capacity,
                                          dtype=torch.int64))
        x, y, z = put_in_box(self.box, rst.x, rst.y, rst.z)
        pos = {"x": x, "y": y, "z": z}

        def back(row, fill=0.0):
            # one spare row takes the writes of invalid slots
            out = torch.full((n_capacity + 1,), fill, dtype=row.dtype,
                             device=row.device)
            out[idx] = _masked(row, validint, fill)
            return out[:n_capacity]

        fields = {f: back(pos.get(f, getattr(rst, f))) for f in _RVROWS}
        alive = torch.zeros(n_capacity + 1, dtype=torch.bool,
                            device=self.device)
        alive[idx] = validint
        ps = Particles(alive=alive[:n_capacity], **fields)
        return SimState(p=ps, ttot=rst.ttot.clone(), dt=rst.dt.clone(),
                        dt_m1=rst.dt_m1.clone(),
                        iteration=rst.iteration.clone())

    def gravity_index(self, valid):
        """Index of the valid interior slots of an occupancy row, built
        once per row (one host sync): bind and every rebin build it for
        the row they make, so a step or substep that follows finds it."""
        if self._gidx[0] is not valid:
            self._gidx = (valid,
                          torch.nonzero(valid & self.intmask).reshape(-1))
        return self._gidx[1]

    def _indexed(self, rst: RVState) -> RVState:
        if self.cfg.gravG != 0.0:
            self.gravity_index(rst.valid)
        return rst

    # ---- the step ----------------------------------------------------------
    def step(self, rst: RVState):
        cfg = self.cfg
        box = self.box
        validint = rst.valid & self.intmask

        h_max0 = torch.max(_masked(rst.h, validint))
        stale = 2.0 * (h_max0 + rst.drift) >= self.REBIN_FRAC * self.cell_edge
        rebinned = bool(stale)          # the one host sync of the step
        if rebinned:
            rst, _ = self._rebin(rst)
            validint = rst.valid & self.intmask

        base = [rst.x, rst.y, rst.z, rst.h, rst.gid]
        out = _run_pipeline(self.pve, self.rf, base, rst.m, rst.vx, rst.vy,
                            rst.vz, rst.temp, rst.alpha, rst.dt, validint)
        out, eg, nf = _add_gravity(
            out, rst.x, rst.y, rst.z, rst.m,
            self.gravity_index(rst.valid) if cfg.gravG != 0.0 else None,
            box, cfg)

        # ---- global timestep (ts_global.hpp:96-112) ----
        dt_courant = ts.courant_timestep(out["maxvsignal"], out["h"],
                                         out["c"], validint, cfg.kcour)
        candidates = [dt_courant,
                      ts.rho_timestep(out["divv"], validint, cfg.krho)]
        if cfg.gravG != 0.0:
            candidates.append(ts.acceleration_timestep(
                out["ax"], out["ay"], out["az"], validint, cfg.eta_acc,
                cfg.eps))
        dt = ts.combine_timesteps(rst.dt, candidates, cfg)
        dt_m1 = rst.dt

        # ---- integration, unfolded (fold happens at rebin) ----
        x, y, z, vx, vy, vz, dx, dy, dz = position_update(
            dt, dt_m1, rst.x, rst.y, rst.z, out["ax"], out["ay"], out["az"],
            rst.x_m1, rst.y_m1, rst.z_m1, box,
            h=out["h"], vx=rst.vx, vy=rst.vy, vz=rst.vz, fold=False)
        temp = temp_update(rst.temp, dt, dt_m1, out["du"], rst.du_m1,
                           cfg.mui, cfg.gamma)
        h = update_h(cfg.ng0, out["nc_sph"], out["h"], h_cap=cfg.h_cap)
        h = torch.where(validint, h, rst.h)

        disp2 = dx * dx + dy * dy + dz * dz
        step_disp = torch.sqrt(torch.max(_masked(disp2, validint)))
        drift = rst.drift + step_disp

        st = self.rf(torch.stack([x, y, z, h, vx, vy, vz, temp, out["du"],
                                  dx, dy, dz]), xyz_rows=(0, 1, 2))
        rst = rst.replace(
            x=st[0], y=st[1], z=st[2], h=st[3], vx=st[4], vy=st[5],
            vz=st[6], temp=st[7], du_m1=st[8], x_m1=st[9], y_m1=st[10],
            z_m1=st[11], alpha=out["alpha"], drift=drift,
            ttot=rst.ttot + dt, dt=dt, dt_m1=dt_m1,
            iteration=rst.iteration + 1)

        # ---- diagnostics ----
        cv = ideal_gas_cv(cfg.mui, cfg.gamma)
        ecin = 0.5 * kahan_sum(_masked(
            rst.m * (rst.vx ** 2 + rst.vy ** 2 + rst.vz ** 2), validint))
        eint = kahan_sum(_masked(rst.m * cv * rst.temp, validint))
        nvalid = torch.clamp_min(torch.sum(validint), 1)
        h_max = torch.max(_masked(rst.h, validint))
        i32 = torch.int32
        diag = ResidentDiag(
            dt=dt, ttot=rst.ttot, etot=ecin + eint + eg, ecin=ecin,
            eint=eint,
            h_max=h_max,
            nc_mean=(torch.sum(_masked(out["nc_sph"], validint))
                     / nvalid).to(torch.float32),
            max_nc=torch.max(_masked(out["nc_sph"] - 1.0, validint)).to(i32),
            overflow=rst.overflow,
            maxvsignal=torch.max(_masked(out["maxvsignal"], validint)),
            drift=drift, rebinned=stale,
            need_regrid=(2.0 * h_max * 1.05 >= self.cell_edge),
            h_nonconv=torch.sum(_masked(out["h_nonconv"], validint)).to(i32),
            nf_truncated=nf,
            n_hclamped=(torch.sum(validint & (rst.h >= 0.999 * cfg.h_cap))
                        .to(i32) if cfg.h_cap > 0.0 else self._scalar(0, i32)))
        return rst, diag

    def steps(self, rst: RVState, k: int):
        """Run k steps. Returns (state, ResidentDiag of stacked [k]
        tensors)."""
        diags = []
        for _ in range(k):
            rst, d = self.step(rst)
            diags.append(d)
        return rst, ResidentDiag(*(torch.stack(list(v))
                                   for v in zip(*diags)))
