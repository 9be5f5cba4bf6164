"""Multi-tier cell-major VE step for clustered density contrast.

Counterpart of sphexa_tpu/propagator/ve_tiered.py (the reference's
adaptive-resolution role: cstone focused octree,
focus/octree_focus_mpi.hpp:51). A uniform cell-major grid needs cell
edge >= 2 h_max, so a density contrast C packs ~C cells of particles
into one slot cap. Instead, particles are split into h-TIERS:

  - tier t owns the particles with h in [h_lo_t, h_hi_t); its grid has
    cell edge >= 2 h_hi_t SLACK, so the 27-stencil pair kernels
    (ops/pair_ve.py, K3-K7) are exact for its particles;
  - each tier's grid spans only the SUBBOX around its own particles
    (bbox + margin, open on every face it does not span), so fine tiers
    zoom onto the dense core;
  - tier t's FRAME holds every subbox particle with h >= h_lo_t / theta:
    coarser particles always, finer ones only within the theta band.
    `audit_tiers` checks exactly, on the host, that no excluded particle
    lies inside an in-tier particle's 2h support;
  - every tier runs the same five pair stages; after each stage the
    outputs merge into the particle frame by owner, and the next stage
    reads the merged rows through each tier's layout.

The host planner (TierSpec, choose_tiers, choose_tiers_auto,
choose_tiers_robust, audit_tiers) is numpy and gives the JAX package's
tiers for identical inputs: its periodic roll is a float32 roll, as the
JAX planner computes it on jnp arrays. The top tier's cap budget is 384
(the JAX planner's default for SPHEXA_CAP_MAX_TOP, a knob of the TPU's
compile helper that the port drops). The band audit runs in C
(util/native.py); its numpy form, _band_audit_plain, is the plain
version.

Engines: make_ve_step_tiered (layouts rebuilt every step, the JAX
make_ve_step_pallas_tiered) and make_ve_step_tiered_resident (layouts
carried and rebuilt only when stale, one host `if` a step). Self-gravity
runs once a step on the particle frame after the SPH forces, on the
alive rows compacted by an index built on the first call (the alive set
does not change within a run).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.ops.cellmajor import (CMGrid, attach_static,
                                            build_layout,
                                            choose_cap_and_grid, from_cm,
                                            interior_mask, to_cm)
from sphexa_tpu_torch.ops.pair_ve import PairVE
from sphexa_tpu_torch.propagator.common import finish_step
from sphexa_tpu_torch.propagator.ve_cellmajor import _add_gravity, eta_crit
from sphexa_tpu_torch.sfc.box import Boundary, Box
from sphexa_tpu_torch.sph.eos import eos_ve
from sphexa_tpu_torch.util import native
from sphexa_tpu_torch.util.device import resolve_device

SLACK = 1.05
# the top tier's cap budget (the JAX planner's default cap_max_top)
CAP_MAX_TOP = 384
REBIN_FRAC = 0.95


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One h-tier: particles with h in [h_lo, h_hi) run on `grid` over
    `sub` (a zoom Box, open in every dim it does not fully span); the
    frame holds subbox particles with h >= cutoff (= h_lo / theta).
    `shift` is the periodic roll applied to coordinates before binning,
    one value per dim, the same for every tier of a set."""
    h_lo: float
    h_hi: float
    cutoff: float
    grid: CMGrid
    sub: Box
    shift: tuple = (0.0, 0.0, 0.0)


def _roll_host(v, lo, ln, s):
    """The JAX planner's roll: jnp.mod(v - lo - s, ln) + lo on float32
    (jnp arrays of float64 numpy without x64), as numpy float32."""
    f = np.float32
    a = (v - f(lo)) - f(s)
    r = np.fmod(a, f(ln))
    r = np.where((r != 0) & ((r < 0) != (f(ln) < 0)), r + f(ln), r)
    return r + f(lo)


def _roll_torch(v, lo, ln, s):
    """The same roll in-graph: a float32 row of the particle frame."""
    r = torch.fmod(v - lo - s, ln)
    r = torch.where((r != 0) & ((r < 0) != (ln < 0)), r + ln, r)
    return r + lo


def tier_coords(box: Box, shift, x, y, z):
    """Coordinates in the tier set's rolled frame: x' = ((x - xmin - sx)
    mod lx) + xmin for shifted periodic dims, identity otherwise.
    Tensors roll on their device. Anything else rolls as host float32,
    and then all three dims come back as float32, as the JAX planner's
    round trip through jnp arrays gives them."""
    roll = _roll_torch
    if not isinstance(x, torch.Tensor):
        if all(s == 0.0 for s in shift):
            return x, y, z
        x, y, z = (np.asarray(v, np.float32) for v in (x, y, z))
        roll = _roll_host

    def one(v, lo, ln, s):
        return v if s == 0.0 else roll(v, lo, ln, s)
    return (one(x, box.xmin, box.lx, shift[0]),
            one(y, box.ymin, box.ly, shift[1]),
            one(z, box.zmin, box.lz, shift[2]))


def choose_shift(box: Box, x, y, z, nbins: int = 64):
    """Per-dim periodic roll placing the cut at the emptiest histogram
    bin's left edge (host-side). Open dims get shift 0."""
    out = []
    for coords, per, lo, ln in ((x, box.periodic[0], box.xmin, box.lx),
                                (y, box.periodic[1], box.ymin, box.ly),
                                (z, box.periodic[2], box.zmin, box.lz)):
        if not per:
            out.append(0.0)
            continue
        histo, edges = np.histogram(np.asarray(coords),
                                    bins=nbins, range=(lo, lo + ln))
        out.append(float(edges[int(np.argmin(histo))] - lo))
    return tuple(out)


def tier_edge(tier: TierSpec) -> float:
    """The smallest cell edge of the tier grid over its subbox."""
    g, b = tier.grid, tier.sub
    return min(b.lx / g.nx, b.ly / g.n, b.lz / g.nz)


def tier_support_bound(tier: TierSpec) -> float:
    """Largest h the tier grid's 27-stencil can serve (edge/2/slack)."""
    return tier_edge(tier) / (2.0 * SLACK)


def _subbox(box: Box, xs, ys, zs, margin: float) -> Box:
    """Cubified bbox + margin, clipped to the global box. A dim the
    clipped cube fully spans keeps the global box's boundary condition;
    partially spanned dims are open (coordinates enter in the rolled
    frame, where the cluster is contiguous)."""
    lo = np.array([xs.min() - margin, ys.min() - margin, zs.min() - margin])
    hi = np.array([xs.max() + margin, ys.max() + margin, zs.max() + margin])
    c = 0.5 * (lo + hi)
    half = 0.5 * float((hi - lo).max())
    lo, hi = c - half, c + half
    glo = np.array([box.xmin, box.ymin, box.zmin])
    ghi = np.array([box.xmax, box.ymax, box.zmax])
    full = (lo <= glo) & (hi >= ghi)
    lo, hi = np.maximum(lo, glo), np.minimum(hi, ghi)
    bcs = [b if (f and b == Boundary.periodic) else Boundary.open
           for f, b in zip(full, (box.bx, box.by, box.bz))]
    return Box(lo[0], hi[0], lo[1], hi[1], lo[2], hi[2],
               bx=bcs[0], by=bcs[1], bz=bcs[2])


def choose_tiers(box: Box, x, y, z, h, alive=None, cap_max: int = 128,
                 theta: float = 1.5, max_tiers: int = 4,
                 n_candidates: int = 16, grid_slack: float = 1.1,
                 top_headroom: float = 1.6, cap_max_top: int = CAP_MAX_TOP,
                 headroom: int = 8, fits: dict | None = None):
    """Greedy top-down tiers from the realized h distribution (JAX
    ve_tiered.py:132): the coarsest tier takes h_hi = h_max and
    stretches h_lo as deep as the cap budget allows; the rest recurses
    on its own subbox. Returns list[TierSpec], coarsest first. grid_slack
    sizes each grid for h_hi * grid_slack (h-growth headroom);
    top_headroom oversizes the top tier's cells further, under its own
    cap budget cap_max_top, falling back to no top headroom where that
    does not fit. The theta band must pass `audit_tiers` before use.
    `fits` memoizes the tier fits across calls on the same x, y, z, h
    (choose_tiers_auto's ladder repeats many of them)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    z = np.asarray(z, np.float64)
    h = np.asarray(h, np.float64)
    if alive is not None:
        keep = np.asarray(alive)
        x, y, z, h = x[keep], y[keep], z[keep], h[keep]
    h_min, h_max = float(h.min()), float(h.max())

    shift = choose_shift(box, x, y, z)
    if any(s != 0.0 for s in shift):
        x, y, z = tier_coords(box, shift, x, y, z)
    # in h order, a band and a frame's cutoff are index ranges (nothing
    # below depends on the order of the particles)
    order = np.argsort(h, kind="stable")
    x, y, z, h = x[order], y[order], z[order], h[order]

    def fit(h_hi: float, h_lo: float, top: bool = False):
        """(grid, sub) for tier [h_lo, h_hi), or None past the cap
        budget."""
        h_eff = h_hi * grid_slack * (top_headroom if top else 1.0)
        limit = cap_max_top if top else cap_max
        key = (h_hi, h_lo, h_eff, h_lo / theta, limit, headroom)
        if fits is not None and key in fits:
            return fits[key]
        r = _fit(h_hi, h_lo, h_eff, h_lo / theta, limit)
        if fits is not None:
            fits[key] = r
        return r

    def _fit(h_hi, h_lo, h_eff, cutoff, limit):
        i0, i1, ic = np.searchsorted(h, [h_lo, h_hi, cutoff])
        if i1 <= i0:
            return None
        sel = slice(i0, i1)
        sub = _subbox(box, x[sel], y[sel], z[sel],
                      margin=2.0 * 2.0 * h_eff * SLACK)
        xc, yc, zc = x[ic:], y[ic:], z[ic:]
        frame = ((xc >= sub.xmin) & (xc <= sub.xmax) & (yc >= sub.ymin)
                 & (yc <= sub.ymax) & (zc >= sub.zmin) & (zc <= sub.zmax))
        try:
            # headroom: slots past the realized max count, for a few
            # steps of drift between host re-tierings
            cap, grid = choose_cap_and_grid(
                sub, h_eff, int(frame.sum()),
                xc[frame], yc[frame], zc[frame], cap_min=32, cap_max=limit,
                headroom=headroom)
        except ValueError:
            return None
        return grid, sub

    tiers = []
    h_hi = h_max * 1.0001
    while len(tiers) < max_tiers:
        cands = np.geomspace(max(h_min * 0.999, 1e-12), h_hi, n_candidates)
        top = not tiers
        best = None
        for use_top in ((True, False) if top else (False,)):
            for h_lo in cands:                  # prefer the deepest feasible
                r = fit(h_hi, float(h_lo), top=use_top)
                if r is not None:
                    best = (float(h_lo), r)
                    break
            if best is not None:
                top = use_top
                break
        if best is None:
            raise ValueError(
                f"no tier with cap <= {cap_max} fits below h_hi={h_hi:.4g} "
                f"(raise cap_max or theta)")
        h_lo, (grid, sub) = best
        if h_lo > 0.9 * h_hi and len(tiers) > 0:
            raise ValueError(
                f"tiering stalls at h_hi={h_hi:.4g} (feasible band too "
                f"thin; raise cap_max or theta)")
        if h_lo <= h_min * 1.001 or len(tiers) == max_tiers - 1:
            h_lo = 0.0
        if h_lo == 0.0 and (r := fit(h_hi, 0.0, top=top)) is None:
            raise ValueError(
                f"final tier [0, {h_hi:.4g}) exceeds cap {cap_max} "
                f"(needs more than {max_tiers} tiers)")
        elif h_lo == 0.0:
            grid, sub = r
        tiers.append(TierSpec(h_lo=h_lo, h_hi=h_hi,
                              cutoff=(h_lo / theta if h_lo > 0 else 0.0),
                              grid=grid, sub=sub, shift=shift))
        if h_lo == 0.0:
            return tiers
        h_hi = h_lo
    raise ValueError(f"more than {max_tiers} tiers needed")


# (grid_slack, theta, top_headroom) rungs of choose_tiers_auto, in order
# (JAX ve_tiered.py:291-301): growth headroom first, then fringe width,
# the tight rungs without top headroom last
_RUNGS = [(gs, th, 1.6) for gs, th in
          ((1.1, 1.5), (1.1, 1.35), (1.075, 1.35), (1.05, 1.3),
           (1.05, 1.2), (1.025, 1.2), (1.0, 1.5), (1.0, 1.3))]
_RUNGS = [(1.1, 1.35, 2.2), (1.05, 1.3, 2.2), (1.05, 1.2, 2.8)] + _RUNGS
_RUNGS += [(gs, th, 1.0) for gs, th, _hr in _RUNGS[3:]]


def choose_tiers_auto(box: Box, x, y, z, h, alive=None,
                      cap_max: int = 128, max_tiers: int = 4,
                      verbose: bool = False,
                      cap_max_top: int = CAP_MAX_TOP, headroom: int = 8):
    """choose_tiers over the (grid_slack, theta, top_headroom) ladder;
    the first rung whose tiers pass the exact band audit wins."""
    last = None
    fits = {}
    for gs, th, hr in _RUNGS:
        try:
            tiers = choose_tiers(box, x, y, z, h, alive=alive,
                                 cap_max=cap_max, theta=th,
                                 max_tiers=max_tiers, grid_slack=gs,
                                 top_headroom=hr, cap_max_top=cap_max_top,
                                 headroom=headroom, fits=fits)
        except ValueError as e:
            last = e
            continue
        if audit_tiers(tiers, box, x, y, z, h, alive=alive) == 0:
            if verbose:
                print(f"# tiers: slack={gs} theta={th} top_headroom={hr} "
                      f"{[(t.grid.n, t.grid.cap) for t in tiers]}")
            return tiers
        last = ValueError(f"band audit violations at slack={gs} "
                          f"theta={th}")
    raise ValueError(f"no feasible (slack, theta) tier ladder rung: {last}")


def choose_tiers_robust(box: Box, x, y, z, h, alive=None,
                        cap_max: int = 128, max_tiers: int = 4,
                        verbose: bool = False,
                        cap_max_top: int = CAP_MAX_TOP,
                        clip_quantiles=(1.0, 0.995, 0.98, 0.95),
                        headroom: int = 8):
    """choose_tiers_auto that never raises. Returns (tiers, h_clip):
    where no rung fits the raw h, the top h tail is clipped at lower
    quantiles and the ladder retried (the caller must then clamp h at
    h_clip and set SphConfig.h_cap); (None, None) when even the clipped
    ladders fail."""
    hv = np.asarray(h, np.float64)
    av = None if alive is None else np.asarray(alive)
    ha = hv if av is None else hv[av]
    for q in clip_quantiles:
        clip = float(np.quantile(ha, q)) if q < 1.0 else None
        hq = hv if clip is None else np.minimum(hv, clip)
        try:
            tiers = choose_tiers_auto(box, x, y, z, hq, alive=alive,
                                      cap_max=cap_max, max_tiers=max_tiers,
                                      verbose=verbose,
                                      cap_max_top=cap_max_top,
                                      headroom=headroom)
        except ValueError:
            continue
        if clip is not None and verbose:
            print(f"# tier ladder feasible after h-clip at q={q} "
                  f"({clip:.4g}; {(ha > clip).mean():.2%} clamped)")
        return tiers, clip
    return None, None


def _audit_grid(box: Box, hi):
    """(nx, ny, nz) of the audit's buckets over the global box: cell
    edge 2 max(h_i) SLACK."""
    edge = 2.0 * float(hi.max()) * SLACK
    return (max(1, int(box.lx / edge)), max(1, int(box.ly / edge)),
            max(1, int(box.lz / edge)))


def _band_audit_plain(xi, yi, zi, hi, xj, yj, zj, box: Box, nx: int,
                      ny: int, nz: int, chunk: int = 8192) -> int:
    """Numpy form of native.band_audit: excluded j's inside the 2 h_i
    support of an in-tier i, by a bucket scan of the 27 neighbour
    cells (the JAX audit_tiers' fallback, ve_tiered.py:418-472)."""
    per = np.array(box.periodic, bool)
    L = np.array([box.lx, box.ly, box.lz])

    def cellid(px, py, pz):
        ix = np.clip(((px - box.xmin) / box.lx * nx).astype(int), 0, nx - 1)
        iy = np.clip(((py - box.ymin) / box.ly * ny).astype(int), 0, ny - 1)
        iz = np.clip(((pz - box.zmin) / box.lz * nz).astype(int), 0, nz - 1)
        return ix, iy, iz

    cxi, cyi, czi = cellid(xi, yi, zi)
    cid_i = (cxi * ny + cyi) * nz + czi
    order = np.argsort(cid_i, kind="stable")
    cid_s = cid_i[order]
    starts = np.searchsorted(cid_s, np.arange(nx * ny * nz + 1))
    xs, ys, zs, hs = xi[order], yi[order], zi[order], hi[order]
    cap = int(np.max(starts[1:] - starts[:-1])) if len(cid_s) else 0

    violations = 0
    for lo in range(0, len(xj), chunk):
        sl = slice(lo, lo + chunk)
        cxj, cyj, czj = cellid(xj[sl], yj[sl], zj[sl])
        hit = np.zeros(cxj.shape, bool)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    qx, qy, qz = cxj + dx, cyj + dy, czj + dz
                    if per[0]:
                        qx %= nx
                    if per[1]:
                        qy %= ny
                    if per[2]:
                        qz %= nz
                    ok = ((qx >= 0) & (qx < nx) & (qy >= 0) & (qy < ny)
                          & (qz >= 0) & (qz < nz))
                    qc = np.where(ok, (qx * ny + qy) * nz + qz, 0)
                    s0 = starts[qc]
                    cnt = starts[qc + 1] - s0
                    for k in range(cap):
                        take = ok & (k < cnt)
                        if not take.any():
                            continue
                        idx = np.where(take, s0 + np.minimum(k, cnt - 1), 0)
                        ddx = xj[sl] - xs[idx]
                        ddy = yj[sl] - ys[idx]
                        ddz = zj[sl] - zs[idx]
                        if per[0]:
                            ddx -= np.round(ddx / L[0]) * L[0]
                        if per[1]:
                            ddy -= np.round(ddy / L[1]) * L[1]
                        if per[2]:
                            ddz -= np.round(ddz / L[2]) * L[2]
                        d2 = ddx * ddx + ddy * ddy + ddz * ddz
                        hit |= take & (d2 < (2.0 * hs[idx]) ** 2)
        violations += int(hit.sum())
    return violations


def _audit_sets(tiers, box: Box, x, y, z, h, alive=None):
    """Per tier with both: the arguments of native.band_audit (and of
    _band_audit_plain) for its in-tier i and its excluded j."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    z = np.asarray(z, np.float64)
    h = np.asarray(h, np.float64)
    if alive is not None:
        keep = np.asarray(alive)
        x, y, z, h = x[keep], y[keep], z[keep], h[keep]
    for t in tiers:
        sel_i = (h >= t.h_lo) & (h < t.h_hi)
        sub = t.sub
        # subbox membership in the set's rolled frame; distances stay
        # min-image in the global box (shift-invariant)
        xr, yr, zr = tier_coords(box, t.shift, x, y, z)
        inbox = ((xr >= sub.xmin) & (xr <= sub.xmax) & (yr >= sub.ymin)
                 & (yr <= sub.ymax) & (zr >= sub.zmin) & (zr <= sub.zmax))
        excl = ~inbox | (h < t.cutoff)
        if not excl.any() or not sel_i.any():
            continue
        hi = h[sel_i]
        yield (x[sel_i], y[sel_i], z[sel_i], hi, x[excl], y[excl], z[excl],
               box, *_audit_grid(box, hi))


def audit_tiers(tiers, box: Box, x, y, z, h, alive=None) -> int:
    """Exact host-side frame-completeness audit: the (excluded j,
    in-tier i) pairs with d(i, j) < 2 h_i, counted once per j and tier:
    particles a tier frame dropped (theta band or outside the subbox)
    that the physics needs. Zero means every tier frame is complete. The
    scan runs in C (native.band_audit; its numpy form is
    _band_audit_plain)."""
    return sum(native.band_audit(*a)
               for a in _audit_sets(tiers, box, x, y, z, h, alive))


# ---------------------------------------------------------------------------
# the tiered force stages
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Tier:
    """A tier with its PairVE, interior mask and h support bound."""
    spec: TierSpec
    pve: PairVE
    intmask: torch.Tensor
    h_bound: float


def _tier_engines(tiers, cfg: SphConfig, device, gated: bool = False):
    return [_Tier(t, PairVE(t.grid, cfg, gated=gated),
                  interior_mask(t.grid, device), tier_support_bound(t))
            for t in tiers]


def _tier_sels(engines, ps, h0):
    """Owner masks: tier t owns alive particles with h in [h_lo, h_hi);
    the coarsest tier owns everything above its h_lo (h may grow past
    the planning h_max; the support-bound clamp caps what it serves)."""
    sels = []
    for ti, e in enumerate(engines):
        sel = ps.alive & (h0 >= e.spec.h_lo)
        if ti > 0:
            sel = sel & (h0 < e.spec.h_hi)
        sels.append(sel)
    return sels


def _tier_frame_coords(engines, box: Box, ps):
    """The set's rolled-frame coordinates (one shift for all tiers)."""
    return tier_coords(box, engines[0].spec.shift, ps.x, ps.y, ps.z)


def _build_layouts(engines, box: Box, ps):
    """Each tier's frame layout from the current positions and h."""
    xr, yr, zr = _tier_frame_coords(engines, box, ps)
    layouts = []
    for e in engines:
        sub = e.spec.sub
        inbox = ((xr >= sub.xmin) & (xr <= sub.xmax)
                 & (yr >= sub.ymin) & (yr <= sub.ymax)
                 & (zr >= sub.zmin) & (zr <= sub.zmax))
        frame = ps.alive & inbox & (ps.h >= e.spec.cutoff)
        layouts.append(build_layout(e.spec.grid, sub, xr, yr, zr,
                                    alive=frame))
    return layouts


def _tiered_forces(ps, dt_prev, layouts, engines, box: Box, cfg: SphConfig,
                   refresh=None, owned=None, act_pf=None):
    """The five tiered pair stages on the particle frame `ps` (JAX
    ve_tiered.py:631). After every stage the tiers' outputs merge into
    the particle frame by owner mask; the next stage materializes its
    rows from the merged frame (to_cm pulls ghosts through layout.src,
    so no ghost refresh runs on this path).

    refresh(dict) -> dict runs at each merge point (identity when None;
    the block-time-step engine overwrites inactive rows there from its
    frozen store; the sharded tiered step re-sends the halo rows from
    their owners). `owned` marks the rows whose outputs this frame owns
    (a shard's extended frame: its own rows, not its halo rows); only
    they count toward the unowned, miss and clamp accounting. None means
    ps.alive. With act_pf (block time-steps) the gated engines
    compute only supercells holding an active particle, and only
    active rows count toward the h clamps.

    Returns a dict of particle-frame outputs with `fold` (slot overflow
    + unowned + owner-frame misses + the h clamps past the budget
    cfg.clamp_frac_budget of the owned rows: nonzero means re-tier) and
    `fold_parts` [overflow, band-unowned, miss, clamped]."""
    n = ps.n
    h0 = ps.h
    if refresh is None:
        def refresh(d):
            return d
    if owned is None:
        owned = ps.alive

    sels = _tier_sels(engines, ps, h0)
    xr, yr, zr = _tier_frame_coords(engines, box, ps)
    bases, valids, gates = [], [], []
    sel_sum = torch.zeros_like(owned)
    zero_i = torch.zeros((), dtype=torch.int64, device=h0.device)
    overflow, miss = zero_i, zero_i
    for ti, e in enumerate(engines):
        layout = layouts[ti]
        bases.append(e.pve.base_rows(layout, xr, yr, zr, ps.h))
        valids.append(layout.valid & e.intmask)
        if e.pve.gated:
            # without act_pf every occupied supercell computes; with it
            # only those holding an active particle
            if act_pf is None:
                act = valids[ti].to(torch.float32)
            else:
                act = torch.where(valids[ti], to_cm(layout, act_pf), 0.0)
            gates.append((act, (torch.zeros_like(act),)))
        else:
            gates.append(None)
        sel_sum = sel_sum | sels[ti]
        overflow = overflow + layout.overflow
        miss = miss + torch.sum(owned & sels[ti]
                                & (layout.slot_of >= e.spec.grid.n_slots))
    unowned = torch.sum(owned & ~sel_sum) + miss

    def run_stage(fn):
        """fn(ti, pve, base, cm, gate) -> {name: (cm row, fill)}; returns
        the owner-merged particle-frame rows."""
        merged = None
        for ti, e in enumerate(engines):
            lay = layouts[ti]

            def cm(f, fill=0.0, lay=lay):
                return to_cm(lay, f, fill)
            out = fn(ti, e.pve, bases[ti], cm, gates[ti])
            pf = {k: from_cm(lay, v, n, fill) for k, (v, fill) in out.items()}
            if merged is None:
                merged = pf
            else:
                merged = {k: torch.where(sels[ti], pf[k], merged[k])
                          for k in pf}
        return merged

    # ---- stage 1: fused nc / h-iteration / xmass ----
    def s_xmass(ti, pve, base, cm, gate):
        xm, h_new, nc, nonconv = pve.xmass_h(base, cm(ps.m), gate=gate)
        h_new = torch.where(valids[ti], h_new, base[3])
        return dict(xm=(xm, 1.0), h=(h_new, 1.0), nc=(nc, 0.0),
                    nonconv=(nonconv, 0.0))

    st1 = run_stage(s_xmass)
    nc_pf, nonconv_pf = st1["nc"], st1["nonconv"]
    # owner clamp at the tier grid's support bound (counted; re-tier at
    # the host boundary). Under block time-steps only active rows count:
    # an inactive row sharing a supercell with an active one gets an
    # uncommitted h here, which the freeze refresh discards.
    h_pf = st1["h"]
    committed = owned if act_pf is None else owned & (act_pf > 0.5)
    clamped = zero_i
    for ti, e in enumerate(engines):
        clamped = clamped + torch.sum(committed & sels[ti]
                                      & (h_pf > e.h_bound))
        h_pf = torch.where(sels[ti], torch.clamp_max(h_pf, e.h_bound), h_pf)
    h_pf = torch.where(ps.alive, h_pf, h0)
    r1 = refresh(dict(h=h_pf, xm=st1["xm"]))
    h_pf, xm_pf = r1["h"], r1["xm"]
    # the j-side h is the owner-adapted value in every frame
    for ti in range(len(engines)):
        b = bases[ti]
        bases[ti] = [b[0], b[1], b[2], to_cm(layouts[ti], h_pf, fill=1.0),
                     b[4]]
    nc_sph_pf = nc_pf + 1.0

    # ---- stage 2: VE normalization kx + grad-h ----
    def s_gradh(ti, pve, base, cm, gate):
        kx, gradh = pve.gradh(base, cm(ps.m), cm(xm_pf), gate=gate)
        return dict(kx=(kx, 1.0), gradh=(gradh, 1.0))

    st2 = run_stage(s_gradh)
    # refreshed before the EOS, which then follows the current temp
    r2a = refresh(dict(kx=st2["kx"], gradh=st2["gradh"]))
    kx_pf, gradh_pf = r2a["kx"], r2a["gradh"]

    # ---- EOS: elementwise on the particle frame ----
    rho_pf, p_pf, c_pf, prho_pf = eos_ve(ps.temp, ps.m, kx_pf, xm_pf,
                                         gradh_pf, cfg.mui, cfg.gamma)
    rho_pf = torch.where(ps.alive, rho_pf, 1.0)
    c_pf = torch.where(ps.alive, c_pf, 1.0)
    prho_pf = torch.where(ps.alive, prho_pf, 0.0)
    r2 = refresh(dict(prho=prho_pf, c=c_pf, rho=rho_pf))
    prho_pf, c_pf, rho_pf = r2["prho"], r2["c"], r2["rho"]

    # ---- stage 3: IAD + divv/curlv ----
    def s_iad(ti, pve, base, cm, gate):
        cij, divv, curlv, gradv = pve.iad_divv(
            base, cm(kx_pf, 1.0), cm(xm_pf, 1.0), cm(ps.vx), cm(ps.vy),
            cm(ps.vz), gate=gate)
        out = {f"c{k}": (cij[k], 0.0) for k in range(6)}
        out.update(divv=(divv, 0.0), curlv=(curlv, 0.0))
        out.update({f"g{k}": (gradv[k], 0.0) for k in range(6)})
        return out

    st3 = run_stage(s_iad)
    r3 = refresh({f"c{k}": st3[f"c{k}"] for k in range(6)}
                 | dict(divv=st3["divv"]))
    cij_pf = tuple(r3[f"c{k}"] for k in range(6))
    divv_pf, curlv_pf = r3["divv"], st3["curlv"]
    gradv_pf = tuple(st3[f"g{k}"] for k in range(6))

    # ---- stage 4: AV switches ----
    def s_av(ti, pve, base, cm, gate):
        alpha = pve.av_switches(
            base, cm(c_pf, 1.0), cm(kx_pf, 1.0), cm(xm_pf, 1.0),
            cm(divv_pf), cm(ps.vx), cm(ps.vy), cm(ps.vz),
            tuple(cm(c6) for c6 in cij_pf), cm(ps.alpha), dt_prev,
            gate=gate)
        alpha = torch.where(valids[ti], alpha, to_cm(layouts[ti], ps.alpha))
        return dict(alpha=(alpha, 0.0))

    alpha_pf = run_stage(s_av)["alpha"]
    alpha_pf = torch.where(ps.alive, alpha_pf, ps.alpha)
    alpha_pf = refresh(dict(alpha=alpha_pf))["alpha"]

    # ---- stage 5: momentum + energy ----
    def s_mom(ti, pve, base, cm, gate):
        kw = {}
        if cfg.av_clean:
            kw = dict(gradv=tuple(cm(g) for g in gradv_pf),
                      eta_crit_cm=eta_crit(cm(nc_sph_pf, 1.0)))
        ax, ay, az, du, mvs = pve.momentum(
            base, cm(ps.vx), cm(ps.vy), cm(ps.vz), cm(c_pf, 1.0),
            cm(prho_pf), cm(rho_pf, 1.0), cm(xm_pf, 1.0), cm(alpha_pf),
            cm(ps.m), tuple(cm(c6) for c6 in cij_pf), gate=gate, **kw)
        return dict(ax=(ax, 0.0), ay=(ay, 0.0), az=(az, 0.0), du=(du, 0.0),
                    mvs=(mvs, 0.0))

    st5 = run_stage(s_mom)

    # budgeted clamps: a population riding a tier's support bound within
    # clamp_frac_budget of the owned rows is the h_cap semantics (its
    # candidate sets stay complete); only past the budget does it fold
    budget = (cfg.clamp_frac_budget
              * torch.sum(owned).to(torch.float32)).to(torch.int32)
    i32 = torch.int32
    return dict(ax=st5["ax"], ay=st5["ay"], az=st5["az"], du=st5["du"],
                maxvsignal=st5["mvs"], h=h_pf, alpha=alpha_pf, c=c_pf,
                divv=divv_pf, curlv=curlv_pf, nc_sph=nc_sph_pf,
                rho=rho_pf, p=p_pf, kx=kx_pf, xm=xm_pf, nonconv=nonconv_pf,
                fold=(overflow + unowned
                      + torch.where(clamped > budget, clamped, 0)).to(i32),
                fold_parts=torch.stack([overflow.to(i32),
                                        (unowned - miss).to(i32),
                                        miss.to(i32), clamped.to(i32)]))


class _GravityIndex:
    """The alive rows of a particle frame as an index for the gravity
    solver, built once per alive row (one host sync)."""

    def __init__(self):
        self._alive = self._idx = None

    def __call__(self, alive):
        if self._alive is not alive:
            self._alive, self._idx = alive, torch.nonzero(alive).reshape(-1)
        return self._idx


def _tiered_body(state, layouts, engines, box: Box, cfg: SphConfig,
                 gindex):
    """SPH forces on the tiers, gravity on the particle frame, then the
    step tail (finish_step). max_cell_count carries the fold."""
    ps = state.p
    fo = _tiered_forces(ps, state.dt, layouts, engines, box, cfg)
    merged = dict(ax=fo["ax"], ay=fo["ay"], az=fo["az"])
    merged, egrav, nf = _add_gravity(
        merged, ps.x, ps.y, ps.z, ps.m,
        gindex(ps.alive) if cfg.gravG != 0.0 else None, box, cfg)
    ps2 = ps.replace(h=fo["h"], alpha=fo["alpha"])
    max_nc = torch.max(torch.where(ps.alive, fo["nc_sph"] - 1.0, 0.0))
    return finish_step(
        state, ps2, merged["ax"], merged["ay"], merged["az"], fo["du"],
        fo["maxvsignal"], fo["c"], fo["divv"], fo["nc_sph"], box, cfg,
        max_nc=max_nc.to(torch.int32), max_cell_count=fo["fold"],
        egrav=egrav, nf_truncated=nf, rho=fo["rho"], p=fo["p"])


def make_ve_step_tiered(box: Box, tiers, cfg: SphConfig, device=None):
    """step(state) -> (state, StepDiagnostics): the particle-frame VE
    step with each h-tier on its own zoom grid, every tier layout
    rebuilt each step (JAX make_ve_step_pallas_tiered)."""
    device = resolve_device(device)
    engines = _tier_engines(tiers, cfg, device)
    gindex = _GravityIndex()

    def step(state):
        if state.p.device != device:
            raise ValueError(f"state on {state.p.device}, step built for "
                             f"{device}")
        layouts = _build_layouts(engines, box, state.p)
        return _tiered_body(state, layouts, engines, box, cfg, gindex)

    return step


# ---------------------------------------------------------------------------
# resident tiered engine: per-tier layouts carried between steps (the
# incremental focus-tree update analog, octree_focus_mpi.hpp:138-176)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TieredCarry:
    """The simulation state, each tier's data-dependent layout rows
    (src, valid, slot_of, overflow), the drift since the last rebuild
    and the rebuild count."""
    state: object
    layouts: tuple
    drift: torch.Tensor
    rebuilds: torch.Tensor


def _strip_layouts(layouts):
    return tuple((lay.src, lay.valid, lay.slot_of, lay.overflow)
                 for lay in layouts)


def make_ve_step_tiered_resident(box: Box, tiers, cfg: SphConfig,
                                 device=None):
    """Persistent-layout tiered VE step (JAX
    make_ve_step_pallas_tiered_resident). The carried layouts are
    rebuilt (one host `if` a step, as ResidentVE's rebin) when stale:

      - drift margin: 2 (h_max_t + drift) >= REBIN_FRAC edge_t for a
        tier t (a particle may sit up to `drift` from its binned cell);
      - owner-frame miss: an owned particle without a slot in its tier's
        carried layout. A rebuild re-bins a band crosser; a spatial
        escapee stays missed and folds the step.

    Returns (bind, step): bind(state) -> TieredCarry, step(carry) ->
    (carry, StepDiagnostics); carry.state is the current SimState."""
    device = resolve_device(device)
    engines = _tier_engines(tiers, cfg, device)
    edges = [tier_edge(t) for t in tiers]
    per = box.periodic
    L = (box.lx, box.ly, box.lz)
    gindex = _GravityIndex()

    def bind(state):
        if state.p.device != device:
            raise ValueError(f"state on {state.p.device}, step built for "
                             f"{device}")
        f32 = dict(dtype=torch.float32, device=device)
        return TieredCarry(
            state=state,
            layouts=_strip_layouts(_build_layouts(engines, box, state.p)),
            drift=torch.zeros((), **f32),
            rebuilds=torch.zeros((), dtype=torch.int32, device=device))

    def step(carry: TieredCarry):
        ps = carry.state.p
        sels = _tier_sels(engines, ps, ps.h)
        stale = torch.zeros((), dtype=torch.bool, device=device)
        for ti, e in enumerate(engines):
            h_max_t = torch.max(torch.where(sels[ti], ps.h, 0.0))
            stale = stale | (2.0 * (h_max_t + carry.drift)
                             >= REBIN_FRAC * edges[ti])
            stale = stale | torch.any(
                sels[ti] & (carry.layouts[ti][2] >= e.spec.grid.n_slots))
        rebuilt = bool(stale)           # the one host sync of the step
        slim = (_strip_layouts(_build_layouts(engines, box, ps)) if rebuilt
                else carry.layouts)
        layouts = [attach_static(e.spec.grid, e.spec.sub, *s)
                   for e, s in zip(engines, slim)]
        new_state, diag = _tiered_body(carry.state, layouts, engines, box,
                                       cfg, gindex)

        # min-image step displacement (positions may fold at the box)
        def mindelta(a, b, axis):
            d = torch.abs(a - b)
            return torch.minimum(d, L[axis] - d) if per[axis] else d

        p2 = new_state.p
        disp2 = (mindelta(p2.x, ps.x, 0) ** 2 + mindelta(p2.y, ps.y, 1) ** 2
                 + mindelta(p2.z, ps.z, 2) ** 2)
        step_disp = torch.sqrt(torch.max(torch.where(ps.alive, disp2, 0.0)))
        drift = (torch.zeros_like(carry.drift) if rebuilt
                 else carry.drift) + step_disp
        return TieredCarry(state=new_state, layouts=slim, drift=drift,
                           rebuilds=carry.rebuilds + int(rebuilt)), diag

    return bind, step
