"""VE pair stages and the ghost refresh over the cell-major layout.

Counterpart of sphexa_tpu/ops/pallas_ve.py. Each Pallas kernel on the
resident VE path has a hand-written CUDA kernel (csrc/cell_pair.cu,
csrc/ghost_refresh.cu) and, beside its wrapper here, a plain PyTorch
version of the same function:

  K1 ghost_refresh   <- make_ghost_refresh          (pallas_ve.py:349)
  K1z ghost_refresh_xy <- the same, refresh_z=False (:397-403, :419, :430)
  K3 pair_xh         <- _xh_body                    (pallas_ve.py:537)
  K4 pair_gradh      <- _gradh_body                 (pallas_ve.py:622)
  K5 pair_iad        <- _iad_direct_body            (pallas_ve.py:704)
  K6 pair_av         <- _av_direct_body             (pallas_ve.py:900)
  K7 pair_momentum   <- _momentum_body              (pallas_ve.py:1022)
  K7c pair_momentum_avclean <- the same, av_clean   (:1031-1033, :1094-1116)
  K8 pair_iad_mm     <- _iad_hybrid_body            (pallas_ve.py:769)
  K9 pair_av_mm      <- _av_mm_body                 (pallas_ve.py:949)
  K10 pair_momentum_mm <- _momentum_mm_body         (pallas_ve.py:1190)

K8-K10 are the moment-matmul bodies (SphConfig.mxu_moments,
mxu_momentum, mxu_bf16): their plain versions contract the pair
weights with cell-centred j-moment columns in a float32 matmul. K10's
kernel contracts them on the tensor cores (mma.sync: 3xTF32 in float32,
bf16 under mxu_bf16), skipping the blocks whose weights are all zero;
K8's and K9's accumulate the same sums per pair, in float32.

K3-K10 share the driver make_cell_pair_call (pallas_ve.py:103), which in
the port is the launch skeleton of cell_pair.cu: thread blocks of a
cell's i-tile. K4-K9 and K7c run the tiled routine tile::pair_cell:
they stage only the occupied slots of the 27 neighbour cells with
cp.async (K7 and K7c evaluate their in-support pairs compacted across a
warp's lanes, K4-K6, K8 and K9 each lane its own); K3 stages the
occupied slots of the 27 cells as one run and walks it again only for
slots whose h the controller moved; K10 stages the occupied slots,
computes the pair weights on the float32 cores and contracts them on
the tensor cores. Each has one routine for the cell, gated and column
launches.

K2g, the gated driver (make_cell_pair_call(gated=True), pallas_ve.py:
162-172, :242-251), is the same stages but K7c as GATED_KERNELS: a
z-supercell (Z cells of one column) with no active slot keeps its
previous outputs. A gated stage is two launches: the gate pass
(pair_gate) lists the interior cells of the active supercells on the
card, then the stage's kernel, on the cell launch's grid, computes the
listed cells only (the blocks past the device count skip the routine)
and writes prev and the zeros everywhere else; no count is read on the
host. Block time-steps (propagator/ve_bdt.py) run on it.

K11, the column driver (make_column_pair_call, pallas_ve.py:273), is
every stage as COLUMN_KERNELS, selected by PairVE(kernel_mode="column"):
one thread block walks a z-segment of one interior (x, y) column. Its
outputs equal the cell launch's on interior slots, bit for bit, and are
zero elsewhere (the JAX driver zeroes the z-ghost lanes, :307-309).

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel (and counts the launch) or raises. The
counts are shared by the threads of the sharded engines
(domain/mesh.py), so they are taken under a lock.

Frame contract (kept from the JAX package): invalid slots carry FILL_POS
positions and drop out of every pair sum through the distance overflow;
self-pairs are included and absorbed analytically; every stage masks
its outputs with x < 0.5 * FILL_POS so all streamed rows stay finite.
Row orders of the J matrices are those of the JAX package; the TPU's
8-row padding is dropped.
"""

from __future__ import annotations

import functools
import inspect
import threading

import numpy as np
import torch

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.ops import _cuda
from sphexa_tpu_torch.ops.cellmajor import (CMGrid, CMLayout,
                                            _cell_coords_all,
                                            _interior_cells_np, legal_zgroup,
                                            positions_cm, to_cm)
from sphexa_tpu_torch.sfc.box import Box
from sphexa_tpu_torch.sph.kernels import (_DSINC_OVER_V_COEF, _SINC_COEF,
                                          _poly_even, _pow_int, exp_pair,
                                          kernel_3d_k)
from sphexa_tpu_torch.util.fp import rdiv

# base row indices shared by every stage's J matrix
RX, RY, RZ, RH, RGID = 0, 1, 2, 3, 4
NBASE = 5

FILL_POS = 1e8    # invalid-slot position fill: d2 overflows the support
_NEG = -1e30

# ints before the cell list in K2g's gate workspace (cell_pair.cu's
# SPH_GATE_HDR): the count
GATE_HDR = 1

# pair candidates evaluated at once by a plain version (bounds its
# temporaries to a few tens of MB each)
_PAIR_BUDGET = 1 << 22

# the largest slot cap the pair kernels take (a multiple of 32): the JAX
# tile adapter's ceiling off the TPU (multichip.py:216). cell_pair.cu's
# launch check reads it from the generated header (SPH_MAX_CAP).
MAX_CAP = 4096


def check_cap(cap: int):
    """Refuses a slot cap the pair kernels do not take."""
    if cap < 32 or cap % 32 or cap > MAX_CAP:
        raise ValueError(f"cap {cap}: must be a multiple of 32, at most "
                         f"{MAX_CAP}")


_COUNT_LOCK = threading.Lock()


def _count_launch(kernel):
    with _COUNT_LOCK:
        kernel.launches += 1


# ---------------------------------------------------------------------------
# geometry shared by the plain versions and the launches
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def interior_cells(grid: CMGrid) -> np.ndarray:
    """Padded ids of the interior cells in (cx, cy, cz) row-major order,
    the order of the CUDA kernels' blocks (padded ids are row-major)."""
    ids = np.flatnonzero(_interior_cells_np(grid)).astype(np.int64)
    ids.setflags(write=False)
    return ids


def _nbr_offsets(grid: CMGrid) -> np.ndarray:
    """Padded-id offsets of the 27 neighbour cells, (dx, dy, dz) order."""
    d = np.arange(-1, 2)
    dx, dy, dz = np.meshgrid(d, d, d, indexing="ij")
    return ((dx * grid.np_ + dy) * grid.npz + dz).ravel()


def _run_plain(body, J, I2, grid: CMGrid, fo: int, cells=None, **kw):
    """Evaluate `body` for every interior cell (or the padded cell ids
    `cells`, a subset of them) in chunks of cells.
    body(I, Jn, i2, **kw) gets I[r] as [C, R, 1] i-columns, Jn[r] as
    [C, 1, 27*CAP] j-rows and i2[r] as [C, R, 1], and returns fo
    [C, R, 1] outputs; R is CAP, or where one cell's 27 CAP^2 pairs pass
    _PAIR_BUDGET (caps from 416) a slice of the cell's i-slots, so the
    temporaries stay within the budget at any cap. A body with a keyword
    `icell` (the moment bodies, whose origin is the own cell's mean) then
    also gets the whole cell's I there. Slots of other cells come out
    zero."""
    cap = grid.cap
    dev = J.device
    out = torch.zeros((fo, grid.n_slots), dtype=J.dtype, device=dev)
    if cells is None:
        cells = torch.tensor(interior_cells(grid), device=dev)
    offs = torch.tensor(_nbr_offsets(grid), device=dev)
    lane = torch.arange(cap, device=dev)
    chunk = max(1, _PAIR_BUDGET // (27 * cap * cap))
    rows = max(1, _PAIR_BUDGET // (27 * cap))       # i-slots a body call
    whole = "icell" in inspect.signature(body).parameters
    for c0 in range(0, cells.shape[0], chunk):
        cc = cells[c0:c0 + chunk]
        own = (cc[:, None] * cap + lane).reshape(-1)
        nb = ((cc[:, None] + offs)[:, :, None] * cap + lane).reshape(
            cc.shape[0], -1)
        C = cc.shape[0]
        I = J[:, own].reshape(J.shape[0], C, cap, 1)
        Jn = J[:, nb.reshape(-1)].reshape(J.shape[0], C, 1, -1)
        i2 = None if I2 is None else I2[:, own].reshape(I2.shape[0], C, cap, 1)
        if rows >= cap:
            res = body(I, Jn, i2, **kw)
        else:
            ikw = dict(kw, icell=I) if whole else kw
            parts = [body(I[:, :, r0:r0 + rows], Jn,
                          None if i2 is None else i2[:, :, r0:r0 + rows],
                          **ikw) for r0 in range(0, cap, rows)]
            res = [torch.cat(p, dim=1) for p in zip(*parts)]
        out[:, own] = torch.stack([r.reshape(-1) for r in res])
    return out


def resolve_zgroup(grid: CMGrid, zgroup: int = 0) -> int:
    """The gate unit of K2g: Z z-cells of one (x, y) column. 0 picks
    legal_zgroup(npz, cap), as make_cell_pair_call does. The z-supercell
    is part of the block-time-step semantics (an inactive cell inside an
    active supercell is recomputed), so the port keeps the JAX rule."""
    if zgroup == 0:
        zgroup = legal_zgroup(grid.npz, grid.cap)
        if zgroup == 0:
            raise ValueError(f"no z-supercell size divides npz={grid.npz} "
                             f"at cap={grid.cap}")
    if zgroup < 1 or grid.npz % zgroup:
        raise ValueError(f"zgroup {zgroup} must divide npz={grid.npz}")
    return zgroup


def supercell_active(act, grid: CMGrid, Z: int):
    """Per padded cell: its z-supercell holds a slot with act > 0.5
    (the TPU kernel's max(act) > 0.5 over its [Z*CAP] block)."""
    flag = (act.reshape(grid.npx, grid.np_, grid.npz // Z, Z * grid.cap)
            > 0.5).any(-1)
    return flag.repeat_interleave(Z, dim=2).reshape(-1)


def gate_flags(grid: CMGrid) -> int:
    """Where the supercells' flags start in K2g's gate workspace: after
    the header and room for every interior cell in the list."""
    return GATE_HDR + grid.nx * grid.n * grid.nz


def gate_plan(act, grid: CMGrid, Z: int):
    """K2g's gate, plain: (the padded ids of the interior cells whose
    z-supercell is active, ascending; the interior slots of the other
    interior cells, which keep prev). The reference that the gate pass's
    list and the gated kernels' copy are held to."""
    on = supercell_active(act, grid, Z)
    cells = torch.tensor(interior_cells(grid), device=act.device)
    live = on[cells]
    lane = torch.arange(grid.cap, device=act.device)
    keep = (cells[~live][:, None] * grid.cap + lane).reshape(-1)
    return cells[live], keep


def _w_v2(v2, n_w: int):
    """W = sinc(pi v/2)^n as a polynomial in v^2; zero outside support."""
    sinc = _poly_even(v2, _SINC_COEF)
    return torch.where(v2 < 4.0, _pow_int(sinc, n_w), 0.0)


def _sum(t):
    return torch.sum(t, dim=-1, keepdim=True)


def _geo(I, Jn):
    rx = I[RX] - Jn[RX]
    ry = I[RY] - Jn[RY]
    rz = I[RZ] - Jn[RZ]
    return rx, ry, rz, rx * rx + ry * ry + rz * rz


def _oki(I):
    return I[RX] < 0.5 * FILL_POS


# ---------------------------------------------------------------------------
# plain versions of the stage bodies
# ---------------------------------------------------------------------------

def _xh_body(I, Jn, i2, *, cfg: SphConfig, K3d: float, n_w: int):
    """Neighbour count, h_iter rounds of the nc->h controller, xmass.
    Outputs [xm, h, nc, nonconv]."""
    RM = NBASE
    hi = I[RH]
    _, _, _, d2 = _geo(I, Jn)

    def count_sph(hi_inv2):
        return _sum((d2 * hi_inv2 < 4.0).to(torch.float32))

    hinv = 1.0 / hi
    nc_sph = count_sph(hinv * hinv)
    ngmin = float(cfg.ng0 // 4)
    for it in range(cfg.h_iter):
        need = (nc_sph < ngmin) | (nc_sph - 1.0 > float(cfg.ngmax))
        h_new = hi * 0.5 * torch.pow(
            1.0 + rdiv(1023.0 * float(cfg.ng0), torch.clamp_min(nc_sph, 1.0)),
            0.1)
        if cfg.h_cap > 0.0:
            h_new = torch.clamp_max(h_new, float(np.float32(cfg.h_cap)))
        hi = torch.where(need, h_new, hi)
        hinv = 1.0 / hi
        if it < cfg.h_iter - 1:
            nc_sph = count_sph(hinv * hinv)

    v2 = d2 * (hinv * hinv)
    acc = _sum(_w_v2(v2, n_w) * Jn[RM])        # includes +mi (self)
    nc = _sum((v2 < 4.0).to(torch.float32)) - 1.0   # self excluded
    xm = I[RM] * (hi * hi * hi) / (K3d * acc)
    nonconv = ((nc + 1.0 < ngmin) | (nc > float(cfg.ngmax))).to(torch.float32)
    ok = _oki(I)
    return (torch.where(ok, xm, 1.0), hi, torch.where(ok, nc, 0.0),
            torch.where(ok, nonconv, 0.0))


def _gradh_body(I, Jn, i2, *, cfg: SphConfig, K3d: float, n_w: int):
    """VE normalization kx and grad-h, sqrt-free. Outputs [kx, gradh]."""
    RM, RXM = NBASE, NBASE + 1
    hi = I[RH]
    hinv = 1.0 / hi
    hi_inv2 = hinv * hinv
    _, _, _, d2 = _geo(I, Jn)
    v2 = d2 * hi_inv2
    sinc = _poly_even(v2, _SINC_COEF)
    wnm1 = _pow_int(sinc, n_w - 1)
    inside = v2 < 4.0
    w = torch.where(inside, wnm1 * sinc, 0.0)
    vdw = torch.where(inside,
                      n_w * wnm1 * (v2 * _poly_even(v2, _DSINC_OVER_V_COEF)),
                      0.0)
    dterh = -(3.0 * w + vdw)
    kx = _sum(w * Jn[RXM])
    whomega = _sum(dterh * Jn[RXM])
    wrho0 = _sum(dterh * Jn[RM])

    mi, xmi = I[RM], I[RXM]
    h3inv = hinv * hi_inv2
    kx = kx * K3d * h3inv
    whomega = whomega * K3d * h3inv * hinv
    wrho0 = wrho0 * K3d * h3inv * hinv
    whomega = whomega * mi / xmi + (kx - K3d * xmi * h3inv) * wrho0
    rho = kx * mi / xmi
    gradh = 1.0 + hi / (rho * 3.0) * whomega
    ok = _oki(I)
    return torch.where(ok, kx, 1.0), torch.where(ok, gradh, 1.0)


def _iad_tail(t11, t12, t13, t22, t23, t33, hi):
    det = (t11 * t22 * t33 + 2.0 * t12 * t23 * t13
           - t11 * t23 * t23 - t22 * t13 * t13 - t33 * t12 * t12)
    fac = 1.0 / (det * hi * hi)
    return ((t22 * t33 - t23 * t23) * fac, (t13 * t23 - t33 * t12) * fac,
            (t12 * t23 - t22 * t13) * fac, (t11 * t33 - t13 * t13) * fac,
            (t13 * t12 - t11 * t23) * fac, (t11 * t22 - t12 * t12) * fac)


def _iad_body(I, Jn, i2, *, cfg: SphConfig, K3d: float, n_w: int):
    """IAD tau and its inverse, divv, curlv and the six symmetrised
    velocity-gradient rows. Outputs 14 rows."""
    RKX, RXM, RVX, RVY, RVZ = range(NBASE, NBASE + 5)
    hi = I[RH]
    hinv = 1.0 / hi
    hi_inv2 = hinv * hinv
    h3inv = hinv * hi_inv2
    rx, ry, rz, d2 = _geo(I, Jn)
    w = _w_v2(d2 * hi_inv2, n_w)
    volj = Jn[RXM] / Jn[RKX]
    wn = (volj * w) * (K3d * h3inv)
    sx, sy, sz = rx * hinv, ry * hinv, rz * hinv
    t11, t12, t13 = _sum(sx * sx * wn), _sum(sx * sy * wn), _sum(sx * sz * wn)
    t22, t23, t33 = _sum(sy * sy * wn), _sum(sy * sz * wn), _sum(sz * sz * wn)

    wxm = w * Jn[RXM]
    vji = (Jn[RVX] - I[RVX], Jn[RVY] - I[RVY], Jn[RVZ] - I[RVZ])
    rr = (rx, ry, rz)
    Q = [[_sum(wxm * vji[a] * rr[b]) for b in range(3)] for a in range(3)]

    cij = _iad_tail(t11, t12, t13, t22, t23, t33, hi)
    c11, c12, c13, c22, c23, c33 = cij
    C = ((c11, c12, c13), (c12, c22, c23), (c13, c23, c33))

    def dv(a):
        return [-(C[b][0] * Q[a][0] + C[b][1] * Q[a][1] + C[b][2] * Q[a][2])
                for b in range(3)]
    dVx, dVy, dVz = dv(0), dv(1), dv(2)
    return _iad_outputs(cij, dVx, dVy, dVz, K3d * h3inv / I[RKX], _oki(I))


def _iad_outputs(cij, dVx, dVy, dVz, norm_kx, ok):
    """cij, divv, curlv and the six symmetrised gradv rows, zero on
    invalid i-slots (pallas_ve.py:684)."""
    divv = norm_kx * (dVx[0] + dVy[1] + dVz[2])
    curlv = norm_kx * torch.sqrt((dVz[1] - dVy[2]) ** 2
                                 + (dVx[2] - dVz[0]) ** 2
                                 + (dVy[0] - dVx[1]) ** 2)
    outs = list(cij) + [divv, curlv,
                        norm_kx * dVx[0], norm_kx * (dVx[1] + dVy[0]),
                        norm_kx * (dVx[2] + dVz[0]), norm_kx * dVy[1],
                        norm_kx * (dVy[2] + dVz[1]), norm_kx * dVz[2]]
    return [torch.where(ok, o, 0.0) for o in outs]


def _av_body(I, Jn, i2, *, cfg: SphConfig, K3d: float, n_w: int):
    """Max approaching signal speed, graddivv and the Cullen-Dehnen
    alpha update (av_switches_kern.hpp:45). Output [alpha]."""
    RC, RKX, RXM, RDIVV, RVX, RVY, RVZ = range(NBASE, NBASE + 7)
    hi = I[RH]
    hinv = 1.0 / hi
    hi_inv2 = hinv * hinv
    h3inv = hinv * hi_inv2
    ci = I[RC]
    divv_i = I[RDIVV]
    c11i, c12i, c13i, c22i, c23i, c33i = (i2[k] for k in range(6))

    rx, ry, rz, d2 = _geo(I, Jn)
    v2 = d2 * hi_inv2
    mask = v2 < 4.0
    rv = (rx * (I[RVX] - Jn[RVX]) + ry * (I[RVY] - Jn[RVY])
          + rz * (I[RVZ] - Jn[RVZ]))
    inv_d = torch.rsqrt(torch.clamp_min(d2, 1e-30))
    vsig = torch.where(mask & (rv < 0.0), ci + Jn[RC] - 3.0 * rv * inv_d, _NEG)

    w = _w_v2(v2, n_w) * (K3d * h3inv)
    termA1 = -(c11i * rx + c12i * ry + c13i * rz) * w
    termA2 = -(c12i * rx + c22i * ry + c23i * rz) * w
    termA3 = -(c13i * rx + c23i * ry + c33i * rz) * w
    factor = (Jn[RXM] / Jn[RKX]) * (divv_i - Jn[RDIVV])
    gx, gy, gz = _sum(factor * termA1), _sum(factor * termA2), _sum(
        factor * termA3)

    vijsignal = torch.maximum(torch.amax(vsig, dim=-1, keepdim=True),
                              1e-30 * ci)
    alpha = _alpha_tail(i2, torch.sqrt(gx * gx + gy * gy + gz * gz),
                        vijsignal, divv_i, hi, ci, cfg)
    return [torch.where(_oki(I), alpha, 0.0)]


def _alpha_tail(i2, graddivv, vijsignal, divv_i, hi, ci, cfg: SphConfig):
    """Cullen-Dehnen alpha evolution (_av_alpha_tail, pallas_ve.py:865)."""
    alpha_i, dt = i2[6], i2[7]
    a_const = hi * hi * graddivv
    alphaloc = torch.where(divv_i < 0.0,
                           cfg.alphamax * a_const
                           / (a_const + hi * torch.abs(divv_i) + 0.05 * ci),
                           0.0)
    decay = hi / (cfg.decay_constant * vijsignal)
    alphadot = torch.where(alphaloc >= cfg.alphamin,
                           (alphaloc - alpha_i) / decay,
                           (cfg.alphamin - alpha_i) / decay)
    return torch.where(alphaloc >= alpha_i, alphaloc, alpha_i + alphadot * dt)


def _momentum_body(I, Jn, i2, *, cfg: SphConfig, K3d: float, n_w: int,
                   av_clean: bool = False):
    """Momentum and energy (momentum_energy_kern.hpp:65-222) with the
    Atwood-ramped VE terms and pair AV; with av_clean (K7c) the rv
    correction of the AV velocity-gradient cleaning (:44-63) on six more
    gradv rows and eta_crit. Outputs [ax, ay, az, du, maxvsignal]."""
    (RVX, RVY, RVZ, RC, RPRHO, RRHO, RXM, RAL, RM,
     R11, R12, R13, R22, R23, R33) = range(NBASE, NBASE + 15)
    hi = I[RH]
    hi_inv = 1.0 / hi
    hi_inv2 = hi_inv * hi_inv
    hi3inv = hi_inv * hi_inv2
    ci, alpha_i, rhoi, prhoi, xmi = I[RC], I[RAL], I[RRHO], I[RPRHO], I[RXM]
    rhoi_inv = 1.0 / rhoi
    lxmi = torch.log(xmi)
    if av_clean:
        RD = range(NBASE + 15, NBASE + 21)      # gradv d11..d33
        RETA = NBASE + 21
        eta_crit = I[RETA]

    rx, ry, rz, d2 = _geo(I, Jn)
    v2i = d2 * hi_inv2
    mask = v2i < 4.0
    hj_inv = 1.0 / Jn[RH]
    v2j = d2 * (hj_inv * hj_inv)
    Wi = _w_v2(v2i, n_w) * hi3inv
    Wj = torch.where(mask, _w_v2(v2j, n_w) * (hj_inv * hj_inv * hj_inv), 0.0)

    def term(c11, c12, c13, c22, c23, c33, W):
        return (-(c11 * rx + c12 * ry + c13 * rz) * W,
                -(c12 * rx + c22 * ry + c23 * rz) * W,
                -(c13 * rx + c23 * ry + c33 * rz) * W)

    tAi = term(*(I[r] for r in (R11, R12, R13, R22, R23, R33)), Wi)
    tAj = term(*(Jn[r] for r in (R11, R12, R13, R22, R23, R33)), Wj)

    vx_ij = I[RVX] - Jn[RVX]
    vy_ij = I[RVY] - Jn[RVY]
    vz_ij = I[RVZ] - Jn[RVZ]
    rv = rx * vx_ij + ry * vy_ij + rz * vz_ij
    inv_d = torch.rsqrt(torch.clamp_min(d2, 1e-30))
    if av_clean:
        # the quadratic form as the JAX body writes it: the gradv
        # off-diagonals are symmetrised sums, so only the upper triangle
        def quad(d11, d12, d13, d22, d23, d33):
            q1 = d11 * rx + d12 * ry + d13 * rz
            q2 = d22 * ry + d23 * rz
            q3 = d33 * rz
            return rx * q1 + ry * q2 + rz * q3

        dmy1 = quad(*(I[r] for r in RD))
        dmy2 = quad(*(Jn[r] for r in RD))
        dist = d2 * inv_d
        eta_ab = dist * torch.minimum(hi_inv, hj_inv)
        eta_diff = 5.0 * (eta_ab - eta_crit)
        dmy3 = torch.where(eta_ab < eta_crit,
                           torch.exp(-eta_diff * eta_diff), 1.0)
        nz = dmy2 != 0.0
        A_ab = torch.where(nz, dmy1 / torch.where(nz, dmy2, 1.0), 0.0)
        A_abp1 = 1.0 + A_ab
        phi_ab = 0.5 * dmy3 * torch.clamp(4.0 * A_ab / (A_abp1 * A_abp1),
                                          0.0, 1.0)
        rv = rv - phi_ab * (dmy1 + dmy2)
    wij = rv * inv_d
    csum = ci + Jn[RC]
    vij_signal = (alpha_i + Jn[RAL]) * 0.25 * csum - 2.0 * wij
    visc = torch.where(wij < 0.0, -vij_signal * wij, 0.0)
    vsig = torch.where(mask & (d2 > 0.0), 0.5 * csum - 2.0 * wij, _NEG)

    mj, xmj, rhoj = Jn[RM], Jn[RXM], Jn[RRHO]
    drho = torch.abs(rhoi - rhoj)
    srho = rhoi + rhoj
    sigma = cfg.ramp * (drho / srho - cfg.atmin)
    lxmj = torch.log(xmj)
    prod = xmi * xmj
    if cfg.uniform_mass:
        sc = torch.clamp(sigma, 0.0, 1.0)
        ep, em = exp_pair((1.0 - sc) * (lxmj - lxmi))
        a_mom = prod * em
        b_mom = prod * ep
    else:
        is_lo = drho < cfg.atmin * srho
        is_hi = drho > cfg.atmax * srho
        t = torch.exp((sigma - 1.0) * (lxmj - lxmi))
        a_mom = torch.where(is_lo, xmi * xmi,
                            torch.where(is_hi, prod, prod * t))
        b_mom = torch.where(is_lo, xmj * xmj,
                            torch.where(is_hi, prod, prod / t))

    a_visc = (mj * rhoi_inv) * visc
    b_visc = (mj / rhoj) * visc
    av = [0.5 * (a_visc * tAi[k] + b_visc * tAj[k]) for k in range(3)]
    a_visc_energy = _sum(av[0] * vx_ij + av[1] * vy_ij + av[2] * vz_ij)
    energy = _sum(mj * a_mom * (vx_ij * tAi[0] + vy_ij * tAi[1]
                                + vz_ij * tAi[2]))
    mom_i = mj * prhoi * a_mom
    mom_j = mj * Jn[RPRHO] * b_mom
    mom = [_sum(mom_i * tAi[k] + mom_j * tAj[k] + av[k]) for k in range(3)]

    a_visc_energy = torch.clamp_min(a_visc_energy, 0.0)
    maxvsignal = torch.clamp_min(torch.amax(vsig, dim=-1, keepdim=True), 0.0)
    du = K3d * (prhoi * energy + 0.5 * a_visc_energy)
    ok = _oki(I)
    return [torch.where(ok, o, 0.0) for o in
            (-K3d * mom[0], -K3d * mom[1], -K3d * mom[2], du, maxvsignal)]


# ---------------------------------------------------------------------------
# plain versions of the moment-matmul bodies (mxu_moments, mxu_momentum)
# ---------------------------------------------------------------------------

def _cell_means(I, rows):
    """Mean over the valid slots (gid >= 0) of the i-cell of each row,
    as [C, 1, 1]: the expansion origin of the moment factorization. The
    JAX body takes it per 128-slot sub-block when cap > 128
    (pallas_ve.py:211-214); any origin is algebraically exact, so one
    per cell differs from it only by rounding."""
    vrow = I[RGID] >= 0.0
    nv = torch.clamp_min(torch.sum(vrow.to(torch.float32), dim=1,
                                   keepdim=True), 1.0)
    return [torch.sum(torch.where(vrow, I[r], 0.0), dim=1, keepdim=True) / nv
            for r in rows]


def _contract(w, cols):
    """sum_j w[c, i, j] * col_k[c, 0, j] -> [C, CAP, K]: the moment
    contraction (the JAX body's dot_general), in float32."""
    M = torch.cat(cols, dim=1)                       # [C, K, W]
    return torch.matmul(w, M.transpose(1, 2))


def _iad_mm_body(I, Jn, i2, *, cfg: SphConfig, K3d: float, n_w: int,
                 icell=None):
    """K5's outputs with tau accumulated directly and the velocity
    gradients from 16 cell-centred j-moments (_iad_hybrid_body,
    pallas_ve.py:769). Outputs 14 rows."""
    RKX, RXM, RVX, RVY, RVZ = range(NBASE, NBASE + 5)
    hi = I[RH]
    hinv = 1.0 / hi
    hi_inv2 = hinv * hinv
    h3inv = hinv * hi_inv2
    ox, oy, oz, ovx, ovy, ovz = _cell_means(
        I if icell is None else icell, (RX, RY, RZ, RVX, RVY, RVZ))
    xib = (I[RX] - ox, I[RY] - oy, I[RZ] - oz)
    vic = (I[RVX] - ovx, I[RVY] - ovy, I[RVZ] - ovz)

    rx, ry, rz, d2 = _geo(I, Jn)
    w = _w_v2(d2 * hi_inv2, n_w)
    volj = Jn[RXM] / Jn[RKX]
    wn = (volj * w) * (K3d * h3inv)
    sx, sy, sz = rx * hinv, ry * hinv, rz * hinv
    t11, t12, t13 = _sum(sx * sx * wn), _sum(sx * sy * wn), _sum(sx * sz * wn)
    t22, t23, t33 = _sum(sy * sy * wn), _sum(sy * sz * wn), _sum(sz * sz * wn)

    xjc, yjc, zjc = Jn[RX] - ox, Jn[RY] - oy, Jn[RZ] - oz
    xmj = Jn[RXM]
    ux = xmj * (Jn[RVX] - ovx)
    uy = xmj * (Jn[RVY] - ovy)
    uz = xmj * (Jn[RVZ] - ovz)
    mom = _contract(w, [xmj, xmj * xjc, xmj * yjc, xmj * zjc,
                        ux, ux * xjc, ux * yjc, ux * zjc,
                        uy, uy * xjc, uy * yjc, uy * zjc,
                        uz, uz * xjc, uz * yjc, uz * zjc])

    def mc(k):
        return mom[:, :, k:k + 1]

    cij = _iad_tail(t11, t12, t13, t22, t23, t33, hi)
    c11, c12, c13, c22, c23, c33 = cij
    S0, S = mc(0), (mc(1), mc(2), mc(3))

    def dv(base, v_i):
        # F_b = xi_b (U0 - v_i S0) - (U_b - v_i S_b); dV_a = -(C F)_a
        U0 = mc(base)
        F = [xib[b] * (U0 - v_i * S0) - (mc(base + 1 + b) - v_i * S[b])
             for b in range(3)]
        return [-(c11 * F[0] + c12 * F[1] + c13 * F[2]),
                -(c12 * F[0] + c22 * F[1] + c23 * F[2]),
                -(c13 * F[0] + c23 * F[1] + c33 * F[2])]

    dVx, dVy, dVz = dv(4, vic[0]), dv(8, vic[1]), dv(12, vic[2])
    return _iad_outputs(cij, dVx, dVy, dVz, K3d * h3inv / I[RKX], _oki(I))


def _av_mm_body(I, Jn, i2, *, cfg: SphConfig, K3d: float, n_w: int,
                icell=None):
    """K6's alpha with graddivv from 8 cell-centred j-moments
    (_av_mm_body, pallas_ve.py:949); the signal-speed max stays per
    pair. Output [alpha]."""
    RC, RKX, RXM, RDIVV, RVX, RVY, RVZ = range(NBASE, NBASE + 7)
    hi = I[RH]
    hinv = 1.0 / hi
    hi_inv2 = hinv * hinv
    h3inv = hinv * hi_inv2
    ci = I[RC]
    divv_i = I[RDIVV]
    c11i, c12i, c13i, c22i, c23i, c33i = (i2[k] for k in range(6))
    ox, oy, oz, odv = _cell_means(I if icell is None else icell,
                                  (RX, RY, RZ, RDIVV))
    xib = (I[RX] - ox, I[RY] - oy, I[RZ] - oz)
    dvic = divv_i - odv

    rx, ry, rz, d2 = _geo(I, Jn)
    v2 = d2 * hi_inv2
    mask = v2 < 4.0
    rv = (rx * (I[RVX] - Jn[RVX]) + ry * (I[RVY] - Jn[RVY])
          + rz * (I[RVZ] - Jn[RVZ]))
    inv_d = torch.rsqrt(torch.clamp_min(d2, 1e-30))
    vsig = torch.where(mask & (rv < 0.0), ci + Jn[RC] - 3.0 * rv * inv_d, _NEG)

    wm = _w_v2(v2, n_w)
    volj = Jn[RXM] / Jn[RKX]
    xjc, yjc, zjc = Jn[RX] - ox, Jn[RY] - oy, Jn[RZ] - oz
    vd = volj * (Jn[RDIVV] - odv)
    mom = _contract(wm, [volj, volj * xjc, volj * yjc, volj * zjc,
                         vd, vd * xjc, vd * yjc, vd * zjc])

    def mc(k):
        return mom[:, :, k:k + 1]

    S0v, Sv, D0, D = mc(0), (mc(1), mc(2), mc(3)), mc(4), (mc(5), mc(6),
                                                           mc(7))
    G = [xib[b] * (dvic * S0v - D0) - (dvic * Sv[b] - D[b]) for b in range(3)]
    scale = K3d * h3inv
    gx = -(c11i * G[0] + c12i * G[1] + c13i * G[2]) * scale
    gy = -(c12i * G[0] + c22i * G[1] + c23i * G[2]) * scale
    gz = -(c13i * G[0] + c23i * G[1] + c33i * G[2]) * scale
    vijsignal = torch.maximum(torch.amax(vsig, dim=-1, keepdim=True),
                              1e-30 * ci)
    alpha = _alpha_tail(i2, torch.sqrt(gx * gx + gy * gy + gz * gz),
                        vijsignal, divv_i, hi, ci, cfg)
    return [torch.where(_oki(I), alpha, 0.0)]


def bf16_round(x):
    """x rounded to bfloat16 (nearest even) and back to float32."""
    return x.to(torch.bfloat16).to(torch.float32)


# (a, b) pairs of the momentum moment columns, and the symmetric cij row
# of each (the C6 map of _momentum_mm_body)
_AB = tuple((a, b) for a in range(3) for b in range(3))
_C6 = {(0, 0): 0, (0, 1): 1, (1, 0): 1, (0, 2): 2, (2, 0): 2,
       (1, 1): 3, (1, 2): 4, (2, 1): 4, (2, 2): 5}


def _momentum_mm_body(I, Jn, i2, *, cfg: SphConfig, K3d: float, n_w: int,
                      icell=None):
    """K7's five reductions as one contraction of five pair-weight
    families with 49 cell-centred j-moment columns (_momentum_mm_body,
    pallas_ve.py:1190). Its own arithmetic, not K7's: the Atwood ramp
    always takes exp with is_lo/is_hi, visc is masked by the support,
    and the i and j rows are sanitised by validity. cfg.mxu_bf16 rounds
    both operands to bf16 (nearest even) and accumulates in float32.
    Outputs [ax, ay, az, du, maxvsignal]."""
    (RVX, RVY, RVZ, RC, RPRHO, RRHO, RXM, RAL, RM,
     R11, R12, R13, R22, R23, R33) = range(NBASE, NBASE + 15)
    hi = I[RH]
    hi_inv = 1.0 / hi
    hi_inv2 = hi_inv * hi_inv
    hi3inv = hi_inv * hi_inv2
    oki = _oki(I)
    ci = torch.where(oki, I[RC], 1.0)
    alpha_i = torch.where(oki, I[RAL], 0.0)
    rhoi = torch.where(oki, I[RRHO], 1.0)
    rhoi_inv = 1.0 / rhoi
    prhoi = torch.where(oki, I[RPRHO], 0.0)
    xmi = torch.where(oki, I[RXM], 1.0)
    lxmi = torch.log(xmi)
    cii = [torch.where(oki, I[r], 0.0) for r in (R11, R12, R13, R22, R23,
                                                 R33)]
    ox, oy, oz, ovx, ovy, ovz = _cell_means(
        I if icell is None else icell, (RX, RY, RZ, RVX, RVY, RVZ))
    bic = [torch.where(oki, I[r] - o, 0.0)
           for r, o in ((RX, ox), (RY, oy), (RZ, oz))]
    vic = [torch.where(oki, I[r] - o, 0.0)
           for r, o in ((RVX, ovx), (RVY, ovy), (RVZ, ovz))]

    rx, ry, rz, d2 = _geo(I, Jn)
    v2i = d2 * hi_inv2
    mask = v2i < 4.0
    hj_inv = 1.0 / Jn[RH]
    v2j = d2 * (hj_inv * hj_inv)
    Wi = torch.where(mask, _w_v2(v2i, n_w) * hi3inv, 0.0)
    Wj = torch.where(mask, _w_v2(v2j, n_w) * (hj_inv * hj_inv * hj_inv), 0.0)

    vx_ij = I[RVX] - Jn[RVX]
    vy_ij = I[RVY] - Jn[RVY]
    vz_ij = I[RVZ] - Jn[RVZ]
    rv = rx * vx_ij + ry * vy_ij + rz * vz_ij
    wij = rv * torch.rsqrt(torch.clamp_min(d2, 1e-30))
    csum = ci + Jn[RC]
    vij_signal = (alpha_i + Jn[RAL]) * 0.25 * csum - 2.0 * wij
    visc = torch.where(mask & (wij < 0.0), -vij_signal * wij, 0.0)
    vsig = torch.where(mask & (d2 > 0.0), 0.5 * csum - 2.0 * wij, _NEG)

    okj = Jn[RGID] >= 0.0
    mj = torch.where(okj, Jn[RM], 0.0)
    xmj = torch.where(okj, Jn[RXM], 1.0)
    rhoj = torch.where(okj, Jn[RRHO], 1.0)
    prhoj = torch.where(okj, Jn[RPRHO], 0.0)

    drho = torch.abs(rhoi - rhoj)
    srho = rhoi + rhoj
    is_lo = drho < cfg.atmin * srho
    is_hi = drho > cfg.atmax * srho
    sigma = cfg.ramp * (drho / srho - cfg.atmin)
    t = torch.exp((sigma - 1.0) * (torch.log(xmj) - lxmi))
    prod = xmi * xmj
    a_mom = torch.where(is_lo, xmi * xmi, torch.where(is_hi, prod, prod * t))
    b_mom = torch.where(is_lo, xmj * xmj, torch.where(is_hi, prod, prod / t))

    av2 = (0.5 * mj) * visc
    Vi_w = av2 * rhoi_inv
    Vj_w = av2 / rhoj
    Ei_w = mj * a_mom
    Pi_w = prhoi * Ei_w + Vi_w
    Pj_w = (prhoj * b_mom) * mj + Vj_w
    L = [Pi_w * Wi, Pj_w * Wj, Ei_w * Wi, Vi_w * Wi, Vj_w * Wj]

    one = okj.to(torch.float32)
    bjc = [torch.where(okj, Jn[r] - o, 0.0)
           for r, o in ((RX, ox), (RY, oy), (RZ, oz))]
    vjc = [torch.where(okj, Jn[r] - o, 0.0)
           for r, o in ((RVX, ovx), (RVY, ovy), (RVZ, ovz))]
    cj6 = [torch.where(okj, Jn[r], 0.0)
           for r in (R11, R12, R13, R22, R23, R33)]
    cols = [one] + bjc + vjc
    cols += [vjc[a] * bjc[b] for a, b in _AB]
    cols += cj6
    cols += [cj6[_C6[ab]] * bjc[ab[1]] for ab in _AB]
    cols += [cj6[_C6[ab]] * vjc[ab[0]] for ab in _AB]
    cols += [cj6[_C6[ab]] * vjc[ab[0]] * bjc[ab[1]] for ab in _AB]
    if cfg.mxu_bf16:
        L = [bf16_round(x) for x in L]
        cols = [bf16_round(x) for x in cols]
    SA, SB, SC, SD, SE = (_contract(x, cols) for x in L)

    def col(S, k):
        return S[:, :, k:k + 1]

    RA = [bic[b] * col(SA, 0) - col(SA, 1 + b) for b in range(3)]
    momA = [-(cii[_C6[(a, 0)]] * RA[0] + cii[_C6[(a, 1)]] * RA[1]
              + cii[_C6[(a, 2)]] * RA[2]) for a in range(3)]

    def UB(a):
        acc = 0.0
        for b in range(3):
            acc = acc + bic[b] * col(SB, 16 + _C6[(a, b)]) \
                - col(SB, 22 + 3 * a + b)
        return acc

    mom = [momA[a] - UB(a) for a in range(3)]

    def QI(S):
        acc = 0.0
        for a, b in _AB:
            q = (vic[a] * bic[b] * col(S, 0) - vic[a] * col(S, 1 + b)
                 - bic[b] * col(S, 4 + a) + col(S, 7 + 3 * a + b))
            acc = acc + cii[_C6[(a, b)]] * q
        return -acc

    energy = QI(SC)
    avE_i = QI(SD)
    avE_j = 0.0
    for a, b in _AB:
        avE_j = avE_j - (vic[a] * bic[b] * col(SE, 16 + _C6[(a, b)])
                         - vic[a] * col(SE, 22 + 3 * a + b)
                         - bic[b] * col(SE, 31 + 3 * a + b)
                         + col(SE, 40 + 3 * a + b))
    a_visc_energy = torch.clamp_min(avE_i + avE_j, 0.0)
    maxvsignal = torch.clamp_min(torch.amax(vsig, dim=-1, keepdim=True), 0.0)
    du = K3d * (prhoi * energy + 0.5 * a_visc_energy)
    return [-K3d * mom[0], -K3d * mom[1], -K3d * mom[2], du, maxvsignal]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_rows(name, t, rows, grid: CMGrid):
    if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name}: expects a contiguous 2-D float32 tensor")
    if t.shape != (rows, grid.n_slots):
        raise ValueError(f"{name}: expects shape {(rows, grid.n_slots)}, "
                         f"got {tuple(t.shape)}")


def _check_aligned(name, *tensors):
    """K2g's kernels access act, prev and out with 16-byte loads."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: K2g's rows must be 16-byte aligned")


# K11's z-segment: the cells a thread block walks. Of the segments
# chip_smoke.py times at the Sedov 100^3 inputs (PERF.md), one cell a
# block was the fastest for every stage but K10 (two within 1% of it):
# longer segments leave fewer blocks in flight.
COLUMN_ZSEG = 1


class PairKernel:
    """One pair stage: the CUDA kernel (stage `stage` of cell_pair.cu)
    and its plain PyTorch version. `launches` counts kernel launches.

    A gated stage (K2g) takes gate=(act, prev): act is a [n_slots] 0/1
    row and prev [fo, n_slots]. Each z-supercell of `zgroup` cells
    (resolve_zgroup) with no active slot returns prev in its interior
    slots instead of the pair result."""

    def __init__(self, name: str, stage: int, fj: int, fo: int, fi2: int,
                 body, gated: bool = False, column: bool = False):
        self.name = name
        self.stage = stage
        self.fj, self.fo, self.fi2 = fj, fo, fi2
        self.body = body
        self.gated = gated
        self.column = column
        self.launches = 0
        # K11's z-segment; chip_smoke.py sweeps it
        self.zseg = COLUMN_ZSEG if column else 0

    def _body_kw(self, cfg: SphConfig):
        return dict(cfg=cfg, K3d=kernel_3d_k(cfg.sinc_index),
                    n_w=int(cfg.sinc_index))

    def plain(self, J, I2, grid: CMGrid, cfg: SphConfig, gate=None,
              zgroup: int = 0) -> torch.Tensor:
        if gate is None:
            return _run_plain(self.body, J, I2, grid, self.fo,
                              **self._body_kw(cfg))
        act, prev = gate
        cells, keep = gate_plan(act, grid, resolve_zgroup(grid, zgroup))
        out = _run_plain(self.body, J, I2, grid, self.fo, cells=cells,
                         **self._body_kw(cfg))
        out[:, keep] = prev[:, keep]
        return out

    def _launch(self, J, I2, grid: CMGrid, cfg: SphConfig, gate=None,
                zgroup: int = 0, stats=None) -> torch.Tensor:
        """stats: an int64 [3] tensor on the card that the launch adds
        its counts to (chip_smoke.py reads them): K3 its lanes' walks,
        warp walks and the candidates those walked; K10 the mma blocks
        it issued and those of its staged k-steps. None on the engines'
        path. A gated launch first runs the gate pass (pair_gate, which
        counts its own launch), then the stage's kernel over its list,
        which also writes prev and the zeros into out with 16-byte
        accesses."""
        check_cap(grid.cap)
        K3d = kernel_3d_k(cfg.sinc_index)
        if gate is not None:
            act, prev = gate
            Z = resolve_zgroup(grid, zgroup)
            out = torch.empty((self.fo, grid.n_slots), dtype=torch.float32,
                              device=J.device)
            _check_aligned(self.name, out, prev)
            gate = (pair_gate(act, grid, Z), prev, Z)
        else:
            out = torch.zeros((self.fo, grid.n_slots), dtype=torch.float32,
                              device=J.device)
        if self.column:
            _cuda.pair_launch_column(self.stage, J, I2, out, grid, cfg, K3d,
                                     self.zseg, stats)
        else:
            _cuda.pair_launch(self.stage, J, I2, out, grid, cfg, K3d, gate,
                              stats)
        return out

    def _check(self, J, I2, grid: CMGrid, gate):
        _check_rows(self.name, J, self.fj, grid)
        tensors = [J]
        if self.fi2:
            _check_rows(self.name, I2, self.fi2, grid)
            tensors.append(I2)
        if self.gated != (gate is not None):
            raise ValueError(f"{self.name}: gate= is required exactly for "
                             f"a gated stage")
        if gate is not None:
            act, prev = gate
            _check_rows(self.name, act[None], 1, grid)
            _check_rows(self.name, prev, self.fo, grid)
            tensors += [act, prev]
        if any(t.device != J.device for t in tensors):
            raise ValueError(f"{self.name}: inputs on different devices")

    def __call__(self, J, I2, grid: CMGrid, cfg: SphConfig, gate=None,
                 zgroup: int = 0) -> torch.Tensor:
        self._check(J, I2, grid, gate)
        args = (J, I2, grid, cfg) + (() if gate is None else (gate, zgroup))
        if J.device.type == "cpu":
            return self.plain(*args)
        if J.device.type != "cuda":
            raise ValueError(f"{self.name}: no kernel for device {J.device}")
        out = self._launch(*args)
        _count_launch(self)
        return out


class GatePass:
    """K2g's gate pass (cell_pair.cu gate_pass): for the [n_slots]
    activity row act and the gate unit Z (resolve_zgroup), the int32
    workspace ws that the gated stage's kernel reads: ws[0] the count of
    listed cells, ws[GATE_HDR:GATE_HDR + count] their padded ids, the
    interior cells of the active z-supercells (in no fixed order on the
    card, ascending in the plain version, gate_plan), then from
    gate_flags(grid) one 0/1 flag a supercell (padded (x, y) column
    major, npz / Z a column; 0 outside the interior columns). The kernel
    reads act with 16-byte loads. `launches` counts the gate pass's
    launches."""

    name = "pair_gate"

    def __init__(self):
        self.launches = 0

    def _workspace(self, grid: CMGrid, Z: int, device):
        n_sc = grid.npx * grid.np_ * (grid.npz // Z)
        return torch.empty(gate_flags(grid) + n_sc, dtype=torch.int32,
                           device=device)

    def plain(self, act, grid: CMGrid, Z: int):
        cells, _ = gate_plan(act, grid, Z)
        ws = self._workspace(grid, Z, act.device).zero_()
        ws[0] = cells.numel()
        ws[GATE_HDR:GATE_HDR + cells.numel()] = cells
        on = supercell_active(act, grid, Z).view(
            grid.npx, grid.np_, -1, Z)[..., 0]
        on[[0, -1]] = False                      # the x-y ghost columns
        on[:, [0, -1]] = False
        ws[gate_flags(grid):] = on.reshape(-1)
        return ws

    def _launch(self, act, grid: CMGrid, Z: int):
        _check_aligned(self.name, act)
        ws = self._workspace(grid, Z, act.device)
        _cuda.pair_gate(act, ws, grid, Z)
        return ws

    def __call__(self, act, grid: CMGrid, Z: int):
        _check_rows(self.name, act[None], 1, grid)
        if grid.npz % Z:
            raise ValueError(f"{self.name}: zgroup {Z} must divide "
                             f"npz={grid.npz}")
        if act.device.type == "cpu":
            return self.plain(act, grid, Z)
        if act.device.type != "cuda":
            raise ValueError(f"{self.name}: no kernel for device "
                             f"{act.device}")
        ws = self._launch(act, grid, Z)
        _count_launch(self)
        return ws


@functools.lru_cache(maxsize=16)
def _ghost_maps(grid: CMGrid, box: Box, refresh_z: bool = True):
    """Host maps of K1: the kernel's table (csrc/ghost_refresh.cu: per
    ghost cell its destination and source cell and a code of its sides
    on the axes whose shift applies and of its open flag), and for the
    plain version per ghost slot its source slot (column and z wrapped,
    as srcmap and the z-wrap of make_ghost_refresh), its periodic shifts
    and its open-axis flag.

    refresh_z=False (K1z): only the cells of the x-y ghost columns, every
    z of them, each from the wrapped column at the same z (out = v,
    pallas_ve.py:403), with no z shift (:419) and no z open-axis flag
    (:430). The z-ghost cells of interior columns are not listed."""
    cap, npd, npz, npx = grid.cap, grid.np_, grid.npz, grid.npx
    cx, cy, cz = _cell_coords_all(grid)
    if refresh_z:
        ghost = ~_interior_cells_np(grid)
    else:
        ghost = (cx == 0) | (cx == npx - 1) | (cy == 0) | (cy == npd - 1)
    cells = np.arange(grid.n_cells)[ghost]
    gx, gy, gz = cx[ghost], cy[ghost], cz[ghost]

    def wrap(c, last, nint):
        return np.where(c == 0, nint, np.where(c == last - 1, 1, c))

    def side(c, last):
        return np.where(c == 0, -1.0, np.where(c == last - 1, 1.0, 0.0))

    wz = wrap(gz, npz, grid.nz) if refresh_z else gz
    src_cell = (wrap(gx, npx, grid.nx) * npd + wrap(gy, npd, grid.n)) * npz \
        + wz
    px, py, pz = box.periodic
    pz = pz and refresh_z
    sides = np.stack([side(gx, npx) * px, side(gy, npd) * py,
                      side(gz, npz) * pz])
    shift = (sides * np.array([box.lx, box.ly, box.lz])[:, None]).astype(
        np.float32)
    bad = np.zeros(cells.shape, bool)
    axes = ((px, gx, npx), (py, gy, npd))
    if refresh_z:
        axes += ((pz, gz, npz),)
    for per, c, last in axes:
        if not per:
            bad |= (c == 0) | (c == last - 1)
    lane = np.arange(cap)
    code = sum((s.astype(np.int64) + 1) << (2 * k) for k, s in
               enumerate(sides)) | (bad.astype(np.int64) << 6)
    maps = dict(
        table=np.stack([cells, src_cell, code, np.zeros_like(code)],
                       axis=1).astype(np.int32),
        slots=(cells[:, None] * cap + lane).ravel(),
        src=(src_cell[:, None] * cap + lane).ravel(),
        shift=np.repeat(shift, cap, axis=1),
        bad=np.repeat(bad, cap))
    for a in maps.values():
        a.setflags(write=False)
    return maps


class GhostRefresh:
    """K1: refresh every ghost column and z-ghost lane of a [nrows,
    n_slots] row stack from its interior source cell, in place.
    xyz_rows=(ix, iy, iz) marks coordinate rows: they get the +-L
    periodic shifts, and open-axis ghosts get FILL_POS there and 0 in
    the other rows. With xyz_rows=None every ghost is a plain copy.

    refresh_z=False is K1z (the instance ghost_refresh_xy), the
    slab-sharded engines' refresh: only the x-y ghost columns are
    rewritten, each whole column (its z-ghost lanes too) from the
    wrapped interior column at the same z, with no z shift and no z
    FILL_POS. The z-ghost lanes of interior columns stay as they are:
    the z-plane exchange has just written them. One kernel serves both,
    with its own launch count per instance."""

    def __init__(self, refresh_z: bool = True):
        self.refresh_z = refresh_z
        self.name = "ghost_refresh" if refresh_z else "ghost_refresh_xy"
        self.launches = 0
        self._launchers = {}
        self._last = None

    def plain(self, stack, grid: CMGrid, box: Box, xyz_rows=None):
        mp = _ghost_maps(grid, box, self.refresh_z)
        dev = stack.device
        slots = torch.tensor(mp["slots"], device=dev)
        vals = stack[:, torch.tensor(mp["src"], device=dev)]
        if xyz_rows is not None:
            shift = torch.tensor(mp["shift"], device=dev)
            fill = torch.zeros((stack.shape[0], 1), dtype=stack.dtype,
                               device=dev)
            for k, r in enumerate(xyz_rows):
                if box.periodic[k]:
                    vals[r] += shift[k]
                fill[r] = FILL_POS
            vals = torch.where(torch.tensor(mp["bad"], device=dev), fill, vals)
        stack[:, slots] = vals
        return stack

    def _launcher(self, stack, grid: CMGrid, box: Box):
        """The bound launch of (grid, box) on the stack's device: its
        table on the device and its ready argument block, built once.
        The last one used is checked by identity first, so a launch on
        the engines' path hashes nothing."""
        dev = stack.get_device()
        last = self._last
        if last is not None and last[0] is grid and last[1] is box \
                and last[2] == dev:
            return last[3]
        key = (grid, box, dev)
        launcher = self._launchers.get(key)
        if launcher is None:
            table = torch.tensor(_ghost_maps(grid, box, self.refresh_z)[
                "table"], device=stack.device)
            launcher = _cuda.GhostLaunch(table, grid.cap, box, FILL_POS,
                                         self.name)
            self._launchers[key] = launcher
        self._last = (grid, box, dev, launcher)
        return launcher

    def _launch(self, stack, grid: CMGrid, box: Box, xyz_rows):
        self._launcher(stack, grid, box)(stack, xyz_rows)
        return stack

    def __call__(self, stack, grid: CMGrid, box: Box, xyz_rows=None):
        _check_rows(self.name, stack, stack.shape[0], grid)
        if stack.device.type == "cpu":
            return self.plain(stack, grid, box, xyz_rows)
        if stack.device.type != "cuda":
            raise ValueError(f"{self.name}: no kernel for device "
                             f"{stack.device}")
        self._launch(stack, grid, box, xyz_rows)
        _count_launch(self)
        return stack


ghost_refresh = GhostRefresh()
ghost_refresh_xy = GhostRefresh(refresh_z=False)     # K1z
pair_gate = GatePass()                               # K2g's gate pass
pair_xh = PairKernel("pair_xh", 0, NBASE + 1, 4, 0, _xh_body)
pair_gradh = PairKernel("pair_gradh", 1, NBASE + 2, 2, 0, _gradh_body)
pair_iad = PairKernel("pair_iad", 2, NBASE + 5, 14, 0, _iad_body)
pair_av = PairKernel("pair_av", 3, NBASE + 7, 1, 8, _av_body)
pair_momentum = PairKernel("pair_momentum", 4, NBASE + 15, 5, 0,
                           _momentum_body)

# the moment-matmul bodies (K8-K10) and K7's avClean form (K7c)
pair_iad_mm = PairKernel("pair_iad_mm", 5, NBASE + 5, 14, 0, _iad_mm_body)
pair_av_mm = PairKernel("pair_av_mm", 6, NBASE + 7, 1, 8, _av_mm_body)
pair_momentum_mm = PairKernel("pair_momentum_mm", 7, NBASE + 15, 5, 0,
                              _momentum_mm_body)
pair_momentum_avclean = PairKernel(
    "pair_momentum_avclean", 8, NBASE + 22, 5, 0,
    functools.partial(_momentum_body, av_clean=True))

# the default (direct) bodies of the resident step
KERNELS = (ghost_refresh, pair_xh, pair_gradh, pair_iad, pair_av,
           pair_momentum)
MM_KERNELS = (pair_iad_mm, pair_av_mm, pair_momentum_mm)
# K2g: the stages behind the supercell gate (block time-steps); K7c has
# no gated form (BdtVE refuses avClean, as the JAX package)
GATED_KERNELS = tuple(
    PairKernel(k.name + "_gated", k.stage, k.fj, k.fo, k.fi2, k.body,
               gated=True) for k in KERNELS[1:] + MM_KERNELS)
(pair_xh_gated, pair_gradh_gated, pair_iad_gated, pair_av_gated,
 pair_momentum_gated, pair_iad_mm_gated, pair_av_mm_gated,
 pair_momentum_mm_gated) = GATED_KERNELS
# K11: every stage under the column launch
COLUMN_KERNELS = tuple(
    PairKernel(k.name + "_column", k.stage, k.fj, k.fo, k.fi2, k.body,
               column=True)
    for k in KERNELS[1:] + MM_KERNELS + (pair_momentum_avclean,))
PAIR_KERNELS = KERNELS[1:] + MM_KERNELS + (pair_momentum_avclean,) \
    + GATED_KERNELS + COLUMN_KERNELS


# ---------------------------------------------------------------------------
# stage collection (counterpart of PallasVE)
# ---------------------------------------------------------------------------


class PairVE:
    """The five VE pair stages for one (grid, cfg), with the stage
    methods and J row orders of the JAX package's PallasVE.

    gated=True runs K2g: every stage method then takes gate=(act,
    prevs), act the [n_slots] 0/1 activity row and prevs the previous
    output rows in the stage's output order (PallasVE._gate_kw without
    the TPU's row padding: rows past the list are zero, rows past the
    stage's outputs are dropped). zgroup 0 picks legal_zgroup.

    The bodies are chosen as PallasVE.__init__ does (pallas_ve.py:
    1427-1436): mxu_moments takes K8 and K9 for IAD and AV; the momentum
    stage is K7c under av_clean (also when mxu_momentum is set), else K10
    under mxu_momentum, else K7. `kernels` lists the five chosen.

    kernel_mode "column" launches the same bodies through K11 (the
    column kernels, COLUMN_KERNELS), as PallasVE(kernel_mode="column"):
    cubic grids only, and no gated form."""

    def __init__(self, grid: CMGrid, cfg: SphConfig, gated: bool = False,
                 zgroup: int = 0, kernel_mode: str = "cell"):
        check_cap(grid.cap)
        n_w = int(cfg.sinc_index)
        if float(n_w) != float(cfg.sinc_index) or n_w < 2:
            raise ValueError("the pair stages need an integer sinc index >= 2")
        if kernel_mode not in ("cell", "column"):
            raise ValueError(f"kernel_mode {kernel_mode!r}: 'cell' or "
                             f"'column'")
        if kernel_mode == "column":
            if gated:
                raise ValueError("the column launch has no gated form")
            if not grid.nx == grid.n == grid.nz:
                raise ValueError(f"the column launch takes cubic grids "
                                 f"only, got {grid}")
        if gated and cfg.av_clean:
            raise NotImplementedError(
                "the avClean momentum stage has no gated form (block "
                "time-steps run with av_clean off, as in the JAX package)")
        self.grid = grid
        self.cfg = cfg
        self.K3d = kernel_3d_k(cfg.sinc_index)
        self.gated = gated
        self.zgroup = resolve_zgroup(grid, zgroup) if gated else 0
        if cfg.av_clean:
            mom = pair_momentum_avclean
        elif cfg.mxu_momentum:
            mom = pair_momentum_mm
        else:
            mom = pair_momentum
        iad, av = ((pair_iad_mm, pair_av_mm) if cfg.mxu_moments
                   else (pair_iad, pair_av))
        kerns = (pair_xh, pair_gradh, iad, av, mom)
        if gated:
            kerns = tuple(next(g for g in GATED_KERNELS
                               if g.name == k.name + "_gated") for k in kerns)
        elif kernel_mode == "column":
            kerns = tuple(next(c for c in COLUMN_KERNELS
                               if c.name == k.name + "_column")
                          for k in kerns)
        self.kernel_mode = kernel_mode
        self.kernels = kerns
        (self._xh, self._gradh, self._iad, self._av,
         self._mom) = kerns

    def base_rows(self, layout: CMLayout, x, y, z, h):
        """The 5 base rows shared by all stages. Invalid slots get
        FILL_POS positions and gid -1."""
        xcm, ycm, zcm = positions_cm(layout, x, y, z)
        fillv = torch.where(layout.valid, 0.0, FILL_POS).to(torch.float32)
        hcm = to_cm(layout, h, fill=1.0)
        gid = torch.where(layout.valid, layout.src.to(torch.float32), -1.0)
        return [xcm + fillv, ycm + fillv, zcm + fillv, hcm, gid]

    def _run(self, kern: PairKernel, rows, i2_rows=None, gate=None):
        I2 = None if i2_rows is None else torch.stack(i2_rows)
        if gate is not None:
            act, prevs = gate
            prevs = list(prevs)[:kern.fo]
            prevs += [torch.zeros_like(act)] * (kern.fo - len(prevs))
            gate = (act, torch.stack(prevs))
        return kern(torch.stack(rows), I2, self.grid, self.cfg, gate,
                    self.zgroup)

    def xmass_h(self, base, m_cm, gate=None):
        """Fused nc/h-iteration/xmass. Returns (xm, h, nc, nonconv)."""
        out = self._run(self._xh, base + [m_cm], gate=gate)
        return out[0], out[1], out[2], out[3]

    def gradh(self, base, m_cm, xm_cm, gate=None):
        out = self._run(self._gradh, base + [m_cm, xm_cm], gate=gate)
        return out[0], out[1]

    def iad_divv(self, base, kx_cm, xm_cm, vx_cm, vy_cm, vz_cm, gate=None):
        out = self._run(self._iad, base + [kx_cm, xm_cm, vx_cm, vy_cm,
                                           vz_cm], gate=gate)
        cij = tuple(out[i] for i in range(6))
        gradv = tuple(out[8 + i] for i in range(6))
        return cij, out[6], out[7], gradv

    def av_switches(self, base, c_cm, kx_cm, xm_cm, divv_cm, vx_cm, vy_cm,
                    vz_cm, cij, alpha_cm, dt, gate=None):
        dt_row = dt.to(alpha_cm.dtype).expand_as(alpha_cm)
        out = self._run(self._av, base + [c_cm, kx_cm, xm_cm, divv_cm, vx_cm,
                                          vy_cm, vz_cm],
                        list(cij) + [alpha_cm, dt_row], gate=gate)
        return out[0]

    def momentum(self, base, vx_cm, vy_cm, vz_cm, c_cm, prho_cm, rho_cm,
                 xm_cm, alpha_cm, m_cm, cij, gradv=None, eta_crit_cm=None,
                 gate=None):
        """Under av_clean the six gradv rows and eta_crit follow cij
        (PallasVE.momentum's row order); otherwise they are not read."""
        rows = base + [vx_cm, vy_cm, vz_cm, c_cm, prho_cm, rho_cm, xm_cm,
                       alpha_cm, m_cm] + list(cij)
        if self.cfg.av_clean:
            if gradv is None or eta_crit_cm is None:
                raise ValueError("av_clean: momentum needs gradv and "
                                 "eta_crit_cm")
            rows += list(gradv) + [eta_crit_cm]
        out = self._run(self._mom, rows, gate=gate)
        return out[0], out[1], out[2], out[3], out[4]
