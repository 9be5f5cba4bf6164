"""Dense, level-synchronous Fast Multipole gravity on one device.

Counterpart of the single-device part of sphexa_tpu/gravity/fmm.py (the
Ryoanji-equivalent solver; reference: ryoanji/src/ryoanji/nbody/
traversal.cuh, upsweep_cpu.hpp:71, cartesian_qpole.hpp:176), in plain
PyTorch:

  P2M   raw moments (m, m x, m x x, m x x x) summed per leaf cell
        (index_add_), in box-centered coordinates
  M2M   2x2x2 reshape-sums up the level hierarchy (raw moments add)
  M2L   for each child parity, a strided 3D convolution (F.conv3d) of
        the centered source moments (20 channels, through octupole) with
        the parity's masked M2L tensor, giving local Taylor coefficients
        (20 channels, through third order)
  L2L   parity-dependent expansion shifts broadcast down the hierarchy
  L2P   per-particle evaluation of the leaf local expansion
  P2P   direct sum over the (2 min_sep - 1)^3 leaf-cell near field

The box must be cubic (open boundaries); periodic boxes take
gravity/ewald.py.

The sharded solvers (JAX fmm.py:653-943) run inside SlabMesh.run and
take the shard's ShardComm where the JAX functions take the axis name:
every shard P2Ms its own particles, one psum of the dense leaf moment
grid makes the global multipoles, every shard runs the downsweep and
evaluates its own rows; the near field comes from the neighbours' band
rows, the +-rings bands along one axis (fmm_gravity_sharded, slab
domains) or the occupancy-dilated surface bands of every shard
(fmm_gravity_sharded_generic, any domain shape). The psum adds the
shards in order 0..D-1; XLA may add them in another order, so the
sharded fields agree with the JAX package's to float32 rounding, and
the counters (nf_truncated, the band overflow) exactly.

M2L runs in float32: TF32 is switched off around the convolutions
(cuDNN would otherwise round their operands to TF32 on the card)."""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from sphexa_tpu_torch.gravity.direct import chunk_rows, inv_r_masked

# moment channels: [M0, Mx, My, Mz, Sxx, Sxy, Sxz, Syy, Syz, Szz,
#                    Txxx, Txxy, Txxz, Txyy, Txyz, Txzz, Tyyy, Tyyz,
#                    Tyzz, Tzzz] (20, raw/central cartesian)
# local channels:   [L0, Lx, Ly, Lz, Hxx, Hxy, Hxz, Hyy, Hyz, Hzz,
#                    the 10 third-order coefficients C]
_SYM = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
_SYM3 = [(0, 0, 0), (0, 0, 1), (0, 0, 2), (0, 1, 1), (0, 1, 2),
         (0, 2, 2), (1, 1, 1), (1, 1, 2), (1, 2, 2), (2, 2, 2)]
# multinomial multiplicity of each symmetric 3rd-moment slot
_MULT3 = [1, 3, 3, 3, 6, 3, 1, 3, 3, 1]
NCH_M = 20   # source moment channels (through octupole)
NCH_L = 20   # local channels (through 3rd-order Taylor: L0, L1, H, C)


@dataclasses.dataclass(frozen=True)
class FmmConfig:
    level: int = 4        # leaf cells per dim = 2^level
    leaf_cap: int = 128   # max particles per leaf for the P2P pass
    min_sep: int = 3      # well-separateness |d| >= min_sep at every
                          # level; the near field is (2 min_sep - 1)^3
                          # leaf cells


# --------------------------------------------------------------------------
# M2L kernel tensors (numpy float64, built once per min_sep)
# --------------------------------------------------------------------------

def _derivative_tensors_batch(R):
    """D0..D5 derivative tensors of 1/|R| over a batch of separations
    R: [K, 3] -> D0 [K], D1 [K,3], ... D5 [K,3,3,3,3,3] (float64).
    Closed forms: D_k = (-1)^k (2k-1)!! R^{(k)}/r^{2k+1} + delta
    contraction terms."""
    K = R.shape[0]
    r2 = np.einsum("ka,ka->k", R, R)
    r = np.sqrt(r2)
    d = np.eye(3)
    ir = {k: r ** (-k) for k in (1, 3, 5, 7, 9, 11)}
    D0 = ir[1]
    D1 = -R * ir[3][:, None]
    D2 = (3.0 * R[:, :, None] * R[:, None, :]
          - r2[:, None, None] * d[None]) * ir[5][:, None, None]
    D3 = np.zeros((K, 3, 3, 3))
    for a in range(3):
        for b in range(3):
            for c in range(3):
                D3[:, a, b, c] = (
                    -15.0 * R[:, a] * R[:, b] * R[:, c] * ir[7]
                    + 3.0 * (d[a, b] * R[:, c] + d[a, c] * R[:, b]
                             + d[b, c] * R[:, a]) * ir[5])
    D4 = np.zeros((K, 3, 3, 3, 3))
    for a in range(3):
        for b in range(3):
            for c in range(3):
                for e in range(3):
                    pair_rr = (d[a, b] * R[:, c] * R[:, e]
                               + d[a, c] * R[:, b] * R[:, e]
                               + d[a, e] * R[:, b] * R[:, c]
                               + d[b, c] * R[:, a] * R[:, e]
                               + d[b, e] * R[:, a] * R[:, c]
                               + d[c, e] * R[:, a] * R[:, b])
                    pair_dd = (d[a, b] * d[c, e] + d[a, c] * d[b, e]
                               + d[a, e] * d[b, c])
                    D4[:, a, b, c, e] = (
                        105.0 * R[:, a] * R[:, b] * R[:, c] * R[:, e] * ir[9]
                        - 15.0 * pair_rr * ir[7] + 3.0 * pair_dd * ir[5])
    D5 = np.zeros((K, 3, 3, 3, 3, 3))
    for idx in itertools.product(range(3), repeat=5):
        v = -945.0 * R[:, idx[0]] * R[:, idx[1]] * R[:, idx[2]] \
            * R[:, idx[3]] * R[:, idx[4]] * ir[11]
        for (p, q) in itertools.combinations(range(5), 2):
            rest = [idx[k] for k in range(5) if k not in (p, q)]
            v = v + 105.0 * d[idx[p], idx[q]] \
                * R[:, rest[0]] * R[:, rest[1]] * R[:, rest[2]] * ir[9]
        for (p, q) in itertools.combinations(range(5), 2):
            others = [k for k in range(5) if k not in (p, q)]
            for (u, w) in itertools.combinations(others, 2):
                rest = [k for k in others if k not in (u, w)]
                v = v - 15.0 * d[idx[p], idx[q]] * d[idx[u], idx[w]] \
                    * R[:, idx[rest[0]]] * ir[7]
        D5[:, idx[0], idx[1], idx[2], idx[3], idx[4]] = v
    return D0, D1, D2, D3, D4, D5


def _derivative_tensors(R):
    """D0..D5 of 1/|R| at one separation R: [3] (float64)."""
    return tuple(D[0] for D in _derivative_tensors_batch(
        np.asarray(R, np.float64)[None]))


def _m2l_matrix_batch(R):
    """[K, NCH_L, NCH_M]: centered source moments (through octupole) ->
    local Taylor coefficients of Phi = -G sum m / |x - y| (G applied
    later) at each separation R[k]. Weights 1/2 on second moments, 1/6
    on third, with multinomial multiplicities for the symmetric
    storage."""
    D0, D1, D2, D3, D4, D5 = _derivative_tensors_batch(R)
    K = np.zeros((R.shape[0], NCH_L, NCH_M))

    def w2(a, b):
        return 0.5 if a == b else 1.0   # 1/2 * multiplicity(2)

    # L0 = -(M0 D0 + M1.D1 + 1/2 M2:D2 + 1/6 M3:.D3)
    K[:, 0, 0] = -D0
    for a in range(3):
        K[:, 0, 1 + a] = -D1[:, a]
    for ch, (a, b) in enumerate(_SYM):
        K[:, 0, 4 + ch] = -w2(a, b) * D2[:, a, b]
    for ch, (a, b, c) in enumerate(_SYM3):
        K[:, 0, 10 + ch] = -(_MULT3[ch] / 6.0) * D3[:, a, b, c]

    # L1_a = -(M0 D1_a + M1_b D2_ab + 1/2 M2_bc D3_abc + 1/6 M3 D4)
    for a in range(3):
        K[:, 1 + a, 0] = -D1[:, a]
        for b in range(3):
            K[:, 1 + a, 1 + b] = -D2[:, a, b]
        for ch, (b, c) in enumerate(_SYM):
            K[:, 1 + a, 4 + ch] = -w2(b, c) * D3[:, a, b, c]
        for ch, (b, c, e) in enumerate(_SYM3):
            K[:, 1 + a, 10 + ch] = -(_MULT3[ch] / 6.0) * D4[:, a, b, c, e]

    # H_ab = -(M0 D2_ab + M1_c D3_abc + 1/2 M2_ce D4_abce + 1/6 M3 D5)
    for ch, (a, b) in enumerate(_SYM):
        K[:, 4 + ch, 0] = -D2[:, a, b]
        for c in range(3):
            K[:, 4 + ch, 1 + c] = -D3[:, a, b, c]
        for ch2, (c, e) in enumerate(_SYM):
            K[:, 4 + ch, 4 + ch2] = -w2(c, e) * D4[:, a, b, c, e]
        for ch3, (c, e, f) in enumerate(_SYM3):
            K[:, 4 + ch, 10 + ch3] = -(_MULT3[ch3] / 6.0) * D5[:, a, b, c, e, f]

    # C_abc = -(M0 D3_abc + M1_e D4_abce + 1/2 M2_ef D5_abcef); M3 x D6
    # is beyond the scheme's O((a/d)^4) truncation
    for ch, (a, b, c) in enumerate(_SYM3):
        K[:, 10 + ch, 0] = -D3[:, a, b, c]
        for e in range(3):
            K[:, 10 + ch, 1 + e] = -D4[:, a, b, c, e]
        for ch2, (e, f) in enumerate(_SYM):
            K[:, 10 + ch, 4 + ch2] = -w2(e, f) * D5[:, a, b, c, e, f]

    # 1/|R + r - y'| expands in (r - y')^k: source displacements enter
    # with (-1)^j, so odd source moments flip sign
    K[:, :, 1:4] *= -1.0
    K[:, :, 10:] *= -1.0
    return K


def _m2l_matrix(R):
    """[NCH_L, NCH_M] M2L matrix at one separation R: [3]."""
    return _m2l_matrix_batch(np.asarray(R, np.float64)[None])[0]


def _parity_offsets_exact(p, min_sep: int = 2):
    """Interaction-list offsets for child parity p = (px, py, pz): cells
    d with max|d| >= min_sep whose parent pair was not well separated
    (|parent offset| <= min_sep - 1). The parent offset of a coordinate
    of parity pp is floor((pp + d)/2) - floor(pp/2)."""
    D = 2 * min_sep - 1
    po_max = min_sep - 1
    offs = []
    for dx in range(-D, D + 1):
        for dy in range(-D, D + 1):
            for dz in range(-D, D + 1):
                if max(abs(dx), abs(dy), abs(dz)) < min_sep:
                    continue
                ok = True
                for d, pp in ((dx, p[0]), (dy, p[1]), (dz, p[2])):
                    po = (pp + d) // 2 - pp // 2
                    if po < -po_max or po > po_max:
                        ok = False
                        break
                if ok:
                    offs.append((dx, dy, dz))
    return offs


# channel polynomial orders: M0 | M1 (x3) | M2 (x6) | M3 (x10)
_CH_ORDER = np.array([0] + [1] * 3 + [2] * 6 + [3] * 10)


@functools.lru_cache(maxsize=None)
def _unit_kernel_stack(min_sep: int = 2):
    """The full-offset-grid M2L tensor at unit cell size,
    [NCH_L, NCH_M, S, S, S] with S = 4 min_sep - 1, and the eight
    parity tap masks [S, S, S] (bool). The value at offset d does not
    depend on the parity; the parity only selects taps."""
    D = 2 * min_sep - 1
    S = 2 * D + 1
    offs = [(dx, dy, dz)
            for dx in range(-D, D + 1)
            for dy in range(-D, D + 1)
            for dz in range(-D, D + 1)
            if max(abs(dx), abs(dy), abs(dz)) >= min_sep]
    # R = target_center - source_center = -d (unit cell size)
    R = -np.asarray(offs, np.float64)
    Kmat = _m2l_matrix_batch(R)
    full = np.zeros((NCH_L, NCH_M, S, S, S))
    for k, (dx, dy, dz) in enumerate(offs):
        full[:, :, dx + D, dy + D, dz + D] = Kmat[k]
    masks = {}
    for px in (0, 1):
        for py in (0, 1):
            for pz in (0, 1):
                m = np.zeros((S, S, S), bool)
                for (dx, dy, dz) in _parity_offsets_exact((px, py, pz),
                                                          min_sep):
                    m[dx + D, dy + D, dz + D] = True
                masks[(px, py, pz)] = m
    return full, masks


_M2L_DEVICE_CACHE: dict = {}
_CONSTS: dict = {}


def _device_const(key, build, device):
    """A float32 tensor built from numpy once per (key, device): the
    per-level tables stay on the device between calls."""
    k = (key, torch.device(device))
    hit = _CONSTS.get(k)
    if hit is None:
        hit = _CONSTS[k] = torch.from_numpy(
            np.ascontiguousarray(build(), dtype=np.float32)).to(device)
    return hit


def _unit_kernel_device(min_sep: int, device):
    """(unit tensor, {parity: float32 mask}) on `device`, cached per
    (min_sep, device). Each level's kernel is unit * cs^-(j + l + 1)
    (D_k is homogeneous) times the parity's mask."""
    key = (int(min_sep), torch.device(device))
    hit = _M2L_DEVICE_CACHE.get(key)
    if hit is None:
        full, masks = _unit_kernel_stack(int(min_sep))
        unit = torch.from_numpy(full.astype(np.float32)).to(device)
        pmasks = {p: torch.from_numpy(m.astype(np.float32)).to(device)
                  for p, m in masks.items()}
        hit = _M2L_DEVICE_CACHE[key] = (unit, pmasks)
    return hit


@contextlib.contextmanager
def _float32_conv():
    """cuDNN convolutions in float32 (no TF32) inside the block."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


# --------------------------------------------------------------------------
# solver
# --------------------------------------------------------------------------

class FmmGravity(NamedTuple):
    ax: torch.Tensor
    ay: torch.Tensor
    az: torch.Tensor
    pot: torch.Tensor
    # particle slots beyond leaf_cap in any leaf: the P2P candidate
    # gather clamps per-cell counts, so a nonzero value means dropped
    # near-field pairs (a fail-stop, like cell-capacity overflow)
    nf_truncated: torch.Tensor = 0


def _leaf_binning(fc: FmmConfig, box, x, y, z, alive):
    """Leaf cell id of each particle on the 2^level grid; n^3 for dead
    particles."""
    n = 1 << fc.level

    def g(v, lo, ln):
        return torch.clamp(((v - lo) / ln * n).to(torch.int32), 0, n - 1)

    cid = ((g(x, box.xmin, box.lx) * n + g(y, box.ymin, box.ly)) * n
           + g(z, box.zmin, box.lz))
    if alive is not None:
        cid = torch.where(alive, cid, torch.full_like(cid, n ** 3))
    return cid


def _box_centered(box, x, y, z):
    bcx = 0.5 * (box.xmin + box.xmax)
    bcy = 0.5 * (box.ymin + box.ymax)
    bcz = 0.5 * (box.zmin + box.zmax)
    return (x - bcx, y - bcy, z - bcz)


def _raw_leaf_moments(co, mm, cid, n: int):
    """P2M: raw moments per leaf, [NCH_M, n, n, n]. One index_add_ of
    the [N, 20] per-particle moments; dead particles (cid n^3) land in
    a spare row. On the card the adds are atomic, in no fixed order."""
    n_leaf = n ** 3
    cols = [mm]
    cols += [mm * co[a] for a in range(3)]
    cols += [mm * co[a] * co[b] for (a, b) in _SYM]
    cols += [mm * co[a] * co[b] * co[c] for (a, b, c) in _SYM3]
    vals = torch.stack(cols, 1)
    acc = torch.zeros((n_leaf + 1, NCH_M), dtype=vals.dtype,
                      device=vals.device)
    acc.index_add_(0, cid.to(torch.int64), vals)
    return acc[:n_leaf].t().reshape(NCH_M, n, n, n)


def fmm_gravity(x, y, z, m, alive, box, G: float,
                fc: FmmConfig = FmmConfig(), eps: float = 0.0) -> FmmGravity:
    """Accelerations and potential. The box must be cubic (open)."""
    n = 1 << fc.level
    mm = torch.where(alive, m, torch.zeros_like(m)) if alive is not None \
        else m
    cid = _leaf_binning(fc, box, x, y, z, alive)
    # box-centered coordinates: raw third moments grow like the cube of
    # the coordinate scale, so centering buys float32 headroom in the
    # raw -> central cancellation
    co = _box_centered(box, x, y, z)
    mom = _raw_leaf_moments(co, mm, cid, n)
    local = _far_field(mom, box, fc)
    pot_far, ax_far, ay_far, az_far = _l2p(local, co, cid, box, fc)

    ax_nf, ay_nf, az_nf, pot_nf, nf_trunc = _p2p(
        x, y, z, mm, cid, n, fc.leaf_cap, eps, reach=fc.min_sep - 1)

    return FmmGravity(G * (ax_far + ax_nf), G * (ay_far + ay_nf),
                      G * (az_far + az_nf), G * (pot_far + pot_nf),
                      nf_truncated=nf_trunc)


def _centers(box, level: int, device):
    """Cell centers of a level in box-centered coordinates, float32
    [s, s, s] each."""
    def build():
        s = 1 << level
        g = [(np.arange(s) + 0.5) * box.lx / s - box.lx / 2,
             (np.arange(s) + 0.5) * box.ly / s - box.ly / 2,
             (np.arange(s) + 0.5) * box.lz / s - box.lz / 2]
        return np.stack(np.meshgrid(g[0], g[1], g[2], indexing="ij"))

    return tuple(_device_const(("centers", box, level), build, device))


_I2 = {p: 4 + i for i, p in enumerate(_SYM)}


def _i2(a, b):
    return _I2[tuple(sorted((a, b)))]


def _center_moments(raw, box, level: int):
    """Raw moments -> moments centered on each cell's center."""
    cc = _centers(box, level, raw.device)
    M0 = raw[0]
    out = [M0]
    for a in range(3):
        out.append(raw[1 + a] - M0 * cc[a])
    for (a, b) in _SYM:
        out.append(raw[_i2(a, b)] - cc[a] * raw[1 + b]
                   - cc[b] * raw[1 + a] + M0 * cc[a] * cc[b])
    for ch, (a, b, c) in enumerate(_SYM3):
        out.append(raw[10 + ch]
                   - cc[c] * raw[_i2(a, b)] - cc[b] * raw[_i2(a, c)]
                   - cc[a] * raw[_i2(b, c)]
                   + cc[b] * cc[c] * raw[1 + a]
                   + cc[a] * cc[c] * raw[1 + b]
                   + cc[a] * cc[b] * raw[1 + c]
                   - cc[a] * cc[b] * cc[c] * M0)
    return torch.stack(out)


def _m2m(mom, fc: FmmConfig):
    """M2M upsweep: {level: raw moments [NCH_M, s, s, s]} from the leaf
    level up to level 2 (raw moments add under 2x2x2 aggregation)."""
    raw_levels = {fc.level: mom}
    for lvl in range(fc.level - 1, 1, -1):
        h = 1 << lvl
        prev = raw_levels[lvl + 1].reshape(NCH_M, h, 2, h, 2, h, 2)
        raw_levels[lvl] = prev.sum(dim=(2, 4, 6))
    return raw_levels


def _m2l(raw, box, fc: FmmConfig, lvl: int):
    """M2L at one level as eight parity-strided convolutions: raw
    moments [NCH_M, s, s, s] -> local coefficients [NCH_L, s, s, s]."""
    s = 1 << lvl
    cs = box.lx / s
    cm = _center_moments(raw, box, lvl)
    unit, pmasks = _unit_kernel_device(fc.min_sep, raw.device)
    lvl_scale = _device_const(
        ("scale", float(cs)),
        lambda: float(cs) ** (-(_CH_ORDER[:, None] + _CH_ORDER[None, :] + 1)
                              .astype(np.float64)), raw.device)
    Klvl = unit * lvl_scale[:, :, None, None, None]
    H = 2 * fc.min_sep - 1   # kernel half-width
    contrib = torch.zeros((NCH_L, s, s, s), dtype=raw.dtype,
                          device=raw.device)
    src = cm[None]
    with _float32_conv():
        for (px, py, pz), pm in pmasks.items():
            K = Klvl * pm[None, None]
            # the TPU conv's asymmetric padding (H - p, H - 1 + p), then
            # a stride-2 cross-correlation: s/2 outputs a dimension
            padded = F.pad(src, (H - pz, H - 1 + pz, H - py, H - 1 + py,
                                 H - px, H - 1 + px))
            out = F.conv3d(padded, K, stride=2)
            contrib[:, px::2, py::2, pz::2] += out[0]
    return contrib


def _l2l(local, box, lvl: int):
    """Shift each parent's local expansion to its eight children's
    centers: [NCH_L, s, s, s] -> [NCH_L, 2s, 2s, 2s]."""
    s = 1 << lvl
    child_cs = box.lx / s / 2.0
    up = local.repeat_interleave(2, 1).repeat_interleave(2, 2) \
        .repeat_interleave(2, 3)
    # b = child_center - parent_center, by the child's parity
    bvals = np.array([-0.5, 0.5]) * child_cs
    bl = _device_const(("shift", float(child_cs), 2 * s),
                       lambda: np.where(np.arange(2 * s) % 2 == 0, bvals[0],
                                        bvals[1]), local.device)
    b3 = (bl[:, None, None], bl[None, :, None], bl[None, None, :])

    def csym(a_, b_, c_):
        return up[10 + _SYM3.index(tuple(sorted((a_, b_, c_))))]

    def hsym(a_, b_):
        return up[4 + _SYM.index(tuple(sorted((a_, b_))))]

    # L0 <- L0 + L.b + 1/2 b.H.b + 1/6 C:bbb
    L0n = up[0]
    for a_ in range(3):
        L0n = L0n + up[1 + a_] * b3[a_]
    for a_ in range(3):
        for b_ in range(3):
            L0n = L0n + 0.5 * hsym(a_, b_) * b3[a_] * b3[b_]
            for c_ in range(3):
                L0n = L0n + (1.0 / 6.0) * csym(a_, b_, c_) \
                    * b3[a_] * b3[b_] * b3[c_]
    # L1_a <- L1_a + H_ab b_b + 1/2 C_abc b_b b_c
    L1n = []
    for a_ in range(3):
        v = up[1 + a_]
        for b_ in range(3):
            v = v + hsym(a_, b_) * b3[b_]
            for c_ in range(3):
                v = v + 0.5 * csym(a_, b_, c_) * b3[b_] * b3[c_]
        L1n.append(v)
    # H_ab <- H_ab + C_abc b_c ; C unchanged
    Hn = []
    for (a_, b_) in _SYM:
        v = hsym(a_, b_)
        for c_ in range(3):
            v = v + csym(a_, b_, c_) * b3[c_]
        Hn.append(v)
    return torch.stack([L0n] + L1n + Hn + [up[10 + k] for k in range(10)])


def _far_field(mom, box, fc: FmmConfig):
    """M2M upsweep, then M2L and L2L level by level: leaf raw moments
    [NCH_M, n, n, n] -> leaf local expansions [NCH_L, n, n, n]."""
    raw_levels = _m2m(mom, fc)
    local = None
    for lvl in range(2, fc.level + 1):
        contrib = _m2l(raw_levels[lvl], box, fc, lvl)
        local = contrib if local is None else local + contrib
        if lvl < fc.level:
            local = _l2l(local, box, lvl)
    return local


def _l2p(local, co, cid, box, fc: FmmConfig):
    """Evaluate the leaf local expansion at particle positions."""
    n = 1 << fc.level
    n_leaf = n ** 3
    lflat = local.reshape(NCH_L, n_leaf)
    c = torch.clamp_max(cid, n_leaf - 1).to(torch.int64)
    cxl, cyl, czl = _centers(box, fc.level, local.device)
    Lp = lflat[:, c]
    rx = co[0] - cxl.reshape(n_leaf)[c]
    ry = co[1] - cyl.reshape(n_leaf)[c]
    rz = co[2] - czl.reshape(n_leaf)[c]
    rr = (rx, ry, rz)

    def lC(a_, b_, c_):
        return Lp[10 + _SYM3.index(tuple(sorted((a_, b_, c_))))]

    def lH(a_, b_):
        return Lp[4 + _SYM.index(tuple(sorted((a_, b_))))]

    pot_far = (Lp[0] + Lp[1] * rx + Lp[2] * ry + Lp[3] * rz
               + 0.5 * (Lp[4] * rx * rx + Lp[7] * ry * ry + Lp[9] * rz * rz)
               + Lp[5] * rx * ry + Lp[6] * rx * rz + Lp[8] * ry * rz)
    for ch, (a_, b_, c_) in enumerate(_SYM3):
        pot_far = pot_far + (_MULT3[ch] / 6.0) * Lp[10 + ch] \
            * rr[a_] * rr[b_] * rr[c_]

    acc_far = []
    for a_ in range(3):
        g = Lp[1 + a_]
        for b_ in range(3):
            g = g + lH(a_, b_) * rr[b_]
            for c_ in range(3):
                g = g + 0.5 * lC(a_, b_, c_) * rr[b_] * rr[c_]
        acc_far.append(-g)
    ax_far, ay_far, az_far = acc_far
    return pot_far, ax_far, ay_far, az_far


# the sharded far field psums a dense [NCH_M, 8^level] float32 stack
# (level 6: 20 MB, level 7: 160 MB); past this budget it refuses
MOMENT_PSUM_BYTE_CAP = 64 << 20


def moment_grid_bytes(level: int) -> int:
    """Bytes of the dense [NCH_M, 8^level] float32 leaf moment grid
    (what the sharded far field psums per shard)."""
    return NCH_M * (8 ** level) * 4


def _check_psum_budget(fc: FmmConfig):
    b = moment_grid_bytes(fc.level)
    if b > MOMENT_PSUM_BYTE_CAP:
        raise ValueError(
            f"sharded FMM level {fc.level} psums {b / 2**20:.0f} MB of "
            f"dense moments per rank (> {MOMENT_PSUM_BYTE_CAP / 2**20:.0f}"
            " MB cap); the dense moment-grid design stops paying past "
            "level 6: shard the grid or lower the level")


def min_level_for_bands(n_ranks: int, extent_frac: float = 1.0,
                        min_sep: int = 3) -> int:
    """Smallest FMM level whose near-field reach (min_sep - 1 leaf
    cells) fits inside one rank's slab, so the sharded P2P needs only
    the +-1 neighbour bands: n >= (min_sep - 1) * n_ranks / extent_frac."""
    need = (min_sep - 1) * n_ranks / max(extent_frac, 1e-9)
    return max(2, int(np.ceil(np.log2(need))))


def _far_and_cells(comm, x, y, z, mm, alive, box, fc: FmmConfig):
    """The sharded far field: this shard's P2M, one psum of the moment
    grid, the downsweep and the L2P of this shard's rows. Every shard
    holds the same psum'd grid, so shard 0 runs the downsweep once and
    hands its local expansions to the others (the JAX package runs it on
    every rank: the same values, D times the launches)."""
    n = 1 << fc.level
    cid = _leaf_binning(fc, box, x, y, z, alive)
    co = _box_centered(box, x, y, z)
    mom = comm.psum(_raw_leaf_moments(co, mm, cid, n))
    local = comm._move(comm.exchange(
        _far_field(mom, box, fc) if comm.me == 0 else None)[0])
    return cid, _l2p(local, co, cid, box, fc)


def _compact(mask, band_cap: int):
    """The JAX package's band compaction: the first band_cap rows of a
    stable sort that puts the masked rows first. Returns (idx, sel,
    overflow)."""
    order = torch.argsort(torch.where(mask, 0, 1).to(torch.int32),
                          stable=True)
    cnt = torch.sum(mask, dtype=torch.int32)
    idx = order[:band_cap]
    sel = (torch.arange(band_cap, device=mask.device)
           < torch.clamp_max(cnt, band_cap))
    return idx, sel, torch.clamp_min(cnt - band_cap, 0)


def fmm_gravity_sharded(comm, x, y, z, m, alive, box, G: float,
                        fc: FmmConfig, eps: float, dim: int = 2,
                        band_cap: int = 0, rings: int = 1):
    """The sharded FMM of a 1-D spatial decomposition along `dim`
    (z-slabs), inside SlabMesh.run (JAX fmm.py:679). Far field: the
    psum'd moment grid. Near field: each shard's rows within the P2P
    reach (min_sep - 1 leaf cells) of its occupied extent's two edges,
    compacted to band_cap slots, go to the shards +-1 .. +-rings away
    (one rendezvous). A rank within reach but more than `rings` hops
    away counts into the band overflow (the ring-coverage fail-stop),
    as do band rows past band_cap.

    Returns (ax, ay, az, pot, nf_truncated, band_overflow) for the
    local rows; the two counters are psum'd and must stay 0."""
    _check_psum_budget(fc)
    me, n_ranks = comm.me, comm.n
    cap = x.shape[0]
    if band_cap <= 0:
        band_cap = cap
    n = 1 << fc.level
    dev = x.device
    mm = torch.where(alive, m, 0.0)
    cid, (pot_far, ax_far, ay_far, az_far) = _far_and_cells(
        comm, x, y, z, mm, alive, box, fc)

    reach = fc.min_sep - 1
    coord = (x, y, z)[dim]
    lo_b = (box.xmin, box.ymin, box.zmin)[dim]
    ln_b = (box.lx, box.ly, box.lz)[dim]
    leaf_d = torch.clamp(((coord - lo_b) / ln_b * n).to(torch.int32),
                         0, n - 1)
    lo = torch.min(torch.where(alive, leaf_d, 2 * n))
    hi = torch.max(torch.where(alive, leaf_d, -1))

    def band(mask):
        idx, sel, ovf = _compact(mask, band_cap)
        return (x[idx], y[idx], z[idx], mm[idx], sel), ovf

    # everything within `reach` cells of my occupied extent's edges: the
    # extents are ordered along dim, so one band serves every hop
    down, ovf_d = band(alive & (leaf_d <= lo + reach))
    up, ovf_u = band(alive & (leaf_d >= hi - reach))
    band_overflow = ovf_d + ovf_u

    lo_all, hi_all = comm.all_gather((lo, hi))
    ranks = torch.arange(n_ranks, device=dev)
    needs = (hi_all >= lo - reach) & (lo_all <= hi + reach)
    band_overflow = band_overflow + torch.sum(
        needs & (torch.abs(ranks - me) > rings) & (hi_all >= lo_all),
        dtype=torch.int32)

    # the 2 * rings ppermutes in one rendezvous: from rank me - j its up
    # band, from rank me + j its down band; with open ends the
    # wrap-around bands are no neighbours
    vals = comm.exchange((up, down))
    recv = []
    for j in range(1, rings + 1):
        for src, which, edge in (((me - j) % n_ranks, 0, me < j),
                                 ((me + j) % n_ranks, 1,
                                  me >= n_ranks - j)):
            b = comm._move(vals[src][which])
            recv.append(b[:4] + (b[4] & (not edge),))

    ux = torch.cat([x] + [b[0] for b in recv])
    uy = torch.cat([y] + [b[1] for b in recv])
    uz = torch.cat([z] + [b[2] for b in recv])
    um = torch.cat([mm] + [torch.where(b[4], b[3], 0.0) for b in recv])
    ualive = torch.cat([alive] + [b[4] for b in recv])
    ucid = _leaf_binning(fc, box, ux, uy, uz, ualive)
    ax_nf, ay_nf, az_nf, pot_nf, nf_trunc = _p2p(
        ux, uy, uz, um, ucid, n, fc.leaf_cap, eps, reach=reach, n_out=cap)
    return (G * (ax_far + ax_nf[:cap]), G * (ay_far + ay_nf[:cap]),
            G * (az_far + az_nf[:cap]), G * (pot_far + pot_nf[:cap]),
            comm.psum(nf_trunc), comm.psum(band_overflow.to(torch.int32)))


def _dilate(occ, n: int, reach: int):
    """Max-pool dilation of an [n^3] 0/1 int32 grid by `reach` cells
    (Chebyshev): cell c is marked iff a marked cell lies within the
    (2 reach + 1)^3 window around c."""
    d = F.max_pool3d(occ.to(torch.float32).reshape(1, 1, n, n, n),
                     2 * reach + 1, stride=1, padding=reach)
    return d.reshape(n ** 3).to(torch.int32)


def _occupancy_dilated(cid, alive, n: int, reach: int):
    """[n^3] int32 occupancy of `cid` (0/1) and its dilation by `reach`
    cells (JAX fmm.py:800)."""
    n_leaf = n ** 3
    occ = torch.zeros(n_leaf + 1, dtype=torch.int32, device=cid.device)
    occ.index_add_(0, cid.to(torch.int64), alive.to(torch.int32))
    occ = torch.clamp_max(occ[:n_leaf], 1)
    return occ, _dilate(occ, n, reach)


def fmm_gravity_sharded_generic(comm, x, y, z, m, alive, box, G: float,
                                fc: FmmConfig, eps: float,
                                band_cap: int = 0):
    """The sharded FMM of any domain shape (Hilbert key ranges), inside
    SlabMesh.run (JAX fmm.py:815). Far field as fmm_gravity_sharded.
    Near field: the occupancy grid of the other shards (one psum of an
    [8^level] map), dilated by the P2P reach, marks this shard's rows
    some other shard needs; those rows, compacted to band_cap slots, go
    to every shard in one all_gather. Only cells within reach of this
    shard's own occupied cells count toward nf_truncated (remote band
    rows parked elsewhere may overflow leaf_cap harmlessly).

    Returns (ax, ay, az, pot, nf_truncated, band_overflow) for the local
    rows; the two counters are psum'd and must stay 0."""
    _check_psum_budget(fc)
    me, n_ranks = comm.me, comm.n
    cap = x.shape[0]
    if band_cap <= 0 or band_cap > cap:
        band_cap = cap   # a band can never exceed the local rows
    n = 1 << fc.level
    n_leaf = n ** 3
    dev = x.device
    mm = torch.where(alive, m, 0.0)
    cid, (pot_far, ax_far, ay_far, az_far) = _far_and_cells(
        comm, x, y, z, mm, alive, box, fc)

    reach = fc.min_sep - 1
    occ_me, dil_me = _occupancy_dilated(cid, alive, n, reach)
    occ_other = torch.clamp_max(comm.psum(occ_me) - occ_me, 1)
    dil_other = _dilate(occ_other, n, reach)
    cid_c = torch.clamp_max(cid, n_leaf - 1).to(torch.int64)
    idx, sel, band_overflow = _compact(alive & (dil_other[cid_c] > 0),
                                       band_cap)

    bx, by, bz, bm, bsel = comm.all_gather(
        (x[idx], y[idx], z[idx], torch.where(sel, mm[idx], 0.0), sel))
    # my own band rows are already in the local arrays
    bsel = bsel & (torch.arange(n_ranks, device=dev) != me)[:, None]
    ux = torch.cat([x, bx.reshape(-1)])
    uy = torch.cat([y, by.reshape(-1)])
    uz = torch.cat([z, bz.reshape(-1)])
    um = torch.cat([mm, torch.where(bsel, bm, 0.0).reshape(-1)])
    ualive = torch.cat([alive, bsel.reshape(-1)])
    ucid = _leaf_binning(fc, box, ux, uy, uz, ualive)
    ax_nf, ay_nf, az_nf, pot_nf, nf_trunc = _p2p(
        ux, uy, uz, um, ucid, n, fc.leaf_cap, eps, reach=reach,
        trunc_mask=dil_me > 0, n_out=cap)
    return (G * (ax_far + ax_nf[:cap]), G * (ay_far + ay_nf[:cap]),
            G * (az_far + az_nf[:cap]), G * (pot_far + pot_nf[:cap]),
            comm.psum(nf_trunc), comm.psum(band_overflow.to(torch.int32)))


def estimate_band_cap(rank_cells: list, level: int, min_sep: int = 3,
                      margin: float = 1.5, align: int = 128) -> int:
    """Host-side band_cap sizing from the measured band occupancy
    (numpy; JAX fmm.py:907). `rank_cells`: per rank, the leaf-cell ids
    of its particles at `level`. For each rank, counts its particles
    whose cell lies within the P2P reach of a cell another rank
    occupies; returns the largest, times `margin`, rounded up to
    `align`. The band-overflow fail-stop still guards drift past it."""
    n = 1 << level
    reach = min_sep - 1
    occ = np.zeros((len(rank_cells), n, n, n), bool)
    for r, cells in enumerate(rank_cells):
        c = np.asarray(cells)
        occ[r].reshape(-1)[np.unique(c[(c >= 0) & (c < n ** 3)])] = True
    worst = 0
    for r, cells in enumerate(rank_cells):
        other = occ[[i for i in range(len(occ)) if i != r]].any(0)
        dil = np.zeros_like(other)
        for dx in range(-reach, reach + 1):
            for dy in range(-reach, reach + 1):
                for dz in range(-reach, reach + 1):
                    src = other[
                        max(0, -dx):n - max(0, dx),
                        max(0, -dy):n - max(0, dy),
                        max(0, -dz):n - max(0, dz)]
                    dil[max(0, dx):n - max(0, -dx),
                        max(0, dy):n - max(0, -dy),
                        max(0, dz):n - max(0, -dz)] |= src
        c = np.asarray(cells)
        c = c[(c >= 0) & (c < n ** 3)]
        worst = max(worst, int(dil.reshape(-1)[c].sum()))
    cap = int(np.ceil(worst * margin / align) * align)
    return max(cap, align)


def _p2p(x, y, z, m, cid, n: int, cap: int, eps: float, chunk: int = 4096,
         reach: int = 1, trunc_mask=None, n_out=None):
    """Near-field direct sum: for each particle, all particles in the
    (2 reach + 1)^3 surrounding leaf cells (open boundaries: cells out
    of range are empty), at most `cap` from each. Returns (ax, ay, az,
    pot, nf_truncated): the last counts the particles beyond `cap` in
    any leaf, whose pairs the gather drops; `trunc_mask` ([n^3] bool)
    limits that count to the cells it marks. With `n_out` only the
    binned rows among the first n_out are summed (the sharded solvers'
    own rows; one host sync for their count), every other row gets 0;
    the sums of those rows are the same as without it."""
    N = x.shape[0]
    dev = x.device
    n_leaf = n ** 3
    cid = cid.to(torch.int64)
    order = torch.argsort(cid, stable=True)
    cs = cid[order]
    cell_start = torch.searchsorted(
        cs, torch.arange(n_leaf + 1, dtype=cs.dtype, device=dev))
    leaf_cnt = cell_start[1:] - cell_start[:-1]
    over = torch.clamp_min(leaf_cnt - cap, 0)
    if trunc_mask is not None:
        over = torch.where(trunc_mask, over, 0)
    nf_trunc = torch.sum(over).to(torch.int32)
    # a spare entry: the empty cell n^3 ends where it starts
    cell_end = torch.cat([cell_start[1:], cell_start[-1:]])
    xs, ys, zs, ms = x[order], y[order], z[order], m[order]

    rows, n_i = None, N
    if n_out is not None:
        rows = torch.nonzero((order < n_out) & (cs < n_leaf)).reshape(-1)
        n_i = rows.shape[0]
    C = min(chunk, max(n_i, 1))
    n_chunks = -(-n_i // C)
    rr = range(-reach, reach + 1)
    offs = _device_const(("offsets", reach),
                         lambda: [(dx, dy, dz) for dx in rr for dy in rr
                                  for dz in rr], dev).to(torch.int64)
    M = offs.shape[0] * cap
    eps2 = eps * eps
    lane = torch.arange(cap, dtype=torch.int64, device=dev)
    parts = []
    for c in range(n_chunks):
        i_idx = (chunk_rows(c, C, N, dev) if rows is None
                 else rows[c * C:(c + 1) * C])
        Ci = i_idx.shape[0]
        ci = cs[i_idx]
        g = torch.stack([ci // (n * n), (ci // n) % n, ci % n], 1)
        j = g[:, None, :] + offs[None]                       # [C, K, 3]
        ok = ((j >= 0) & (j < n)).all(2)
        ncid = torch.where(ok, (j[..., 0] * n + j[..., 1]) * n + j[..., 2],
                           n_leaf)
        st = cell_start[ncid]
        cnt = torch.where(ok, torch.clamp_max(cell_end[ncid] - st, cap), 0)

        cand = st[:, :, None] + lane
        valid = lane < cnt[:, :, None]
        cand = torch.where(valid, cand, 0).reshape(Ci, M)
        valid = valid.reshape(Ci, M) & (cand != i_idx[:, None])

        rx = xs[i_idx][:, None] - xs[cand]
        ry = ys[i_idx][:, None] - ys[cand]
        rz = zs[i_idx][:, None] - zs[cand]
        r2 = rx * rx + ry * ry + rz * rz + eps2
        inv_r = inv_r_masked(r2, valid)
        inv_r3 = inv_r ** 3
        mc = ms[cand]
        w = mc * inv_r3
        parts.append((-torch.sum(w * rx, 1), -torch.sum(w * ry, 1),
                      -torch.sum(w * rz, 1), -torch.sum(mc * inv_r, 1)))
    # results are in the sorted frame; scatter back to the input order
    out = []
    for i in range(4):
        if rows is None:
            v = torch.cat([p[i] for p in parts])[:N]
        else:
            v = x.new_zeros(N)
            if parts:
                v[rows] = torch.cat([p[i] for p in parts])
        back = torch.empty_like(v)
        back[order] = v
        out.append(back)
    return tuple(out) + (nf_trunc,)
