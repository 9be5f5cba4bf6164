"""The std-SPH force pipeline (density-based formulation) as batched
pair stages of the gather path.

Counterpart of sphexa_tpu/sph/hydro_std.py, formula by formula:
  - density          (reference: sph/include/sph/hydro_std/density.hpp:41)
  - IAD              (hydro_std/iad_kern.hpp:13: volume element m_j/rho_j)
  - momentum+energy  (hydro_std/momentum_energy_kern.hpp:14: constant AV
                      alpha = 1, grad-h terms = 1)

Each stage is a masked dense reduction over the [N, K] neighbour index
matrix (ops/pair.py), as in sph/hydro_ve.py. The JAX package has no
Pallas kernel for this formulation (plain XLA), so neither has the port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.ops.pair import PairChunk, run_pair_stage
from sphexa_tpu_torch.sfc.box import Box
from sphexa_tpu_torch.sph.kernels import (artificial_viscosity, kernel_3d_k,
                                          w_sinc)


def compute_density(box: Box, x, y, z, h, m, idx, nc, cfg: SphConfig):
    """rho_i = K h^-3 (m_i + sum_j W(v1) m_j)."""
    K3d = kernel_3d_k(cfg.sinc_index)

    def stage(pc: PairChunk):
        wv = w_sinc(pc.v1, cfg.sinc_index)
        rho0 = pc.gi(m) + pc.msum(wv * pc.gj(m))
        return K3d * rho0 / pc.hi ** 3

    return run_pair_stage(stage, box, x, y, z, h, idx, nc)


def compute_iad_std(box: Box, x, y, z, h, m, rho, idx, nc, cfg: SphConfig):
    """IAD cij with the volume element m_j / rho_j, the tau sums in
    h-scaled coordinates."""
    K3d = kernel_3d_k(cfg.sinc_index)

    def stage(pc: PairChunk):
        wv = w_sinc(pc.v1, cfg.sinc_index)
        volj = pc.gj(m) / pc.gj(rho)
        weight = torch.where(pc.mask, volj * wv, 0.0)

        hinv = 1.0 / pc.hi
        h3inv = hinv ** 3
        sx = pc.rx * hinv[:, None]
        sy = pc.ry * hinv[:, None]
        sz = pc.rz * hinv[:, None]
        wn = weight * (K3d * h3inv)[:, None]

        t11 = torch.sum(sx * sx * wn, dim=1)
        t12 = torch.sum(sx * sy * wn, dim=1)
        t13 = torch.sum(sx * sz * wn, dim=1)
        t22 = torch.sum(sy * sy * wn, dim=1)
        t23 = torch.sum(sy * sz * wn, dim=1)
        t33 = torch.sum(sz * sz * wn, dim=1)

        det = (t11 * t22 * t33 + 2.0 * t12 * t23 * t13
               - t11 * t23 ** 2 - t22 * t13 ** 2 - t33 * t12 ** 2)
        fac = 1.0 / (det * pc.hi ** 2)
        return (
            (t22 * t33 - t23 ** 2) * fac,
            (t13 * t23 - t33 * t12) * fac,
            (t12 * t23 - t22 * t13) * fac,
            (t11 * t33 - t13 ** 2) * fac,
            (t13 * t12 - t11 * t23) * fac,
            (t11 * t22 - t12 ** 2) * fac,
        )

    return run_pair_stage(stage, box, x, y, z, h, idx, nc)


class MomentumEnergyStd(NamedTuple):
    ax: torch.Tensor
    ay: torch.Tensor
    az: torch.Tensor
    du: torch.Tensor
    maxvsignal: torch.Tensor


def compute_momentum_energy_std(box: Box, x, y, z, vx, vy, vz, h, m, rho, p,
                                c, cij, idx, nc, cfg: SphConfig):
    """Momentum + energy with constant AV alpha = 1 and IAD gradients.

    Sign convention (momentum_energy_kern.hpp:126-133): termA is +cij r
    (no leading minus) and the i-j asymmetry sits in the final signs:
    du = -K/2 energy, accel = +K momentum."""
    K3d = kernel_3d_k(cfg.sinc_index)
    c11, c12, c13, c22, c23, c33 = cij

    def stage(pc: PairChunk):
        hi = pc.hi
        hj = pc.gj(h)
        v1 = pc.v1
        v2 = pc.dist / hj
        Wi = torch.where(pc.mask, w_sinc(v1, cfg.sinc_index)
                         / hi[:, None] ** 3, 0.0)
        Wj = torch.where(pc.mask, w_sinc(v2, cfg.sinc_index) / hj ** 3, 0.0)

        termA1_i = (pc.gi(c11)[:, None] * pc.rx + pc.gi(c12)[:, None] * pc.ry
                    + pc.gi(c13)[:, None] * pc.rz)
        termA2_i = (pc.gi(c12)[:, None] * pc.rx + pc.gi(c22)[:, None] * pc.ry
                    + pc.gi(c23)[:, None] * pc.rz)
        termA3_i = (pc.gi(c13)[:, None] * pc.rx + pc.gi(c23)[:, None] * pc.ry
                    + pc.gi(c33)[:, None] * pc.rz)
        termA1_j = pc.gj(c11) * pc.rx + pc.gj(c12) * pc.ry + pc.gj(c13) * pc.rz
        termA2_j = pc.gj(c12) * pc.rx + pc.gj(c22) * pc.ry + pc.gj(c23) * pc.rz
        termA3_j = pc.gj(c13) * pc.rx + pc.gj(c23) * pc.ry + pc.gj(c33) * pc.rz

        vx_ij = pc.gi(vx)[:, None] - pc.gj(vx)
        vy_ij = pc.gi(vy)[:, None] - pc.gj(vy)
        vz_ij = pc.gi(vz)[:, None] - pc.gj(vz)
        rv = pc.rx * vx_ij + pc.ry * vy_ij + pc.rz * vz_ij
        wij = rv / pc.safe_dist

        ci = pc.gi(c)[:, None]
        cj = pc.gj(c)
        visc = 0.5 * artificial_viscosity(1.0, 1.0, ci, cj, wij)
        visc = torch.where(pc.mask, visc, 0.0)

        vsig = torch.where(pc.mask, ci + cj - 3.0 * wij, 0.0)
        maxvsignal = torch.max(vsig, dim=1).values

        roi = pc.gi(rho)
        roj = pc.gj(rho)
        pri = pc.gi(p)
        mj = pc.gj(m)
        mi_roi = (pc.gi(m) / roi)[:, None]
        mj_roj_Wj = mj / roj * Wj
        mj_pro_i = mj * (pri / (roi * roi))[:, None]

        a_m = Wi * (mj_pro_i + visc * mi_roi)
        b_m = mj_roj_Wj * (pc.gj(p) / roj + visc)
        mom_x = pc.msum(a_m * termA1_i + b_m * termA1_j)
        mom_y = pc.msum(a_m * termA2_i + b_m * termA2_j)
        mom_z = pc.msum(a_m * termA3_i + b_m * termA3_j)

        a_e = Wi * (2.0 * mj_pro_i + visc * mi_roi)
        b_e = visc * mj_roj_Wj
        energy = pc.msum(vx_ij * (a_e * termA1_i + b_e * termA1_j)
                         + vy_ij * (a_e * termA2_i + b_e * termA2_j)
                         + vz_ij * (a_e * termA3_i + b_e * termA3_j))

        return MomentumEnergyStd(K3d * mom_x, K3d * mom_y, K3d * mom_z,
                                 -K3d * 0.5 * energy, maxvsignal)

    return run_pair_stage(stage, box, x, y, z, h, idx, nc)
