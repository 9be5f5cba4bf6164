"""The volume-element force pipeline as batched pair stages of the
gather path.

Counterpart of sphexa_tpu/sph/hydro_ve.py, formula by formula:
  - xmass           (reference: sph/include/sph/hydro_ve/xmass_kern.hpp:51)
  - ve_def_gradh    (ve_def_gradh_kern.hpp:44)
  - iad + divv/curlv fused (iad_kern.hpp:44 + divv_curlv_kern.hpp:44)
  - av_switches     (av_switches_kern.hpp:44)
  - momentum+energy (momentum_energy_kern.hpp:65)

Each stage is a masked dense reduction over the [N, K] neighbour index
matrix (ops/pair.py). The IAD tau sums run in h-scaled coordinates so
the 3x3 inverse stays O(1) in float32, as in the JAX package. The
stages follow the dtype of their inputs (the golden-value tests run
them in float64).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.ops.pair import PairChunk, run_pair_stage
from sphexa_tpu_torch.sfc.box import Box
from sphexa_tpu_torch.sph.kernels import (exp_pair, kernel_3d_k, w_sinc,
                                          w_sinc_derivative)
from sphexa_tpu_torch.util.fp import rdiv


def compute_xmass(box: Box, x, y, z, h, m, idx, nc, cfg: SphConfig):
    """Generalized volume element xm_i = m_i / (K h^-3 (m_i + sum_j W m_j))."""
    K3d = kernel_3d_k(cfg.sinc_index)

    def stage(pc: PairChunk):
        wv = w_sinc(pc.v1, cfg.sinc_index)
        rho0 = pc.gi(m) + pc.msum(wv * pc.gj(m))
        h3 = pc.hi ** 3
        return pc.gi(m) * h3 / (K3d * rho0)

    return run_pair_stage(stage, box, x, y, z, h, idx, nc)


def compute_ve_def_gradh(box: Box, x, y, z, h, m, xm, idx, nc, cfg: SphConfig):
    """VE normalization kx and the grad-h correction term."""
    K3d = kernel_3d_k(cfg.sinc_index)

    def stage(pc: PairChunk):
        wv = w_sinc(pc.v1, cfg.sinc_index)
        dwv = w_sinc_derivative(pc.v1, cfg.sinc_index)
        dterh = -(3.0 * wv + pc.v1 * dwv)
        xmi = pc.gi(xm)
        mi = pc.gi(m)
        xmj = pc.gj(xm)

        kx = xmi + pc.msum(wv * xmj)
        whomega = -3.0 * xmi + pc.msum(dterh * xmj)
        wrho0 = -3.0 * mi + pc.msum(dterh * pc.gj(m))

        hinv = 1.0 / pc.hi
        h3inv = hinv ** 3
        kx = kx * K3d * h3inv
        whomega = whomega * K3d * h3inv * hinv
        wrho0 = wrho0 * K3d * h3inv * hinv

        whomega = whomega * mi / xmi + (kx - K3d * xmi * h3inv) * wrho0
        rho = kx * mi / xmi
        dhdrho = -pc.hi / (rho * 3.0)
        gradh = 1.0 - dhdrho * whomega
        return kx, gradh

    return run_pair_stage(stage, box, x, y, z, h, idx, nc)


class IadDivvCurlv(NamedTuple):
    c11: torch.Tensor
    c12: torch.Tensor
    c13: torch.Tensor
    c22: torch.Tensor
    c23: torch.Tensor
    c33: torch.Tensor
    divv: torch.Tensor
    curlv: torch.Tensor
    dV11: torch.Tensor
    dV12: torch.Tensor
    dV13: torch.Tensor
    dV22: torch.Tensor
    dV23: torch.Tensor
    dV33: torch.Tensor


def _term_a(c11, c12, c13, c22, c23, c33, rx, ry, rz, w):
    """The three IAD-projected kernel gradients (termA1-3)."""
    return (-(c11 * rx + c12 * ry + c13 * rz) * w,
            -(c12 * rx + c22 * ry + c23 * rz) * w,
            -(c13 * rx + c23 * ry + c33 * rz) * w)


def compute_iad_divv_curlv(box: Box, x, y, z, vx, vy, vz, h, kx, xm,
                           idx, nc, cfg: SphConfig) -> IadDivvCurlv:
    """IAD matrix + velocity divergence/curl (and the symmetric velocity
    gradient), fused in one pass over the gathered neighbour data."""
    K3d = kernel_3d_k(cfg.sinc_index)

    def stage(pc: PairChunk):
        wv = w_sinc(pc.v1, cfg.sinc_index)
        volj = pc.gj(xm) / pc.gj(kx)
        weight = torch.where(pc.mask, volj * wv, 0.0)

        hinv = 1.0 / pc.hi
        h3inv = hinv ** 3
        sx = pc.rx * hinv[:, None]
        sy = pc.ry * hinv[:, None]
        sz = pc.rz * hinv[:, None]
        wnorm = weight * (K3d * h3inv)[:, None]

        t11 = torch.sum(sx * sx * wnorm, dim=1)
        t12 = torch.sum(sx * sy * wnorm, dim=1)
        t13 = torch.sum(sx * sz * wnorm, dim=1)
        t22 = torch.sum(sy * sy * wnorm, dim=1)
        t23 = torch.sum(sy * sz * wnorm, dim=1)
        t33 = torch.sum(sz * sz * wnorm, dim=1)

        det = (t11 * t22 * t33 + 2.0 * t12 * t23 * t13
               - t11 * t23 ** 2 - t22 * t13 ** 2 - t33 * t12 ** 2)
        fac = 1.0 / (det * pc.hi ** 2)
        c11 = (t22 * t33 - t23 ** 2) * fac
        c12 = (t13 * t23 - t33 * t12) * fac
        c13 = (t12 * t23 - t22 * t13) * fac
        c22 = (t11 * t33 - t13 ** 2) * fac
        c23 = (t13 * t12 - t11 * t23) * fac
        c33 = (t11 * t22 - t12 ** 2) * fac

        terms = _term_a(*(c[:, None] for c in (c11, c12, c13, c22, c23, c33)),
                        pc.rx, pc.ry, pc.rz, wv)
        xmj = pc.gj(xm)
        vx_ji = pc.gj(vx) - pc.gi(vx)[:, None]
        vy_ji = pc.gj(vy) - pc.gi(vy)[:, None]
        vz_ji = pc.gj(vz) - pc.gi(vz)[:, None]
        dVx = [pc.msum(vx_ji * xmj * t) for t in terms]
        dVy = [pc.msum(vy_ji * xmj * t) for t in terms]
        dVz = [pc.msum(vz_ji * xmj * t) for t in terms]

        norm_kx = K3d * h3inv / pc.gi(kx)
        divv = norm_kx * (dVx[0] + dVy[1] + dVz[2])
        curlv = norm_kx * torch.sqrt((dVz[1] - dVy[2]) ** 2
                                     + (dVx[2] - dVz[0]) ** 2
                                     + (dVy[0] - dVx[1]) ** 2)
        return IadDivvCurlv(c11, c12, c13, c22, c23, c33, divv, curlv,
                            norm_kx * dVx[0], norm_kx * (dVx[1] + dVy[0]),
                            norm_kx * (dVx[2] + dVz[0]), norm_kx * dVy[1],
                            norm_kx * (dVy[2] + dVz[1]), norm_kx * dVz[2])

    return run_pair_stage(stage, box, x, y, z, h, idx, nc)


def compute_av_switches(box: Box, x, y, z, vx, vy, vz, h, c, kx, xm, divv,
                        cij, alpha, dt, idx, nc, cfg: SphConfig):
    """Per-particle viscosity switch evolution (Cullen-Dehnen style)."""
    K3d = kernel_3d_k(cfg.sinc_index)

    def stage(pc: PairChunk):
        ci = pc.gi(c)
        divv_i = pc.gi(divv)
        alpha_i = pc.gi(alpha)

        vx_ij = pc.gi(vx)[:, None] - pc.gj(vx)
        vy_ij = pc.gi(vy)[:, None] - pc.gj(vy)
        vz_ij = pc.gi(vz)[:, None] - pc.gj(vz)
        rv = pc.rx * vx_ij + pc.ry * vy_ij + pc.rz * vz_ij

        vsig = torch.where(pc.mask & (rv < 0.0),
                           ci[:, None] + pc.gj(c) - 3.0 * rv / pc.safe_dist,
                           0.0)
        vijsignal = torch.maximum(torch.max(vsig, dim=1).values, 1e-30 * ci)

        h3inv = 1.0 / pc.hi ** 3
        wv = w_sinc(pc.v1, cfg.sinc_index) * (K3d * h3inv)[:, None]
        termA1, termA2, termA3 = _term_a(*(pc.gi(cc)[:, None] for cc in cij),
                                         pc.rx, pc.ry, pc.rz, wv)

        volj = pc.gj(xm) / pc.gj(kx)
        factor = volj * (divv_i[:, None] - pc.gj(divv))
        gx = pc.msum(factor * termA1)
        gy = pc.msum(factor * termA2)
        gz = pc.msum(factor * termA3)
        graddivv = torch.sqrt(gx ** 2 + gy ** 2 + gz ** 2)

        a_const = pc.hi ** 2 * graddivv
        alphaloc = torch.where(
            divv_i < 0.0,
            cfg.alphamax * a_const
            / (a_const + pc.hi * torch.abs(divv_i) + 0.05 * ci),
            0.0)

        decay = pc.hi / (cfg.decay_constant * vijsignal)
        alphadot = torch.where(alphaloc >= cfg.alphamin,
                               (alphaloc - alpha_i) / decay,
                               (cfg.alphamin - alpha_i) / decay)
        return torch.where(alphaloc >= alpha_i, alphaloc,
                           alpha_i + alphadot * dt)

    return run_pair_stage(stage, box, x, y, z, h, idx, nc)


class MomentumEnergy(NamedTuple):
    ax: torch.Tensor
    ay: torch.Tensor
    az: torch.Tensor
    du: torch.Tensor
    maxvsignal: torch.Tensor


def compute_momentum_energy(box: Box, x, y, z, vx, vy, vz, h, m, prho, c,
                            cij, kx, xm, alpha, idx, nc, cfg: SphConfig,
                            gradv=None) -> MomentumEnergy:
    """Pressure gradients + energy rate with Atwood-ramped crossed/uncrossed
    volume elements and pair artificial viscosity. gradv (6 dV fields)
    enables the avClean rv correction (momentum_energy_kern.hpp:44-63)."""
    K3d = kernel_3d_k(cfg.sinc_index)

    def stage(pc: PairChunk):
        hi = pc.hi
        hj = pc.gj(h)
        v1 = pc.v1
        v2 = pc.dist / hj
        Wi = w_sinc(v1, cfg.sinc_index) / hi[:, None] ** 3
        Wj = w_sinc(v2, cfg.sinc_index) / hj ** 3
        Wi = torch.where(pc.mask, Wi, 0.0)
        Wj = torch.where(pc.mask, Wj, 0.0)

        termA1_i, termA2_i, termA3_i = _term_a(
            *(pc.gi(cc)[:, None] for cc in cij), pc.rx, pc.ry, pc.rz, Wi)
        termA1_j, termA2_j, termA3_j = _term_a(
            *(pc.gj(cc) for cc in cij), pc.rx, pc.ry, pc.rz, Wj)

        vx_ij = pc.gi(vx)[:, None] - pc.gj(vx)
        vy_ij = pc.gi(vy)[:, None] - pc.gj(vy)
        vz_ij = pc.gi(vz)[:, None] - pc.gj(vz)
        rv = pc.rx * vx_ij + pc.ry * vy_ij + pc.rz * vz_ij

        if gradv is not None:
            # avClean correction (momentum_energy_kern.hpp:44-63)
            def quad(d11, d12, d13, d22, d23, d33):
                # R^T (sym dV) R with the symv convention of kernels.hpp:88-95
                q1 = d11 * pc.rx + d12 * pc.ry + d13 * pc.rz
                q2 = d22 * pc.ry + d23 * pc.rz
                q3 = d33 * pc.rz
                return pc.rx * q1 + pc.ry * q2 + pc.rz * q3

            dmy1 = quad(*(pc.gi(d)[:, None] for d in gradv))
            dmy2 = quad(*(pc.gj(d) for d in gradv))
            eta_ab = torch.minimum(v1, v2)
            eta_crit = torch.pow(
                rdiv(32.0 * math.pi / 3.0, pc.nc.to(v1.dtype) + 1.0),
                1.0 / 3.0)
            eta_diff = 5.0 * (eta_ab - eta_crit[:, None])
            dmy3 = torch.where(eta_ab < eta_crit[:, None],
                               torch.exp(-eta_diff * eta_diff), 1.0)
            nz = dmy2 != 0.0
            A_ab = torch.where(nz, dmy1 / torch.where(nz, dmy2, 1.0), 0.0)
            A_abp1 = 1.0 + A_ab
            phi_ab = 0.5 * dmy3 * torch.clamp(4.0 * A_ab / (A_abp1 * A_abp1),
                                              0.0, 1.0)
            rv = rv + (-phi_ab * (dmy1 + dmy2))

        wij = rv / pc.safe_dist
        alpha_i = pc.gi(alpha)[:, None]
        ci = pc.gi(c)[:, None]
        cj = pc.gj(c)
        beta = 2.0
        vij_signal = (alpha_i + pc.gj(alpha)) / 4.0 * (ci + cj) - beta * wij
        visc = torch.where(pc.mask & (wij < 0.0), -vij_signal * wij, 0.0)

        vsig_ts = torch.where(pc.mask, 0.5 * (ci + cj) - 2.0 * wij, 0.0)
        maxvsignal = torch.max(vsig_ts, dim=1).values

        mi = pc.gi(m)
        mj = pc.gj(m)
        xmi = pc.gi(xm)[:, None]
        xmj = pc.gj(xm)
        rhoi = (pc.gi(kx) * mi / pc.gi(xm))[:, None]
        rhoj = pc.gj(kx) * mj / xmj

        atwood = torch.abs(rhoi - rhoj) / (rhoi + rhoj)
        sigma = cfg.ramp * (atwood - cfg.atmin)
        lxmi = torch.log(xmi)
        lxmj = torch.log(xmj)
        if cfg.uniform_mass:
            # equal-mass path: clamp-form ramp with the polynomial exp
            # pair (the formulation of the slot-frame momentum stage)
            sc = torch.clamp(sigma, 0.0, 1.0)
            ep, em = exp_pair((1.0 - sc) * (lxmj - lxmi))
            prod = xmi * xmj
            a_mom = prod * em
            b_mom = prod * ep
        else:
            a_ramp = torch.exp((2.0 - sigma) * lxmi + sigma * lxmj)
            b_ramp = torch.exp((2.0 - sigma) * lxmj + sigma * lxmi)
            a_mom = torch.where(atwood < cfg.atmin, xmi * xmi,
                                torch.where(atwood > cfg.atmax, xmi * xmj,
                                            a_ramp))
            b_mom = torch.where(atwood < cfg.atmin, xmj * xmj,
                                torch.where(atwood > cfg.atmax, xmi * xmj,
                                            b_ramp))

        a_visc = mj / rhoi * visc
        b_visc = mj / rhoj * visc
        a_visc_x = 0.5 * (a_visc * termA1_i + b_visc * termA1_j)
        a_visc_y = 0.5 * (a_visc * termA2_i + b_visc * termA2_j)
        a_visc_z = 0.5 * (a_visc * termA3_i + b_visc * termA3_j)
        a_visc_energy = torch.clamp_min(
            pc.msum(a_visc_x * vx_ij + a_visc_y * vy_ij + a_visc_z * vz_ij),
            0.0)

        energy = pc.msum(mj * a_mom * (vx_ij * termA1_i + vy_ij * termA2_i
                                       + vz_ij * termA3_i))

        prhoi = pc.gi(prho)
        mom_i = mj * prhoi[:, None] * a_mom
        mom_j = mj * pc.gj(prho) * b_mom
        mom_x = pc.msum(mom_i * termA1_i + mom_j * termA1_j + a_visc_x)
        mom_y = pc.msum(mom_i * termA2_i + mom_j * termA2_j + a_visc_y)
        mom_z = pc.msum(mom_i * termA3_i + mom_j * termA3_j + a_visc_z)

        du = K3d * (prhoi * energy + 0.5 * a_visc_energy)
        return MomentumEnergy(-K3d * mom_x, -K3d * mom_y, -K3d * mom_z,
                              du, maxvsignal)

    return run_pair_stage(stage, box, x, y, z, h, idx, nc)
