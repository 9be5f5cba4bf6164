"""Gravitational-wave quadrupole observable (reference: main/src/
observables/gravitational_waves.hpp, grav_waves_calculations.hpp:51-145).

Counterpart of sphexa_tpu/observables/grav_waves.py. The second time
derivative of the traceless mass quadrupole comes from (x, v, a) with no
differencing across steps:

  d2Q_aa = 2/3 sum_i m_i (3 (v_a^2 + x_a a_a) - |v|^2 - x.a)
  d2Q_ab = sum_i m_i (2 v_a v_b + a_a x_b + x_a a_b)      (a != b)

projected onto the (theta, phi) direction as the h+ and hx strains at
10 kpc in the reference's units.
"""

from __future__ import annotations

import numpy as np
import torch

from sphexa_tpu_torch.util.device import host

G_CGS = 6.6726e-8
C_CGS = 2.997924562e10
D_10KPC_CM = 3.08568025e22
GW_UNITS = G_CGS / C_CGS ** 4 / D_10KPC_CM


def d2_quadrupole(x, y, z, vx, vy, vz, ax, ay, az, m, alive):
    """The 6 components [xx, yy, zz, xy, xz, yz] of d^2Q/dt^2
    (d2QuadpoleMomentum, grav_waves_calculations.hpp:95-145)."""
    mm = torch.where(alive, m, 0.0)
    v2 = vx * vx + vy * vy + vz * vz
    xa = x * ax + y * ay + z * az

    def diag(c, v, a):
        return (2.0 / 3.0) * torch.sum(
            mm * (3.0 * (v * v + c * a) - v2 - xa))

    def off(c1, v1, a1, c2, v2_, a2):
        return torch.sum(mm * (2.0 * v1 * v2_ + a1 * c2 + c1 * a2))

    return torch.stack([
        diag(x, vx, ax), diag(y, vy, ay), diag(z, vz, az),
        off(x, vx, ax, y, vy, ay), off(x, vx, ax, z, vz, az),
        off(y, vy, ay, z, vz, az)])


def compute_htt(d2q, theta: float, phi: float):
    """Project d2Q onto the observation direction; returns (h+, hx)
    (computeHtt, grav_waves_calculations.hpp:51-85)."""
    qxx, qyy, qzz, qxy, qxz, qyz = (d2q[i] for i in range(6))
    sin2t = np.sin(2.0 * theta)
    sin2p = np.sin(2.0 * phi)
    cos2p = np.cos(2.0 * phi)
    sint, sinp = np.sin(theta), np.sin(phi)
    cost, cosp = np.cos(theta), np.cos(phi)

    dot2ibartt = ((qxx * cosp ** 2 + qyy * sinp ** 2 + qxy * sin2p)
                  * cost ** 2 + qzz * sint ** 2
                  - (qxz * cosp + qyz * sinp) * sin2t)
    dot2ibarpp = qxx * sinp ** 2 + qyy * cosp ** 2 - qxy * sin2p
    dot2ibartp = (0.5 * (qyy - qxx) * cost * sin2p + qxy * cost * cos2p
                  + (qxz * sinp - qyz * cosp) * sint)

    httplus = (dot2ibartt - dot2ibarpp) * GW_UNITS
    httcross = 2.0 * dot2ibartp * GW_UNITS
    return httplus, httcross


def gravitational_waves(ps, ax, ay, az, theta: float, phi: float):
    """(h+, hx) of a Particles state and its accelerations."""
    d2q = d2_quadrupole(ps.x, ps.y, ps.z, ps.vx, ps.vy, ps.vz,
                        ax, ay, az, ps.m, ps.alive)
    return compute_htt(host(d2q), theta, phi)
