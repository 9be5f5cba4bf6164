"""Conserved-quantity observables, appended per step to constants.txt.

Counterpart of sphexa_tpu/observables/conserved.py (reference: main/
src/observables/conserved_quantities.hpp:118). Every reduction masks
padding rows and uses the compensated sum of util/kahan.py.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.sph.eos import ideal_gas_cv
from sphexa_tpu_torch.state import Particles
from sphexa_tpu_torch.util.kahan import kahan_sum


class Conserved(NamedTuple):
    etot: torch.Tensor
    ecin: torch.Tensor
    eint: torch.Tensor
    egrav: torch.Tensor
    linmom: torch.Tensor   # |sum m v|
    angmom: torch.Tensor   # |sum m r x v|


def conserved_quantities(ps: Particles, cfg: SphConfig,
                         egrav=0.0) -> Conserved:
    cv = ideal_gas_cv(cfg.mui, cfg.gamma)
    m = torch.where(ps.alive, ps.m, 0.0)
    ecin = 0.5 * kahan_sum(m * (ps.vx ** 2 + ps.vy ** 2 + ps.vz ** 2))
    eint = kahan_sum(m * cv * ps.temp)

    px = kahan_sum(m * ps.vx)
    py = kahan_sum(m * ps.vy)
    pz = kahan_sum(m * ps.vz)
    lx = kahan_sum(m * (ps.y * ps.vz - ps.z * ps.vy))
    ly = kahan_sum(m * (ps.z * ps.vx - ps.x * ps.vz))
    lz = kahan_sum(m * (ps.x * ps.vy - ps.y * ps.vx))

    egrav = torch.as_tensor(egrav, dtype=torch.float32, device=ps.device)
    linmom = torch.sqrt(px ** 2 + py ** 2 + pz ** 2)
    angmom = torch.sqrt(lx ** 2 + ly ** 2 + lz ** 2)
    return Conserved(ecin + eint + egrav, ecin, eint, egrav, linmom, angmom)


def format_constants_line(iteration: int, ttot: float, dt: float,
                          q: Conserved) -> str:
    """One line of constants.txt: iteration, time, dt, the energy budget
    and the momenta."""
    return ("%d %.9g %.9g %.9g %.9g %.9g %.9g %.9g %.9g"
            % (iteration, ttot, dt, float(q.etot), float(q.ecin),
               float(q.eint), float(q.egrav), float(q.linmom),
               float(q.angmom)))
