"""Runtime constants and precision policy.

Counterpart of sphexa_tpu/config.py: the same `SphConfig` fields and
defaults (reference: sph/include/sph/particles_data.hpp:86-138), with
the dtype policy expressed as torch dtypes.
"""

from __future__ import annotations

import dataclasses

import torch

# fp32 coordinates and hydro fields; compensated sums where needed
COORD_DTYPE = torch.float32
HYDRO_DTYPE = torch.float32
INDEX_DTYPE = torch.int64   # torch indexes with int64


@dataclasses.dataclass(frozen=True)
class SphConfig:
    """Static SPH runtime constants (hashable)."""

    # neighbor targets
    ng0: int = 100
    ngmax: int = 150
    ngpad: int = 160

    # time-step control
    kcour: float = 0.2
    krho: float = 0.06
    max_dt_increase: float = 1.1
    eta_acc: float = 0.2
    eps: float = 0.005

    # physics constants
    gamma: float = 5.0 / 3.0
    mui: float = 10.0
    gravG: float = 0.0

    # artificial-viscosity switches
    alphamin: float = 0.05
    alphamax: float = 1.0
    decay_constant: float = 0.2

    # Atwood-number ramp for crossed/uncrossed VE momentum terms
    atmin: float = 0.1
    atmax: float = 0.2

    # smoothing kernel
    sinc_index: float = 6.0
    kernel_table_size: int = 20000
    use_kernel_table: bool = False

    # AV velocity-gradient cleaning terms in the momentum equation
    av_clean: bool = False

    # all particle masses equal: the momentum stage's Atwood ramp runs
    # clamp-form with the exp_pair polynomial (sph/kernels.py)
    uniform_mass: bool = False

    # gravity solver and FMM settings
    gravity_solver: str = "direct"
    fmm_level: int = 4
    fmm_min_sep: int = 3

    # moment-matmul variants of the pair stages (K8-K10, ops/pair_ve.py)
    mxu_moments: bool = False
    mxu_momentum: bool = False
    mxu_bf16: bool = False
    gravity_rings: int = 1
    gravity_band_cap: int = 0

    # bounded smoothing length (0 = unbounded), applied by update_h and
    # by the h iteration of the xmass stage
    h_cap: float = 0.0

    clamp_frac_budget: float = 0.03

    # neighbor-engine shape parameters
    cell_cap: int = 64
    chunk: int = 4096         # rows a chunk of the neighbour search
    h_iter: int = 2           # coupled h/neighbor-count iterations

    @property
    def ramp(self) -> float:
        return 1.0 / (self.atmax - self.atmin)

    def replace(self, **kw) -> "SphConfig":
        return dataclasses.replace(self, **kw)
