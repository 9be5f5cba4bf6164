"""Per-particle chemistry fields: collisional-ionization-equilibrium
H/He network (the ChemistryData analog, reference:
physics/cooling/chemistry_data.hpp:116, GRACKLE's 13-species arrays).

Counterpart of sphexa_tpu/physics/chemistry.py: the H/He ionization
balance in CIE with the Cen (1992, ApJS 78, 341) collisional-ionization
and radiative-recombination rate fits, closed-form and elementwise in
plain PyTorch. `ChemistryData` is a dataclass of six float32 tensors
(the JAX package's flax pytree); `permute` reorders it with the
particles after a cell sort.
"""

from __future__ import annotations

import dataclasses

import torch

# H/He mass fractions (GRACKLE defaults)
HYDROGEN_FRACTION = 0.76
HELIUM_FRACTION = 1.0 - HYDROGEN_FRACTION

_Y_OVER_X = (HELIUM_FRACTION / 4.0) / HYDROGEN_FRACTION  # He:H nuclei ratio

FIELDS = ("x_HI", "x_HII", "x_HeI", "x_HeII", "x_HeIII", "x_e")


@dataclasses.dataclass
class ChemistryData:
    """Species fractions per particle (of the respective element's
    nuclei; x_e is electrons per H nucleus)."""
    x_HI: torch.Tensor
    x_HII: torch.Tensor
    x_HeI: torch.Tensor
    x_HeII: torch.Tensor
    x_HeIII: torch.Tensor
    x_e: torch.Tensor

    @classmethod
    def create(cls, n: int, ionized: bool = False, device=None):
        one = torch.ones((n,), dtype=torch.float32, device=device)
        zero = torch.zeros((n,), dtype=torch.float32, device=device)
        if ionized:
            return cls(x_HI=zero, x_HII=one, x_HeI=zero, x_HeII=zero,
                       x_HeIII=one, x_e=one * (1.0 + 2.0 * _Y_OVER_X))
        return cls(x_HI=one, x_HII=zero, x_HeI=one, x_HeII=zero,
                   x_HeIII=zero, x_e=zero)

    def permute(self, perm) -> "ChemistryData":
        """Every field reordered by perm (a cell sort's)."""
        return ChemistryData(**{f: getattr(self, f)[perm] for f in FIELDS})


def _safe_exp(x):
    return torch.exp(torch.clamp(x, -80.0, 0.0))


def cie_equilibrium(temp_k) -> ChemistryData:
    """CIE ionization fractions at temperature T [K] (Cen 1992 fits).

    Equilibrium per stage: x_up / x_down = Gamma_coll(T) / alpha_rec(T),
    electron-density independent (n_e cancels in two-body balance)."""
    T = torch.clamp_min(temp_k, 10.0)
    sqT = torch.sqrt(T)
    T5 = torch.sqrt(T / 1e5)

    # collisional ionization rates [cm^3/s]
    g_HI = 5.85e-11 * sqT * _safe_exp(-157809.1 / T) / (1.0 + T5)
    g_HeI = 2.38e-11 * sqT * _safe_exp(-285335.4 / T) / (1.0 + T5)
    g_HeII = 5.68e-12 * sqT * _safe_exp(-631515.0 / T) / (1.0 + T5)

    # recombination rates [cm^3/s] (radiative; case A-ish fits)
    a_HII = (8.4e-11 / sqT) * torch.pow(T / 1e3, -0.2) \
        / (1.0 + torch.pow(T / 1e6, 0.7))
    a_HeII = 1.5e-10 * torch.pow(T, -0.6353)
    a_HeIII = (3.36e-10 / sqT) * torch.pow(T / 1e3, -0.2) \
        / (1.0 + torch.pow(T / 1e6, 0.7))

    r_H = g_HI / torch.clamp_min(a_HII, 1e-30)        # x_HII / x_HI
    x_HII = r_H / (1.0 + r_H)
    x_HI = 1.0 - x_HII

    r1 = g_HeI / torch.clamp_min(a_HeII, 1e-30)       # x_HeII / x_HeI
    r2 = g_HeII / torch.clamp_min(a_HeIII, 1e-30)     # x_HeIII / x_HeII
    denom = 1.0 + r1 + r1 * r2
    x_HeI = 1.0 / denom
    x_HeII = r1 / denom
    x_HeIII = r1 * r2 / denom

    x_e = x_HII + _Y_OVER_X * (x_HeII + 2.0 * x_HeIII)
    return ChemistryData(x_HI=x_HI, x_HII=x_HII, x_HeI=x_HeI,
                         x_HeII=x_HeII, x_HeIII=x_HeIII, x_e=x_e)


def update_chemistry(chem: ChemistryData, temp, alive) -> ChemistryData:
    """Relax fractions to the CIE equilibrium at the current temperature
    on the alive rows (instantaneous equilibrium, matching the cooling
    table of physics/cooling.py); other rows keep theirs."""
    eq = cie_equilibrium(temp)
    return ChemistryData(**{f: torch.where(alive, getattr(eq, f),
                                           getattr(chem, f))
                            for f in FIELDS})


def mean_molecular_weight(chem: ChemistryData):
    """mu from the ionization state (for a chemistry-consistent EOS)."""
    X, Y = HYDROGEN_FRACTION, HELIUM_FRACTION
    inv_mu = X * (1.0 + chem.x_e) + Y / 4.0
    return 1.0 / inv_mu
