"""Evrard collapse with radiative cooling + chemistry
(reference: main/src/init/evrard_init.hpp + the evrard-cooling case
wiring of init/factory.hpp and std_hydro_grackle.hpp).

Counterpart of sphexa_tpu/init/evrard_cooling.py: the adiabatic Evrard
sphere of init/evrard.py, with the cooling table's unit mapping (the
initial gas at 2e4 K, rho_to_cgs 1e-22: n_H ~ 0.05 cm^-3, warm and
partially ionized) and per-particle chemistry at the CIE equilibrium of
the initial temperature."""

from __future__ import annotations

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.init.evrard import init_evrard
from sphexa_tpu_torch.physics.chemistry import cie_equilibrium
from sphexa_tpu_torch.physics.cooling import CoolingParams


def init_evrard_cooling(side: int, cfg: SphConfig,
                        capacity: int | None = None,
                        dt0: float | None = None, device=None):
    """Returns (SimState, Box, cfg', extras) on `device` (default: the
    GPU); extras holds "chem" (ChemistryData) and "cooling_params"."""
    state, box, cfg = init_evrard(side, cfg, capacity=capacity, dt0=dt0,
                                  device=device)
    # the hydro stays in Evrard code units (G = M = R = 1); the cooling
    # table speaks cgs
    temp_code0 = float(state.p.temp[0])
    params = CoolingParams(temp_to_k=2.0e4 / max(temp_code0, 1e-30),
                           rho_to_cgs=1.0e-22)
    chem = cie_equilibrium(state.p.temp * params.temp_to_k)
    return state, box, cfg, {"chem": chem, "cooling_params": params}
