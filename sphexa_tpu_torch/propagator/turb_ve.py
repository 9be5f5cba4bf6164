"""Turbulence-driven VE propagator on the gather path (--prop
turbulence-ve; reference: main/src/propagator/turb_ve.hpp:68-118: the
VE forces, then driveTurbulence adds the stirring accelerations before
the integration).

Counterpart of sphexa_tpu/propagator/turb_ve.py (TurbVeProp). Per step
the OU noise advances once on the host with the step's dt (one read of
the device dt), the projected phases go to the device, and the step is
propagator/ve.py's compute_forces_ve plus the stirring sum over every
row, then finish_step. Plain PyTorch, no kernel, as the JAX step.
"""

from __future__ import annotations

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.neighbors import CellGrid
from sphexa_tpu_torch.physics.turbulence import StirModes, TurbulenceData
from sphexa_tpu_torch.propagator.common import finish_step
from sphexa_tpu_torch.propagator.ve import compute_forces_ve
from sphexa_tpu_torch.sfc.box import Box
from sphexa_tpu_torch.state import SimState
from sphexa_tpu_torch.util.device import resolve_device


class TurbVeProp:
    """step(state) -> (state, StepDiagnostics) with stirring, on `device`
    (default: the GPU). `turb` is the host OU state (created from the
    reference constants when None); the CLI checkpoints it."""

    def __init__(self, box: Box, grid: CellGrid, cfg: SphConfig,
                 turb: TurbulenceData | None = None, verbose: bool = False,
                 device=None):
        self.device = resolve_device(device)
        self.turb = turb or TurbulenceData.create(verbose=verbose)
        self.box, self.grid, self.cfg = box, grid, cfg
        self.modes = StirModes(self.turb, self.device)

    def step(self, state: SimState, phases_real, phases_imag):
        """One step with the given projected phases (device tensors)."""
        box, cfg = self.box, self.cfg
        if state.p.device != self.device:
            raise ValueError(f"state on {state.p.device}, step built for "
                             f"{self.device}")
        ps, me, aux = compute_forces_ve(state.p, box, self.grid, cfg,
                                        state.dt)
        sax, say, saz = self.modes.stir(ps.x, ps.y, ps.z, phases_real,
                                        phases_imag)
        return finish_step(state, ps, me.ax + sax, me.ay + say, me.az + saz,
                           me.du, me.maxvsignal, aux["c"], aux["divv"],
                           aux["nc_sph"], box, cfg, max_nc=aux["max_nc"],
                           max_cell_count=aux["max_cell_count"])

    def __call__(self, state: SimState):
        self.turb.update_noise(float(state.dt))
        (pr, pi), = self.turb.device_phases([self.device])
        return self.step(state, pr, pi)
