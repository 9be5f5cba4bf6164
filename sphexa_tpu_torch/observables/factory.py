"""Settings-keyed observables selection and the per-step constants.txt
line.

Counterpart of sphexa_tpu/observables/factory.py (reference: main/src/
observables/factory.hpp:48-66). The selection order is the JAX
package's, with the case name folded into the settings keys. Only the
default time/energy observable is ported: the grav-waves, wind-bubble,
turbulence-Mach and Kelvin-Helmholtz observables need
case_observables.py and grav_waves.py, which wait for ROADMAP Queue 1
item 6, and selecting them raises.
"""

from __future__ import annotations

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.observables.conserved import (Conserved,
                                                    conserved_quantities,
                                                    format_constants_line)
from sphexa_tpu_torch.sfc.box import Box
from sphexa_tpu_torch.state import SimState


class TimeEnergyObs:
    """Default: iteration, time, dt, energy budget, momenta
    (reference: observables/time_energies.hpp)."""

    name = "time-energy"
    extra_columns: tuple = ()

    def compute_extras(self, state: SimState, diag, cfg: SphConfig,
                       box: Box):
        return ()

    def line(self, state: SimState, diag, cfg: SphConfig, box: Box) -> str:
        q: Conserved = conserved_quantities(state.p, cfg,
                                            egrav=float(diag.egrav))
        base = format_constants_line(int(state.iteration) - 1,
                                     float(diag.ttot), float(diag.dt), q)
        extras = self.compute_extras(state, diag, cfg, box)
        if extras:
            base += " " + " ".join("%.9g" % float(v) for v in extras)
        return base

    def header(self) -> str:
        return ("# iteration time minDt etot ecin eint egrav linmom angmom "
                + " ".join(self.extra_columns)).rstrip()


def _unported(what: str):
    raise NotImplementedError(
        f"the {what} observable is not ported yet (ROADMAP Queue 1 item 6: "
        f"observables/case_observables.py and grav_waves.py)")


def make_observables(case: str | None, settings: dict | None = None):
    """The reference's observablesFactory selection order
    (factory.hpp:48-66), the case name acting as a settings key."""
    s = dict(settings or {})
    if case:
        s.setdefault(case, 1.0)
    if "observeGravWaves" in s:
        if "gravWaveTheta" not in s or "gravWavePhi" not in s:
            raise ValueError("need gravWaveTheta and gravWavePhi settings "
                             "for the grav-waves observable "
                             "(factory.hpp:50-54)")
        _unported("grav-waves")
    for key, what in (("wind-shock", "wind-bubble"),
                      ("turbulence", "turbulence-Mach"),
                      ("kelvin-helmholtz", "Kelvin-Helmholtz growth")):
        if key in s:
            _unported(what)
    return TimeEnergyObs()
