"""Settings-keyed observables selection and the per-step constants.txt
line.

Counterpart of sphexa_tpu/observables/factory.py (reference: main/src/
observables/factory.hpp:48-66). The selection order is the JAX
package's, with the case name folded into the settings keys: grav-waves
if `observeGravWaves` is set, the wind-bubble survival fraction for
wind-shock, the RMS Mach number for turbulence, the KH growth amplitude
for kelvin-helmholtz, else time and energy. Each writes the conserved
columns first.
"""

from __future__ import annotations

import numpy as np

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.observables.conserved import (Conserved,
                                                    conserved_quantities,
                                                    format_constants_line)
from sphexa_tpu_torch.sfc.box import Box
from sphexa_tpu_torch.sph.eos import ideal_gas_cv
from sphexa_tpu_torch.state import SimState
from sphexa_tpu_torch.util.device import host


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


class TurbMachObs(TimeEnergyObs):
    """Adds the RMS Mach number column (reference: observables/
    factory.hpp `settings.count("turbulence")` -> TurbulenceMachRMS)."""

    name = "turbulence-mach"
    extra_columns = ("machRMS",)

    def compute_extras(self, state, diag, cfg, box):
        from sphexa_tpu_torch.observables.case_observables import \
            turbulence_mach_rms
        return (turbulence_mach_rms(state.p, cfg),)


class TimeEnergyGrowthObs(TimeEnergyObs):
    """Adds the KH mode-1 growth amplitude (reference:
    observables/time_energy_growth.hpp)."""

    name = "kh-growth"
    extra_columns = ("khGrowthRate",)

    def compute_extras(self, state, diag, cfg, box):
        from sphexa_tpu_torch.observables.case_observables import \
            kelvin_helmholtz_growth_rate
        return (kelvin_helmholtz_growth_rate(state.p, cfg),)


class WindBubbleObs(TimeEnergyObs):
    """Adds the bubble's surviving fraction (reference: observables/
    wind_bubble_fraction.hpp:43-56: survivors satisfy rho >= 0.64
    rhoBubble and temp <= 0.9 tempWind). Density is re-estimated with
    the std SPH summation over a throwaway neighbour list, as in the JAX
    package (the VE density is not kept in the state)."""

    name = "wind-bubble"
    extra_columns = ("bubbleFraction",)

    def __init__(self, rho_int: float, u_ext: float, r_sphere: float):
        self.rho_int = float(rho_int)
        self.u_ext = float(u_ext)
        bubble_volume = 4.0 / 3.0 * np.pi * float(r_sphere) ** 3
        self.bubble_mass = bubble_volume * float(rho_int)

    def compute_extras(self, state, diag, cfg, box):
        from sphexa_tpu_torch.neighbors import (CellGrid, build_cell_list,
                                                build_neighbor_list,
                                                choose_level)
        from sphexa_tpu_torch.sph.hydro_std import compute_density

        ps = state.p
        h_max = float(np.max(host(ps.h)[host(ps.alive)]))
        grid = CellGrid(choose_level(box, h_max * 1.25))
        cl = build_cell_list(grid, box, ps.x, ps.y, ps.z, alive=ps.alive)
        ps = ps.permute(cl.perm)
        nl = build_neighbor_list(grid, box, cl, ps.x, ps.y, ps.z, ps.h, cfg,
                                 adapt_h=False, alive=ps.alive)
        rho = compute_density(box, ps.x, ps.y, ps.z, ps.h, ps.m, nl.idx,
                              nl.nc, cfg)
        cv = ideal_gas_cv(cfg.mui, cfg.gamma)
        temp_wind = self.u_ext / float(cv)
        alive = host(ps.alive)
        surv = ((host(rho) >= 0.64 * self.rho_int)
                & (host(ps.temp) <= 0.9 * temp_wind) & alive)
        surviving_mass = float(np.sum(host(ps.m)[surv]))
        return (surviving_mass / self.bubble_mass,)


class GravWaveObs(TimeEnergyObs):
    """Adds the h+ / hx strain columns at the configured observation
    direction (reference: observables/gravitational_waves.hpp; selected
    by the `observeGravWaves` settings key). Accelerations come from the
    Press-2 integrator state: x_m1 = v dt - a dt^2 / 2, so
    a = 2 (v dt - x_m1) / dt^2."""

    name = "grav-waves"
    extra_columns = ("httplus", "httcross")

    def __init__(self, theta: float, phi: float):
        self.theta = float(theta)
        self.phi = float(phi)

    def compute_extras(self, state, diag, cfg, box):
        from sphexa_tpu_torch.observables.grav_waves import (compute_htt,
                                                             d2_quadrupole)
        ps = state.p
        dt = float(diag.dt)
        inv = 2.0 / max(dt * dt, 1e-30)

        def accel(v, dx_prev):
            return (v * dt - dx_prev) * inv

        ax = accel(ps.vx, ps.x_m1)
        ay = accel(ps.vy, ps.y_m1)
        az = accel(ps.vz, ps.z_m1)
        d2q = d2_quadrupole(ps.x, ps.y, ps.z, ps.vx, ps.vy, ps.vz,
                            ax, ay, az, ps.m, ps.alive)
        return compute_htt(host(d2q), self.theta, self.phi)


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
        return GravWaveObs(s["gravWaveTheta"], s["gravWavePhi"])
    if "wind-shock" in s:
        from sphexa_tpu_torch.init.wind_shock import wind_shock_constants
        const = wind_shock_constants()
        return WindBubbleObs(s.get("rhoInt", const["rhoInt"]),
                             s.get("uExt", const["uExt"]),
                             s.get("rSphere", const["rSphere"]))
    if "turbulence" in s:
        return TurbMachObs()
    if "kelvin-helmholtz" in s:
        return TimeEnergyGrowthObs()
    return TimeEnergyObs()
