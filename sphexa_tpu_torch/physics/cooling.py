"""Radiative cooling (GRACKLE-equivalent interface).

Counterpart of sphexa_tpu/physics/cooling.py (reference: physics/
cooling/cooler.hpp:52-141 cool_particles, cooling_timestep;
cooler_impl.hpp:63-83 names the ~60 GRACKLE parameters). The same
tabulated CIE model serves the reference's interface:

  Lambda(T) = Lambda_prim(T) + Z/Zsun * Lambda_metal(T)

(piecewise power-law fits for the primordial H/He curve and the
solar-metallicity metal contribution), subcycled exponential
integration, a cooling-limited timestep and the optional heating terms.
Plain PyTorch on float32 tensors, as the JAX package computes it in XLA
(no Pallas kernel).

`CoolingParams.from_settings` takes the reference's `cooling::<name>`
keys; names with no analog in a tabulated model are carried and
round-tripped through `to_settings` (UNAPPLIED). Torch has no `interp`:
`interp` below is jnp.interp's formula, end values held outside the
knots. The JAX fori_loop over the subcycles is a Python loop.

The 1e-60 guards (cooling_rate_du, cooling_timestep) round to 0 in
float32, in the JAX package and here alike: a row with rho 0 gives NaN
in cooling_rate_du, and cooling_timestep's min carries it into dt
(ROADMAP Queue 3). The port keeps that result.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.sph.eos import ideal_gas_cv

# Piecewise power-law fit to the PRIMORDIAL (H + He, Z = 0) CIE curve
# Lambda(T) [erg cm^3/s]: the 1e4 K Ly-alpha wall, the 1e5 K He peak,
# and the T^0.5 bremsstrahlung tail.
_LOGT_PRIM = np.array([4.0, 4.25, 4.7, 5.5, 6.5, 7.5, 9.0])
_LOGL_PRIM = np.array([-24.5, -22.6, -22.2, -22.6, -23.1, -22.9, -22.2])

# Metal contribution at solar metallicity (difference curve): dominates
# between ~1e5 and ~1e7 K (C/O/Fe line cooling).
_LOGT_MET = np.array([4.0, 4.5, 5.0, 5.6, 6.3, 7.0, 8.0, 9.0])
_LOGL_MET = np.array([-26.0, -22.3, -21.6, -21.2, -22.0, -23.0, -23.6,
                      -24.0])

T_CMB0 = 2.725  # K

# cooling::<name> keys accepted for round-trip but with no analog in a
# tabulated device model (GRACKLE-internal solver/dust/UV/RT knobs).
UNAPPLIED = (
    "use_grackle", "primordial_chemistry", "dust_chemistry",
    "UVbackground", "h2_on_dust", "use_dust_density_field",
    "dust_recombination_cooling", "use_isrf_field",
    "interstellar_radiation_field", "three_body_rate", "cie_cooling",
    "h2_optical_depth_approximation", "ih2co", "ipiht",
    "DeuteriumToHydrogenRatio", "local_dust_to_gas_ratio",
    "NumberOfTemperatureBins", "CaseBRecombination",
    "NumberOfDustTemperatureBins", "DustTemperatureStart",
    "DustTemperatureEnd", "LWbackground_sawtooth_suppression",
    "LWbackground_intensity", "UVbackground_redshift_on",
    "UVbackground_redshift_off", "UVbackground_redshift_fullon",
    "UVbackground_redshift_drop", "cloudy_electron_fraction_factor",
    "use_radiative_transfer", "radiative_transfer_coupled_rate_solver",
    "radiative_transfer_intermediate_step",
    "radiative_transfer_hydrogen_only", "self_shielding_method",
    "H2_self_shielding", "H2_custom_shielding",
    "h2_charge_exchange_rate", "h2_dust_rate", "h2_h_cooling_rate",
    "collisional_excitation_rates", "collisional_ionisation_rates",
    "recombination_cooling_rates", "bremsstrahlung_cooling_rates",
    "exit_after_iterations_exceeded", "m_code_in_ms", "l_code_in_kpc",
)


@dataclasses.dataclass(frozen=True)
class CoolingParams:
    """The reference Cooler's parameter surface (cooler_impl.hpp:63-83)
    mapped onto the device cooling model. GRACKLE names in comments."""
    mu: float = 0.6                # mean molecular weight
    x_h: float = 0.76              # HydrogenFractionByMass
    gamma: float = 0.0             # Gamma; 0 = inherit cfg.gamma
    rho_to_cgs: float = 1.0        # code density -> g/cm^3 (code_units)
    temp_to_k: float = 1.0         # code temperature -> Kelvin
    t_floor: float = 1e2           # temperature floor [K]
    cmb_temperature_floor: bool = False   # raise floor to T_CMB
    with_radiative_cooling: bool = True   # master gate
    metal_cooling: bool = True            # metal_cooling
    metallicity: float = 1.0       # Z/Zsun scaling of the metal curve
    solar_metal_fraction: float = 0.01295  # SolarMetalFractionByMass
    temperature_start: float = 1.0        # TemperatureStart: table clamp
    temperature_end: float = 1e9          # TemperatureEnd
    photoelectric_heating: bool = False   # photoelectric_heating
    photoelectric_heating_rate: float = 8.5e-26  # [erg/s/cm^3 per n_H]
    compton_xray_heating: bool = False    # Compton_xray_heating (z=0
                                          # Compton term vs CMB)
    use_volumetric_heating_rate: bool = False
    volumetric_heating_rate: float = 0.0  # [erg/s/cm^3]
    use_specific_heating_rate: bool = False
    specific_heating_rate: float = 0.0    # [erg/s/g]
    subcycles: int = 4             # cooling subcycles per hydro step
    max_iterations: int = 64       # max_iterations: subcycle cap
    dt_fraction: float = 0.1       # cooling-limited dt = frac * u/|du|
    extra: tuple = ()              # carried (name, value) pairs with no
                                   # device analog (UNAPPLIED round-trip)

    # ---- settings round-trip (cooler.hpp:130 `cooling::<name>`) ------
    _MAP = dict(
        mu="mu", HydrogenFractionByMass="x_h", Gamma="gamma",
        rho_to_cgs="rho_to_cgs", temp_to_k="temp_to_k",
        t_floor="t_floor", cmb_temperature_floor="cmb_temperature_floor",
        with_radiative_cooling="with_radiative_cooling",
        metal_cooling="metal_cooling", metallicity="metallicity",
        SolarMetalFractionByMass="solar_metal_fraction",
        TemperatureStart="temperature_start",
        TemperatureEnd="temperature_end",
        photoelectric_heating="photoelectric_heating",
        photoelectric_heating_rate="photoelectric_heating_rate",
        Compton_xray_heating="compton_xray_heating",
        use_volumetric_heating_rate="use_volumetric_heating_rate",
        volumetric_heating_rate="volumetric_heating_rate",
        use_specific_heating_rate="use_specific_heating_rate",
        specific_heating_rate="specific_heating_rate",
        subcycles="subcycles", max_iterations="max_iterations",
        dt_fraction="dt_fraction")

    @classmethod
    def from_settings(cls, settings: dict) -> "CoolingParams":
        """Build from `cooling::<name>` keys (reference attribute
        naming). Applied names map onto fields, cast by the field's
        annotation (a string under `from __future__ import annotations`;
        "bool" is bool(int(v))); UNAPPLIED names are carried verbatim;
        unknown cooling:: keys raise."""
        kw = {}
        extra = []
        for key, val in settings.items():
            if not key.startswith("cooling::"):
                continue
            name = key[len("cooling::"):]
            if name in cls._MAP:
                field = cls._MAP[name]
                ftype = {f.name: f.type for f
                         in dataclasses.fields(cls)}[field]
                cast = {"float": float, "int": int,
                        "bool": lambda v: bool(int(v))}[ftype]
                kw[field] = cast(val)
            elif name in UNAPPLIED:
                extra.append((name, float(val)))
            else:
                raise ValueError(f"unknown cooling parameter {name!r}")
        return cls(extra=tuple(extra), **kw)

    def to_settings(self) -> dict:
        """Inverse of from_settings (checkpoint attribute surface)."""
        out = {}
        for gname, field in self._MAP.items():
            v = getattr(self, field)
            out[f"cooling::{gname}"] = (int(v) if isinstance(v, bool)
                                        else v)
        for name, val in self.extra:
            out[f"cooling::{name}"] = val
        return out

    def cv(self, cfg: SphConfig) -> float:
        g = self.gamma if self.gamma > 0 else cfg.gamma
        return ideal_gas_cv(self.mu, g)


def interp(x, xp, fp):
    """jnp.interp(x, xp, fp) on tensors: linear between the knots xp
    (sorted), fp[0] below xp[0] and fp[-1] above xp[-1]."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _table(a, like):
    return torch.tensor(a, dtype=torch.float32, device=like.device)


def lambda_cie(temp_k, params: CoolingParams = CoolingParams()):
    """Lambda(T) [erg cm^3/s]: primordial curve + scaled metal curve,
    clamped to the table's [TemperatureStart, TemperatureEnd] range;
    zero at and below 10^4 K (no low-T fine-structure model)."""
    t = torch.clamp(temp_k, params.temperature_start,
                    params.temperature_end)
    logt = torch.log10(torch.clamp_min(t, 1.0))
    lam = 10.0 ** interp(logt, _table(_LOGT_PRIM, logt),
                         _table(_LOGL_PRIM, logt))
    if params.metal_cooling:
        zscale = params.metallicity * (params.solar_metal_fraction
                                       / 0.01295)
        lam = lam + zscale * 10.0 ** interp(
            logt, _table(_LOGT_MET, logt), _table(_LOGL_MET, logt))
    return torch.where(temp_k > 1e4, lam, 0.0)


def cooling_rate_du(temp_k, rho_cgs, params: CoolingParams):
    """Net du/dt [erg/g/s]: -n_H^2 Lambda(T)/rho + heating terms
    (photoelectric / Compton / user rates, the GRACKLE heating
    switches). The 1e-60 guard is 0 in float32 (module docstring)."""
    mh = 1.6726e-24
    n_h = params.x_h * rho_cgs / mh
    rho_safe = torch.clamp_min(rho_cgs, 1e-60)
    du = torch.zeros_like(temp_k)
    if params.with_radiative_cooling:
        du = du - n_h * n_h * lambda_cie(temp_k, params) / rho_safe
    if params.photoelectric_heating:
        du = du + params.photoelectric_heating_rate * n_h / rho_safe
    if params.compton_xray_heating:
        # z=0 Compton coupling to the CMB: Gamma_C ~ 5.65e-36 n_e
        # (T_CMB - T) erg/s/cm^3, a net coolant for T > T_CMB
        n_e = n_h  # ionized-H estimate
        du = du + 5.65e-36 * n_e * (T_CMB0 - temp_k) / rho_safe
    if params.use_volumetric_heating_rate:
        du = du + params.volumetric_heating_rate / rho_safe
    if params.use_specific_heating_rate:
        du = du + params.specific_heating_rate
    return du


def cool_particles(temp, rho, dt, cfg: SphConfig,
                   params: CoolingParams = CoolingParams()):
    """Subcycled cooling update of the temperature field
    (reference: cooler.hpp cool_particles), min(subcycles,
    max_iterations) subcycles. Units via params.rho_to_cgs / temp_to_k
    (the GRACKLE code_units analog)."""
    cv = params.cv(cfg)
    nsub = min(params.subcycles, params.max_iterations)
    sub_dt = dt / nsub
    rho_cgs = rho * params.rho_to_cgs
    t_floor_k = params.t_floor
    if params.cmb_temperature_floor:
        t_floor_k = max(t_floor_k, T_CMB0)

    t = temp
    for _ in range(nsub):
        u = cv * t
        du = cooling_rate_du(t * params.temp_to_k, rho_cgs,
                             params) / params.temp_to_k
        # exponential-decay floor keeps u positive (same guard as the
        # energy integrator, positions.hpp:54-61)
        u_new = u + du * sub_dt
        safe_u = torch.clamp_min(u, 1e-30)
        u_new = torch.where(u_new <= 0.0,
                            safe_u * torch.exp(u_new * sub_dt / safe_u),
                            u_new)
        t = torch.clamp_min(u_new / cv, t_floor_k / params.temp_to_k)
    return t


def cooling_timestep(temp, rho, cfg: SphConfig,
                     params: CoolingParams = CoolingParams()):
    """dt limit = frac * u / |du_cool| (reference: cooling_timestep),
    the min over every row given. The 1e-60 guard is 0 in float32."""
    cv = params.cv(cfg)
    u = cv * temp
    du = torch.abs(cooling_rate_du(temp * params.temp_to_k,
                                   rho * params.rho_to_cgs, params)
                   / params.temp_to_k)
    dt_i = params.dt_fraction * u / torch.clamp_min(du, 1e-60)
    return torch.min(dt_i)
