"""Initial-condition factory (reference: main/src/init/factory.hpp:44-110).

Counterpart of sphexa_tpu/init/factory.py: named test cases map to
builder functions returning (SimState, Box, SphConfig). The port has
the JAX package's cases sedov, noh, isobaric-cube, gresho-chan,
kelvin-helmholtz, wind-shock, evrard and turbulence. evrard-cooling
is not a factory case in either package: main.py builds it with
init/evrard_cooling.py, which also returns its chemistry and cooling
parameters.
"""

from __future__ import annotations

_CASES = {}


def register(name):
    def deco(fn):
        _CASES[name] = fn
        return fn
    return deco


def available_cases():
    _ensure_loaded()
    return sorted(_CASES)


def _ensure_loaded():
    from sphexa_tpu_torch.init.evrard import init_evrard
    from sphexa_tpu_torch.init.gresho_chan import init_gresho_chan
    from sphexa_tpu_torch.init.isobaric_cube import init_isobaric_cube
    from sphexa_tpu_torch.init.kelvin_helmholtz import init_kelvin_helmholtz
    from sphexa_tpu_torch.init.noh import init_noh
    from sphexa_tpu_torch.init.sedov import init_sedov
    from sphexa_tpu_torch.init.turbulence import init_turbulence
    from sphexa_tpu_torch.init.wind_shock import init_wind_shock
    for name, fn in (("sedov", init_sedov), ("noh", init_noh),
                     ("isobaric-cube", init_isobaric_cube),
                     ("gresho-chan", init_gresho_chan),
                     ("kelvin-helmholtz", init_kelvin_helmholtz),
                     ("wind-shock", init_wind_shock),
                     ("evrard", init_evrard),
                     ("turbulence", init_turbulence)):
        _CASES.setdefault(name, fn)


def make_initializer(name: str):
    _ensure_loaded()
    if name not in _CASES:
        raise ValueError(
            f"unknown test case '{name}'; available: {available_cases()}")
    fn = _CASES[name]

    def build(*args, **kw):
        # every registered lattice/glass case uses one particle mass:
        # enable the equal-mass momentum path (exact there)
        state, box, cfg = fn(*args, **kw)
        return state, box, cfg.replace(uniform_mass=True)

    return build
