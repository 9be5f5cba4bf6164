"""Initial-condition factory (reference: main/src/init/factory.hpp:44-110).

Counterpart of sphexa_tpu/init/factory.py: named test cases map to
builder functions returning (SimState, Box, SphConfig). The port has
the cases `sedov` and `evrard`; the JAX package's others (noh,
isobaric-cube, gresho-chan, kelvin-helmholtz, wind-shock, turbulence)
wait for ROADMAP Queue 1 item 6.
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
    from sphexa_tpu_torch.init.sedov import init_sedov
    _CASES.setdefault("sedov", init_sedov)
    _CASES.setdefault("evrard", init_evrard)


def make_initializer(name: str):
    _ensure_loaded()
    if name not in _CASES:
        raise ValueError(
            f"unknown test case '{name}'; available: {available_cases()} "
            f"(the JAX package's other cases wait for ROADMAP Queue 1 "
            f"item 6)")
    fn = _CASES[name]

    def build(*args, **kw):
        # every registered lattice/glass case uses one particle mass:
        # enable the equal-mass momentum path (exact there)
        state, box, cfg = fn(*args, **kw)
        return state, box, cfg.replace(uniform_mass=True)

    return build
