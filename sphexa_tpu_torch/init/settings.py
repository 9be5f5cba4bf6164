"""Init-settings layering (reference: main/src/init/settings.hpp:42 +
utils.hpp:148-163): a test case's built-in constants can be overridden
by numeric attributes of a user HDF5 settings file, selected with the
`--init case:settings.h5` syntax; the effective settings are written
back to the output file attributes for provenance.

The port's own copy of sphexa_tpu/init/settings.py."""

from __future__ import annotations

from sphexa_tpu_torch.config import SphConfig

# settings-file key -> SphConfig field (reference attribute names,
# particles_data.hpp:90-138)
_CFG_KEYS = {
    "ng0": ("ng0", int),
    "ngmax": ("ngmax", int),
    "Kcour": ("kcour", float),
    "Krho": ("krho", float),
    "gamma": ("gamma", float),
    "muiConst": ("mui", float),
    "gravConstant": ("gravG", float),
    "alphamin": ("alphamin", float),
    "alphamax": ("alphamax", float),
    "decay_constant": ("decay_constant", float),
    "Atmin": ("atmin", float),
    "Atmax": ("atmax", float),
    "sincIndex": ("sinc_index", float),
    "epsilon": ("eps", float),
    "etaAcc": ("eta_acc", float),
    "maxDtIncrease": ("max_dt_increase", float),
}


def load_settings_file(path: str) -> dict:
    """Numeric attributes of the settings HDF5 file (root attrs)."""
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        for k, v in f.attrs.items():
            try:
                out[k] = float(v)
            except (TypeError, ValueError):
                pass
    return out


def apply_settings(cfg: SphConfig, settings: dict) -> SphConfig:
    """Layer file settings over the case defaults already in cfg."""
    kw = {}
    for key, (field, cast) in _CFG_KEYS.items():
        if key in settings:
            kw[field] = cast(settings[key])
    return cfg.replace(**kw) if kw else cfg


def parse_init_spec(spec: str):
    """'case', 'case:settings.h5', 'dump.h5', 'dump.h5:step' ->
    (kind, name/path, settings_path_or_step)."""
    head, sep, tail = spec.partition(":")
    if head.endswith(".h5"):
        return ("checkpoint", head, int(tail) if tail else -1)
    if head.endswith((".txt", ".asc", ".dat")):
        return ("ascii", head, int(tail) if tail else -1)
    if sep:
        return ("case", head, tail)
    return ("case", head, None)
