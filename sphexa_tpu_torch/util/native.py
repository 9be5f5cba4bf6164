"""ctypes binding of the port's host-grid library (csrc/hostgrid.c).

Counterpart of sphexa_tpu/util/native.py. The tier planner's hot host
loops (cell bucketing for capacity planning, the exact band audit)
run in C: their numpy forms scale poorly past ~10^6 particles. The
library is compiled with cc at first use into build/sphexa_tpu_torch/
(named by a digest of its source, flags and host), and a failed build
raises: unlike the JAX package, the port does not fall back to numpy
quietly. The numpy forms stay beside their callers as the plain
versions the tests hold the library against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "csrc" / "hostgrid.c"
BUILD_DIR = _PKG.parent / "build" / "sphexa_tpu_torch"
CC_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib = None
_LOCK = threading.Lock()


def _target() -> Path:
    text = (_SRC.read_text() + " ".join(CC_FLAGS) + platform.machine()
            + " ".join(platform.libc_ver()))
    digest = hashlib.sha1(text.encode()).hexdigest()[:12]
    return BUILD_DIR / f"hostgrid-{digest}.so"


def _build(so: Path):
    """cc the source into `so` (through a private temporary name, so
    that processes building at once never load a half-written file)."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    r = subprocess.run(["cc", *CC_FLAGS, str(_SRC), "-o", str(tmp), "-lm"],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"building {_SRC.name} failed:\n{r.stderr}")
    os.replace(tmp, so)


def load():
    """The library, built on first use. Raises if it cannot be built or
    loaded."""
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        so = _target()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        D = ctypes.POINTER(ctypes.c_double)
        lib.hg_max_cell_count_unit.restype = ctypes.c_int64
        lib.hg_max_cell_count_unit.argtypes = (
            [D] * 3 + [ctypes.c_int64] * 4)
        lib.hg_band_audit.restype = ctypes.c_int64
        lib.hg_band_audit.argtypes = (
            [D] * 4 + [ctypes.c_int64] + [D] * 3 + [ctypes.c_int64]
            + [ctypes.c_double] * 6 + [ctypes.c_int32] * 3
            + [ctypes.c_int64] * 3)
        _lib = lib
        return lib


def _dp(a):
    a = np.ascontiguousarray(a, np.float64)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _checked(r: int, what: str) -> int:
    if r < 0:
        raise MemoryError(f"{what}: the host-grid library could not "
                          f"allocate its buckets")
    return int(r)


def max_cell_count(u, v, w, nx: int, ny: int, nz: int) -> int:
    """Max per-cell count of coordinates mapped to the unit cube
    (ops/cellmajor._unit_coords) binned into (nx, ny, nz) cells (the
    binding of ops/cellmajor.max_cell_count)."""
    uk, up = _dp(u)
    _, vp = _dp(v)
    _, wp = _dp(w)
    r = load().hg_max_cell_count_unit(up, vp, wp, len(uk), nx, ny, nz)
    return _checked(r, "max_cell_count")


def band_audit(xi, yi, zi, hi, xj, yj, zj, box, nx: int, ny: int,
               nz: int) -> int:
    """Excluded particles j inside the 2 h_i support of any in-tier i
    (the inner loop of propagator/ve_tiered.audit_tiers, whose numpy
    form is _band_audit_plain there)."""
    ai = [_dp(v) for v in (xi, yi, zi, hi)]
    aj = [_dp(v) for v in (xj, yj, zj)]
    per = [int(p) for p in box.periodic]
    r = load().hg_band_audit(
        ai[0][1], ai[1][1], ai[2][1], ai[3][1], len(ai[0][0]),
        aj[0][1], aj[1][1], aj[2][1], len(aj[0][0]),
        box.xmin, box.ymin, box.zmin, box.lx, box.ly, box.lz,
        per[0], per[1], per[2], nx, ny, nz)
    return _checked(r, "band_audit")
