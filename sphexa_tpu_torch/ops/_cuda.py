"""Build and bind the port's CUDA kernels (no JAX counterpart: Pallas
kernels are compiled by XLA).

Each source in sphexa_tpu_torch/csrc/ is compiled by nvcc for sm_90a
into its own shared library with a plain C interface, at first use,
under build/sphexa_tpu_torch/ of the checkout, with nvcc's output
(ptxas -v: registers and spills) beside each library; the sources build
in parallel. The libraries are loaded with ctypes and launch on PyTorch's
current stream. Every C entry returns cudaGetLastError(); a non-zero
code raises here.

A header with the kernel constants (the sinc polynomials of
sph/kernels.py, FILL_POS, the header size of K2g's gate workspace, the
pair kernels' cap ceiling MAX_CAP) is
generated into the build directory, so the kernels and the plain
versions share one definition. Library file
names carry a hash of source, header and flags: a changed source is
rebuilt, an unchanged one is loaded as built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "sphexa_tpu_torch"
SOURCES = ("ghost_refresh.cu", "cell_pair.cu", "probes.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# other builds of a source, with more flags: probes.cu reaching the
# driver's cuTensorMapEncodeTiled by linking libcuda (the toolkit's stub
# library) instead of through the runtime's driver entry point, and P5's
# wgmma kernel with its product or its elementwise work cut out
# (probes/mma_parts.py)
VARIANTS = {"probes_libcuda": ("probes.cu", ["-DPROBES_LINK_LIBCUDA",
                                             "-lcuda"]),
            "probes_product": ("probes.cu", ["-DMW_PART=1"]),
            "probes_elementwise": ("probes.cu", ["-DMW_PART=2"])}

_libs: dict = {}
_LIB_LOCK = threading.Lock()
build_info: dict = {}   # source -> {"seconds": float, "ptxas": str}


def _f32_literal(x: float) -> str:
    """C++ hex literal of float32(x): exact, no decimal rounding."""
    return float(np.float32(x)).hex() + "f"


def _consts_header() -> str:
    from sphexa_tpu_torch.ops.pair_ve import (_NEG, FILL_POS, GATE_HDR,
                                              MAX_CAP)
    from sphexa_tpu_torch.sph.kernels import _DSINC_OVER_V_COEF, _SINC_COEF

    def poly(name, coef):
        lines = [f"__device__ __forceinline__ float {name}(float v2) {{",
                 f"    float acc = {_f32_literal(coef[-1])};"]
        for c in reversed(coef[:-1]):
            lines.append(f"    acc = acc * v2 + {_f32_literal(c)};")
        lines += ["    return acc;", "}"]
        return "\n".join(lines)

    return "\n".join([
        "// generated by sphexa_tpu_torch/ops/_cuda.py from sph/kernels.py",
        "// and ops/pair_ve.py; do not edit",
        "#pragma once",
        f"#define SPH_FILL_POS ({_f32_literal(FILL_POS)})",
        f"#define SPH_NEG ({_f32_literal(_NEG)})",
        f"#define SPH_GATE_HDR {GATE_HDR}",
        f"#define SPH_MAX_CAP {MAX_CAP}",
        poly("sinc_poly", _SINC_COEF),
        poly("dsinc_over_v_poly", _DSINC_OVER_V_COEF),
        ""])


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _source(name: str):
    """(source file, extra nvcc flags) of a library name."""
    return VARIANTS.get(name, (name, []))


def _target(name: str, header: str) -> Path:
    src, extra = _source(name)
    text = (_CSRC / src).read_text() + header + " ".join(NVCC_FLAGS + extra)
    digest = hashlib.sha1(text.encode()).hexdigest()[:12]
    return BUILD_DIR / f"{Path(name).stem}-{digest}.so"


def build(sources=SOURCES) -> dict:
    """Compile every given source (or VARIANTS name) whose library is
    missing, all nvcc processes started together. Returns {name: library
    path}."""
    header = _consts_header()
    inc = BUILD_DIR / "include"
    inc.mkdir(parents=True, exist_ok=True)
    hpath = inc / "sph_consts.h"
    if not hpath.exists() or hpath.read_text() != header:
        hpath.write_text(header)
    targets = {s: _target(s, header) for s in sources}
    procs = {}
    t0 = time.perf_counter()
    for name, so in targets.items():
        if so.exists():
            log = so.with_suffix(".log")
            if name not in build_info and log.exists():
                build_info[name] = {"seconds": 0.0,
                                    "ptxas": log.read_text()}
            continue
        src, extra = _source(name)
        if "-lcuda" in extra:
            stubs = Path(_nvcc()).resolve().parents[1] / "lib64" / "stubs"
            extra = extra + ["-L", str(stubs)]
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(inc), "-o", str(tmp),
               str(_CSRC / src), *extra]        # libraries after the source
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, so)
    failed = []
    for src, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        build_info[src] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float


class PairGeom(ctypes.Structure):
    _fields_ = [("nx", _I), ("n", _I), ("nz", _I), ("npd", _I), ("npz", _I),
                ("cap", _I), ("n_slots", _LL)]


class PairParams(ctypes.Structure):
    _fields_ = [("K3d", _F), ("n_w", _I), ("ngmin", _F), ("ngmax", _F),
                ("h_cap", _F), ("h_iter", _I), ("alphamin", _F),
                ("alphamax", _F), ("decay_constant", _F), ("atmin", _F),
                ("atmax", _F), ("ramp", _F), ("uniform_mass", _I),
                ("hcoef", _F), ("mxu_bf16", _I), ("stats", _P)]


class PairGate(ctypes.Structure):
    """K2g's gate: the gate pass's workspace (null for the ungated
    stage), prev and the supercell size."""
    _fields_ = [("ws", _P), ("prev", _P), ("Z", _I)]


class GhostArgs(ctypes.Structure):
    """The fixed arguments of one ghost-refresh table (ghost_refresh.cu)."""
    _fields_ = [("table", _P), ("n_ghost", _I), ("cap", _I), ("lx", _F),
                ("ly", _F), ("lz", _F), ("periodic", _I), ("fill_pos", _F)]


_ARGTYPES = {
    "ghost_refresh.cu": {
        "ghost_refresh": [_P, _I, _LL, _I, _I, _I, _I, _P, _P]},
    "cell_pair.cu": {
        "pair_launch": [_I, _P, _P, _P, PairGeom, PairParams, PairGate, _P],
        "pair_gate": [_P, PairGeom, _I, _P, _P],
        "pair_launch_column": [_I, _P, _P, _P, PairGeom, PairParams, _I,
                               _P],
        "pair_smem": [_I, _I, _I]},
    "probes.cu": {
        "fma_ceiling": [_P, _P, _LL, _I, _I, _P],
        "staging": [_I, _P, _P, _I, _P, _I, _LL, _I, _I, _P],
        "mma_micro": [_I, _I, _P, _P, _I, _I, _P],
        "mma_micro_info": [_I, _I, _P],
        "tma_encoder": []},
}


def _bind(name: str, lib: ctypes.CDLL):
    for fn, argtypes in _ARGTYPES[_source(name)[0]].items():
        getattr(lib, fn).restype = _I
        getattr(lib, fn).argtypes = argtypes


def lib(src: str) -> ctypes.CDLL:
    """The loaded library of one source (or VARIANTS name), built first
    if needed. A loaded library is returned without the lock; loading
    takes it, since the shards of a SlabMesh may first launch from
    several threads at once. A library enters _libs only once bound."""
    handle = _libs.get(src)
    if handle is not None:
        return handle
    with _LIB_LOCK:
        if src not in _libs:
            so = build([src])[src]
            handle = ctypes.CDLL(str(so))
            _bind(src, handle)
            _libs[src] = handle
        return _libs[src]


def _stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on the tensor's device, as a handle."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _check(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


class GhostLaunch:
    """K1 or K1z bound to one ghost table (int32 [n_ghost, 4] on the
    card, see ghost_refresh.cu): the argument block and the C function
    are made once, so a launch converts only the stack pointer, its row
    count, the coordinate rows, the form and the stream. The float4 form
    is taken where cap % 4 == 0 and the stack is 16-byte aligned, the
    scalar form elsewhere."""

    def __init__(self, table, cap: int, box, fill_pos: float, name: str):
        self.table = table                     # kept alive for the pointer
        self.args = GhostArgs(table.data_ptr(), table.shape[0], cap, box.lx,
                              box.ly, box.lz,
                              sum(int(p) << k for k, p in
                                  enumerate(box.periodic)), fill_pos)
        self.addr = ctypes.addressof(self.args)
        self.fn = lib("ghost_refresh.cu").ghost_refresh
        self.vec_cap = cap % 4 == 0
        self.name = name

    def __call__(self, stack, xyz_rows):
        ix, iy, iz = xyz_rows if xyz_rows is not None else (-1, -1, -1)
        ptr = stack.data_ptr()
        code = self.fn(ptr, stack.shape[0], stack.shape[1], ix, iy, iz,
                       self.vec_cap and ptr % 16 == 0, self.addr,
                       _stream(stack))
        _check(code, self.name)


def _geom(grid):
    return PairGeom(grid.nx, grid.n, grid.nz, grid.np_, grid.npz, grid.cap,
                    grid.n_slots)


def _pair_args(grid, cfg, K3d: float, stats=None):
    geom = _geom(grid)
    prm = PairParams(K3d, int(cfg.sinc_index), float(cfg.ng0 // 4),
                     float(cfg.ngmax), cfg.h_cap, cfg.h_iter, cfg.alphamin,
                     cfg.alphamax, cfg.decay_constant, cfg.atmin, cfg.atmax,
                     cfg.ramp, int(cfg.uniform_mass), 1023.0 * cfg.ng0,
                     int(cfg.mxu_bf16),
                     None if stats is None else stats.data_ptr())
    return geom, prm


def pair_launch(stage: int, J, I2, out, grid, cfg, K3d: float, gate=None,
                stats=None):
    """gate=None: the ungated stage; else (ws, prev, Z) for K2g: the
    list that pair_gate wrote into ws, then prev's rows kept on the
    inactive supercells. stats: an int64 [3] tensor on the card that K3
    adds its walk counts to (cell_pair.cu, xh::xh_cell), or None."""
    geom, prm = _pair_args(grid, cfg, K3d, stats)
    if gate is None:
        gt = PairGate(None, None, 0)
    else:
        ws, prev, Z = gate
        gt = PairGate(ws.data_ptr(), prev.data_ptr(), Z)
    code = lib("cell_pair.cu").pair_launch(
        stage, J.data_ptr(), None if I2 is None else I2.data_ptr(),
        out.data_ptr(), geom, prm, gt, _stream(J))
    _check(code, f"pair stage {stage}")


def pair_gate(act, ws, grid, Z: int):
    """K2g's gate pass (cell_pair.cu gate_pass) into ws."""
    code = lib("cell_pair.cu").pair_gate(
        act.data_ptr(), _geom(grid), Z, ws.data_ptr(), _stream(act))
    _check(code, "pair gate pass")


def pair_launch_column(stage: int, J, I2, out, grid, cfg, K3d: float,
                       zseg: int, stats=None):
    """K11: the column launch in segments of zseg cells."""
    geom, prm = _pair_args(grid, cfg, K3d, stats)
    code = lib("cell_pair.cu").pair_launch_column(
        stage, J.data_ptr(), None if I2 is None else I2.data_ptr(),
        out.data_ptr(), geom, prm, zseg, _stream(J))
    _check(code, f"column pair stage {stage}")


def pair_smem(stage: int, cap: int, bf16: bool = False) -> int:
    """Bytes of dynamic shared memory a block of pair stage `stage` takes
    at `cap` (every launch form of a stage takes the same; K10's with
    bf16 its mxu_bf16 form), from cell_pair.cu's own formulas."""
    nbytes = lib("cell_pair.cu").pair_smem(stage, cap, int(bf16))
    if nbytes < 0:
        raise ValueError(f"pair_smem: no stage {stage}")
    return nbytes


def fma_ceiling_launch(x, out, nchain: int, length: int):
    code = lib("probes.cu").fma_ceiling(x.data_ptr(), out.data_ptr(),
                                        x.numel(), nchain, length,
                                        _stream(x))
    _check(code, f"fma_ceiling nchain={nchain}")


def staging_launch(variant: int, src, starts, out, K: int,
                   library: str = "probes.cu"):
    """P2-P4: one call of staging variant `variant` adds its fold into
    out."""
    code = lib(library).staging(
        variant, src.data_ptr(), starts.data_ptr(), starts.shape[1],
        out.data_ptr(), src.shape[0], src.shape[1], out.shape[0] // 8, K,
        _stream(src))
    _check(code, f"staging variant {variant}")


# P5's designs (csrc/probes.cu mma_micro): "wgmma_serial" is the wgmma
# kernel with its overlap switched off, for measuring the overlap
MMA_DESIGNS = {"mma_sync": 0, "wgmma": 1, "wgmma_serial": 2}


def mma_design(design: str, mode: int) -> int:
    """The C index of P5's design, refusing an unknown design or mode, or
    mode 0 (no product) under a wgmma design."""
    if design not in MMA_DESIGNS:
        raise ValueError(f"mma_micro: design {design!r}, one of "
                         f"{tuple(MMA_DESIGNS)}")
    if mode not in (0, 1, 2, 3):
        raise ValueError(f"mma_micro: mode {mode}, one of 0-3")
    if mode == 0 and design != "mma_sync":
        raise ValueError("mma_micro: mode 0 (none) has no product; only "
                         "the mma_sync design's loop runs it")
    return MMA_DESIGNS[design]


def mma_micro_launch(design: str, mode: int, x, out, ncell: int,
                     vpu_flops: int, library: str = "probes.cu"):
    """P5: one call of design `design` in mode `mode` writes the cells'
    block into out (library: probes.cu or one of its VARIANTS)."""
    d = mma_design(design, mode)
    code = lib(library).mma_micro(d, mode, x.data_ptr(), out.data_ptr(),
                                  ncell, vpu_flops, _stream(x))
    _check(code, f"mma_micro {design} mode {mode}")


def mma_micro_info(design: str, mode: int) -> dict:
    """What P5's kernel of (design, mode) is built and launched with, on
    the current device: registers and local (spill) bytes a thread,
    static shared bytes, blocks an SM holds, SMs, and the grid at a cell
    count past it (0: a block per cell)."""
    d = mma_design(design, mode)
    info = (ctypes.c_int * 6)()
    _check(lib("probes.cu").mma_micro_info(d, mode, info),
           f"mma_micro_info {design} mode {mode}")
    return dict(zip(("registers", "local_bytes", "shared_bytes",
                     "blocks_per_sm", "sms", "grid"), info))


def tma_encoder(library: str = "probes.cu") -> int:
    """How a build of probes.cu reaches cuTensorMapEncodeTiled: 1
    through the runtime's driver entry point, 2 linked against libcuda,
    0 not at all."""
    return lib(library).tma_encoder()
