"""Command-line front end of the port (reference: main/src/sphexa/
sphexa.cpp:66-194).

    python -m sphexa_tpu_torch.main --init sedov -n 50 -s 100 -w 25 -o dump.h5

Counterpart of sphexa_tpu/main.py, with the same flags, --prop choices
and defaults: it builds the initializer, the propagator and the writer,
then runs the iteration loop (step -> fail-stop check -> re-grid / box
growth -> observables -> output triggers). Restart with
--init path.h5[:step] or --init path.txt[:step].

It runs on the GPU, and raises without one. SPHEXA_PLATFORM=cpu (the
JAX CLI's platform variable) runs it on the CPU, through the kernels'
plain PyTorch versions.

Propagators: ve (the gather path, propagator/ve.py; the default), std
(the std formulation on the gather path, propagator/std.py),
turbulence-ve (the gather path with OU stirring, propagator/turb_ve.py),
ve-pallas (make_ve_step_cellmajor: K1, K3-K7), ve-bdt (BdtVE: K1, K2g),
turbulence-ve-bdt (TurbBdtVE: K1, K2g and the stirring), the h-tier
zoom grids ve-tiered (make_ve_step_tiered: K3-K7 on every tier grid),
ve-tiered-resident (make_ve_step_tiered_resident) and ve-tiered-bdt
(TieredBdtVE: K2g on every tier grid; SPHEXA_BDT_RUNGS rungs, default
4), nbody, and std-cooling (the std step with radiative cooling,
propagator/std_cooling.py; the case's cooling parameters under the
settings file's cooling:: keys, the chemistry carried in extras). The
tiered props plan their tiers from the current state (choose_tiers_auto,
cap_max 128) and re-plan them on a fold.
Cases: sedov, noh, isobaric-cube, gresho-chan, kelvin-helmholtz,
wind-shock, evrard and turbulence (init/factory.py), and evrard-cooling
(init/evrard_cooling.py, which sets --prop std-cooling); --glass
installs a glass template for the glass-tiled cases (init/glass.py).
--split S > 1 upsamples an HDF5 restart S-fold along the Hilbert curve
(io/hdf5.load_split_checkpoint); --viz-every N renders a PNG every N
iterations (io/viz.py); --profile records the run with torch.profiler,
writes ./sphexa-trace and prints a ms-a-step table (util/xprofile.py).
The multi-device props ve-hilbert, ve-pallas-sharded, ve-bdt-sharded,
turbulence-ve-bdt-sharded and ve-tiered-sharded run through
propagator/multichip.MultiChipAdapter on SPHEXA_NUM_DEVICES shards (the
JAX CLI's variable; the shards go round robin over the devices the port
runs on, so on one card every shard is a thread on cuda:0); with fewer
than 2 shards the adapter exits. ve-pallas-tiles raises
NotImplementedError naming the ROADMAP item that will port it.
--debug-nans checks after each step that every row of the state is
finite and raises FloatingPointError naming the first field that is
not (jax_debug_nans at a step's granularity).
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time
import types

import numpy as np
import torch

from sphexa_tpu_torch.propagator.multichip import MULTICHIP_PROPS
from sphexa_tpu_torch.sfc.box import Boundary
from sphexa_tpu_torch.util.device import host, resolve_device

PROPS = ["ve", "std", "ve-pallas", "ve-tiered", "ve-tiered-resident",
         "ve-tiered-bdt", "ve-bdt", "nbody", "turbulence-ve",
         "turbulence-ve-bdt", "std-cooling", "ve-hilbert",
         "ve-pallas-sharded", "ve-bdt-sharded", "ve-tiered-sharded",
         "turbulence-ve-bdt-sharded", "ve-pallas-tiles"]

# props the port does not run yet -> the ROADMAP Queue 1 item porting them
_REFUSED_PROPS = {}

# the slot-frame engines: diag.max_cell_count counts dropped particles
# (the tiered ones: the fold, ve-tiered-sharded's through the adapter)
TIERED_PROPS = ("ve-tiered", "ve-tiered-resident", "ve-tiered-bdt")
_RETIER_PROPS = TIERED_PROPS + ("ve-tiered-sharded",)
_SLOT_FRAME = ("ve-pallas", "ve-bdt", "turbulence-ve-bdt") + _RETIER_PROPS


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to sphexa_tpu_torch yet (ROADMAP Queue 1 "
        f"{item})")


def _device() -> torch.device:
    """SPHEXA_PLATFORM=cpu runs on the CPU; unset (or cuda/gpu), on the
    GPU, raising when there is none."""
    plat = os.environ.get("SPHEXA_PLATFORM", "")
    if plat == "cpu":
        return torch.device("cpu")
    if plat not in ("", "cuda", "gpu"):
        raise ValueError(f"SPHEXA_PLATFORM={plat!r}: sphexa_tpu_torch runs "
                         f"on 'cpu' or the GPU ('cuda', 'gpu' or unset)")
    return resolve_device(None)


def _is_output_step(it: int, spec: str) -> bool:
    """Integer specs trigger every N iterations
    (reference: isOutputStep, io/arg_parser.hpp)."""
    try:
        v = int(spec)
    except ValueError:
        return False
    return v > 0 and it % v == 0


def _is_output_time(t1: float, t2: float, spec: str) -> bool:
    """Float specs trigger when a multiple of the interval falls in
    (t1, t2] (reference: isOutputTime)."""
    try:
        int(spec)
        return False
    except ValueError:
        pass
    try:
        f = float(spec)
    except ValueError:
        return False
    return f > 0 and math.floor(t2 / f) > math.floor(t1 / f + 1e-12)


def _is_extra_output(spec: str, it: int, t1: float, t2: float) -> bool:
    """--wextra: integer tokens are iterations, float tokens times in
    (t1, t2]."""
    for tok in (spec or "").split(","):
        tok = tok.strip()
        if not tok:
            continue
        try:
            if int(tok) == it:
                return True
            continue
        except ValueError:
            pass
        if t1 < float(tok) <= t2:
            return True
    return False


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="sphexa-tpu-torch",
                                description="SPH simulation on one GPU "
                                            "(the PyTorch/CUDA port)")
    p.add_argument("--init", required=True,
                   help="test case name (sedov, noh, ...) or checkpoint "
                        "file.h5[:step] / dump.txt[:step] to restart from")
    p.add_argument("-n", type=int, default=50,
                   help="cube side; N = n^3 particles")
    p.add_argument("-s", "--steps", type=int, default=10,
                   help="number of iterations")
    p.add_argument("--sim-time", type=float, default=None,
                   help="stop when simulation time reached")
    p.add_argument("--prop", default="ve", choices=PROPS,
                   help="propagator choice (reference: --prop); the port "
                        "refuses the multi-device props (ve-hilbert, "
                        "ve-pallas-sharded, ve-bdt-sharded, "
                        "ve-tiered-sharded, turbulence-ve-bdt-sharded, "
                        "ve-pallas-tiles)")
    p.add_argument("-w", "--output-every", default="0",
                   help="output frequency: integer = every N iterations, "
                        "float = every dt of simulation time (reference "
                        "isOutputStep/isOutputTime, sphexa.cpp:159-162); "
                        "0 = never")
    p.add_argument("--wextra", default="",
                   help="comma list of extra output triggers: integer "
                        "iteration numbers and/or float sim times "
                        "(reference --wextra)")
    p.add_argument("--duration", type=float, default=None,
                   help="wall-clock limit in seconds: stop (and write a "
                        "final output if writing is enabled) once "
                        "exceeded (reference --duration, sphexa.cpp:156)")
    p.add_argument("-o", "--outfile", default="dump.sphexa.h5")
    p.add_argument("--ascii", action="store_true", help="ASCII output")
    p.add_argument("--constants", default="constants.txt",
                   help="per-step observables file")
    p.add_argument("--dt0", type=float, default=None,
                   help="override initial timestep")
    p.add_argument("--split", type=int, default=1,
                   help="upsample a checkpoint restart N-fold along the "
                        "Hilbert curve (FileSplitInit analog)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="print per-kernel timings (torch.profiler; the "
                        "trace goes to ./sphexa-trace)")
    p.add_argument("-f", "--fields", default="rho,p",
                   help="comma list of DERIVED columns to add to each "
                        "output step beyond the conserved set "
                        "(available: rho, p; reference -f outputFields, "
                        "sphexa.cpp:86)")
    p.add_argument("--glass", default=None,
                   help="pre-relaxed glass template file (HDF5 with "
                        "x/y/z or .npz) used by the glass-tiled cases "
                        "(reference --glass, sphexa.cpp:82); default: "
                        "a self-relaxed cached template")
    p.add_argument("--debug-nans", action="store_true",
                   help="after every step, check that every row of the "
                        "state is finite; raise FloatingPointError naming "
                        "the first field that is not")
    p.add_argument("--viz-every", type=int, default=0,
                   help="render a PNG slice every N iterations (in-situ "
                        "viz hook; 0 = off)")
    return p.parse_args(argv)


def build_sim(args, device):
    from sphexa_tpu_torch.config import SphConfig
    from sphexa_tpu_torch.init.settings import (apply_settings,
                                                load_settings_file,
                                                parse_init_spec)

    cfg = SphConfig()
    extras = {}
    kind, name, extra = parse_init_spec(args.init)
    if kind == "checkpoint":
        from sphexa_tpu_torch.io.hdf5 import (load_bdt_state,
                                              load_checkpoint,
                                              load_split_checkpoint,
                                              load_turbulence_state)
        path, step = name, extra
        if args.split > 1:
            # upsampled restart (FileSplitInit, file_init.hpp:103)
            state, box, cfg = load_split_checkpoint(path, cfg, args.split,
                                                    step=step, device=device)
            return state, box, cfg, extras
        state, box, cfg = load_checkpoint(path, cfg, step=step,
                                          device=device)
        ts = load_turbulence_state(path, step)
        if ts is not None:
            extras["turb"] = ts
        bs = load_bdt_state(path, step)
        if bs is not None:
            extras["bdt"] = bs
        return state, box, cfg, extras
    if kind == "ascii":
        # column dumps carry no integrator history: see
        # io/ascii.load_ascii_checkpoint
        from sphexa_tpu_torch.io.ascii import load_ascii_checkpoint
        state, box = load_ascii_checkpoint(name, cfg, step=extra,
                                           dt0=args.dt0, device=device)
        if box is None:
            raise SystemExit("ASCII dump has no box header; cannot "
                             "restart from a pre-box-format file")
        return state, box, cfg, extras
    if extra:  # 'case:settings.h5' override layering (settings.hpp:42)
        settings = load_settings_file(extra)
        cfg = apply_settings(cfg, settings)
        extras["settings"] = settings
        args.init = name
    extras["case"] = args.init
    if args.init == "evrard-cooling":
        from sphexa_tpu_torch.init.evrard_cooling import init_evrard_cooling
        state, box, cfg, ex = init_evrard_cooling(args.n, cfg, dt0=args.dt0,
                                                  device=device)
        extras.update(ex)
        args.prop = "std-cooling"
    else:
        from sphexa_tpu_torch.init.factory import make_initializer
        state, box, cfg = make_initializer(args.init)(
            args.n, cfg, dt0=args.dt0, device=device)
    if "settings" in extras:  # file overrides win over case constants
        cfg = apply_settings(cfg, extras["settings"])
    return state, box, cfg, extras


def _slot_grid(box, cfg, h_max, n, extras, state):
    """The slot-frame engines' grid: the joint scan sizes the cap from
    the REALIZED max cell count plus the loop's fail-stop headroom
    (extras['cap_headroom'], raised on slot overflow); without a state,
    the occupancy heuristic."""
    from sphexa_tpu_torch.ops.cellmajor import (choose_cap_and_grid,
                                                choose_cm_grid)
    if state is None:
        return choose_cm_grid(box, h_max * 1.25, n)
    alive = host(state.p.alive)
    headroom = int((extras or {}).get("cap_headroom", 8))
    _, grid = choose_cap_and_grid(
        box, h_max * 1.25, n, *(host(getattr(state.p, c))[alive]
                                for c in "xyz"),
        headroom=headroom)
    return grid


def _bdt_adapter(bdt, restore):
    """One call = one full rung cycle (2^(num_rungs-1) substeps) of
    BdtVE (or TurbBdtVE, whose OU state the adapter exposes as .turb for
    the writer), with the main loop's step contract."""

    class _BdtAdapter:
        def __init__(self):
            self.bst = None
            self.bdt = bdt
            if getattr(bdt, "turb", None) is not None:
                self.turb = bdt.turb

        def checkpoint_state(self, n_capacity):
            """Rung state for the writer (timestep.h:29-34 analog);
            run_cycle always leaves substep at a cycle boundary."""
            return bdt.checkpoint_rungs(self.bst, n_capacity)

        def __call__(self, state):
            if self.bst is None:
                self.bst = bdt.bind_bdt(state)
                if restore is not None:
                    # restart: resume the checkpointed rung assignment
                    self.bst = bdt.restore_rungs(
                        self.bst, restore["rung"], restore["dt_m1k"],
                        restore["dt_min"])
            self.bst, diags = bdt.run_cycle(self.bst)
            d = diags[-1]
            out = bdt.unbind(self.bst.rv, state.p.n)
            fr = float(np.mean([float(x.active_frac) for x in diags]))
            print(f"# bdt: active fraction {fr:.2f}, rungs "
                  f"{host(d.rung_hist).tolist()}")
            diag = types.SimpleNamespace(
                dt=d.dt, ttot=d.ttot, etot=d.etot, ecin=d.ecin, eint=d.eint,
                egrav=0.0,
                h_max=torch.max(torch.where(out.p.alive, out.p.h, 0.0)),
                nc_mean=0.0, max_nc=0,
                max_cell_count=max(int(x.overflow) for x in diags),
                maxvsignal=0.0)
            return out, diag

    return _BdtAdapter()


def make_stepper(args, box, cfg, h_max, n, extras=None, state=None,
                 device=None):
    """(step function, grid) for args.prop on `device`."""
    extras = extras or {}
    if args.prop in _REFUSED_PROPS:
        _not_ported(f"--prop {args.prop}", _REFUSED_PROPS[args.prop])
    if args.prop in MULTICHIP_PROPS:
        # every shard of SPHEXA_NUM_DEVICES (sphexa.cpp under mpiexec -np
        # N); the adapter owns distribution and fail-stops
        from sphexa_tpu_torch.propagator.multichip import MultiChipAdapter
        adapter = MultiChipAdapter(args.prop, box, cfg, state, h_max,
                                   quiet=args.quiet, extras=extras,
                                   device=device)
        return adapter, adapter.grid
    if args.prop in TIERED_PROPS:
        return _tiered_stepper(args, box, cfg, state, device)
    if args.prop == "std-cooling":
        return _std_cooling_stepper(box, cfg, h_max, extras, device)
    if args.prop == "nbody":
        from sphexa_tpu_torch.propagator.nbody import make_nbody_step
        return make_nbody_step(box, cfg, device=device), None
    if args.prop == "ve-pallas":
        from sphexa_tpu_torch.propagator.ve_cellmajor import \
            make_ve_step_cellmajor
        grid = _slot_grid(box, cfg, h_max, n, extras, state)
        return make_ve_step_cellmajor(box, grid, cfg, device=device), grid
    if args.prop in ("ve-bdt", "turbulence-ve-bdt"):
        from sphexa_tpu_torch.propagator.ve_bdt import BdtVE, TurbBdtVE
        grid = _slot_grid(box, cfg, h_max, n, extras, state)
        if args.prop == "turbulence-ve-bdt":
            # reference TurbVeBdtProp (turb_ve.hpp:114-118)
            bdt = TurbBdtVE(box, grid, cfg, turb=_turbulence(args, extras),
                            device=device)
        else:
            bdt = BdtVE(box, grid, cfg, device=device)
        return _bdt_adapter(bdt, extras.get("bdt")), grid
    from sphexa_tpu_torch.neighbors import CellGrid, choose_level
    grid = CellGrid(choose_level(box, h_max * 1.25))
    if args.prop == "turbulence-ve":
        from sphexa_tpu_torch.propagator.turb_ve import TurbVeProp
        return TurbVeProp(box, grid, cfg, turb=_turbulence(args, extras),
                          device=device), grid
    if args.prop == "std":
        from sphexa_tpu_torch.propagator.std import make_std_step
        return make_std_step(box, grid, cfg, device=device), grid
    from sphexa_tpu_torch.propagator.ve import make_ve_step
    return make_ve_step(box, grid, cfg, device=device), grid


def _std_cooling_stepper(box, cfg, h_max, extras, device):
    """(step function, grid) of std-cooling (JAX main.py:297-322): the
    case's CoolingParams (defaults without one) under the settings
    file's cooling::<name> keys (the reference's GRACKLE attribute
    surface, cooler.hpp:130). With extras["chem"], the step carries the
    chemistry there: each call, an accepted or a fail-stopped one,
    stores the chemistry it returns, permuted by its cell sort. The
    loop's retry restores the state only (ROADMAP Queue 3)."""
    from sphexa_tpu_torch.neighbors import CellGrid, choose_level
    from sphexa_tpu_torch.physics.cooling import CoolingParams
    from sphexa_tpu_torch.propagator.std_cooling import make_std_cooling_step
    grid = CellGrid(choose_level(box, h_max * 1.25))
    cparams = extras.get("cooling_params", CoolingParams())
    if "settings" in extras and any(
            k.startswith("cooling::") for k in extras["settings"]):
        merged = dict(cparams.to_settings())
        merged.update({k: v for k, v in extras["settings"].items()
                       if k.startswith("cooling::")})
        cparams = CoolingParams.from_settings(merged)
    if "chem" not in extras:
        return make_std_cooling_step(box, grid, cfg, params=cparams,
                                     device=device), grid
    raw = make_std_cooling_step(box, grid, cfg, params=cparams,
                                with_chemistry=True, device=device)

    def step_with_chem(state):
        new_state, diag, extras["chem"] = raw(state, extras["chem"])
        return new_state, diag

    return step_with_chem, grid


def _tiered_stepper(args, box, cfg, state, device):
    """(step function, tiers) of a tiered prop: the h-tier zoom grids
    planned from the current state (JAX main.py:207-296)."""
    from sphexa_tpu_torch.propagator.ve_tiered import (
        choose_tiers_auto, make_ve_step_tiered, make_ve_step_tiered_resident)
    if state is None:
        raise ValueError(f"--prop {args.prop} plans its tiers from the "
                         f"current state")
    p = state.p
    tiers = choose_tiers_auto(box, *(host(getattr(p, c)) for c in "xyzh"),
                              alive=host(p.alive), cap_max=128,
                              verbose=not args.quiet)
    if not args.quiet:
        print("# tiers: " + "; ".join(
            f"h[{t.h_lo:.3g},{t.h_hi:.3g}) n={t.grid.n} cap={t.grid.cap}"
            for t in tiers))
    if args.prop == "ve-tiered-bdt":
        from sphexa_tpu_torch.propagator.ve_tiered_bdt import TieredBdtVE
        nr = int(os.environ.get("SPHEXA_BDT_RUNGS", "4"))
        return _tiered_bdt_adapter(
            TieredBdtVE(box, tiers, cfg, num_rungs=nr, device=device),
            args.quiet), tiers
    if args.prop == "ve-tiered-resident":
        bind, rstep = make_ve_step_tiered_resident(box, tiers, cfg,
                                                   device=device)
        return _tiered_resident_adapter(bind, rstep), tiers
    return make_ve_step_tiered(box, tiers, cfg, device=device), tiers


def _tiered_resident_adapter(bind, rstep):
    """The resident tiered step with the main loop's contract: the carry
    rides in the adapter; a re-tier (a fresh make_stepper) binds anew."""

    class _TieredResAdapter:
        def __init__(self):
            self.carry = None

        def __call__(self, state):
            if self.carry is None:
                self.carry = bind(state)
            self.carry, diag = rstep(self.carry)
            return self.carry.state, diag

    return _TieredResAdapter()


def _tiered_bdt_adapter(teng, quiet):
    """One call = one rung cycle of TieredBdtVE; a fold routes through
    the main loop's re-tier path. Its diagnostics are the JAX adapter's
    minimal set, max_nc 0 included (ROADMAP Queue 3)."""

    class _TieredBdtAdapter:
        def __init__(self):
            self.bst = None
            self.teng = teng

        def __call__(self, state):
            if self.bst is None:
                self.bst = teng.bind(state)
            self.bst, diags = teng.run_cycle(self.bst, check=False)
            d = diags[-1]
            out = teng.unbind(self.bst)
            if not quiet:
                fr = float(np.mean([float(x.active_frac) for x in diags]))
                print(f"# tiered-bdt: active fraction {fr:.2f}, rungs "
                      f"{host(d.rung_hist).tolist()}")
            diag = types.SimpleNamespace(
                dt=d.dt, ttot=d.ttot, etot=d.etot, ecin=d.ecin, eint=d.eint,
                egrav=d.egrav,
                h_max=torch.max(torch.where(out.p.alive, out.p.h, 0.0)),
                nc_mean=0.0, max_nc=0,
                max_cell_count=max(int(x.fold) for x in diags),
                maxvsignal=0.0,
                nf_truncated=max(int(x.nf_truncated) for x in diags))
            return out, diag

    return _TieredBdtAdapter()


def _turbulence(args, extras):
    """A fresh OU driver from the reference constants, or, on an HDF5
    restart, the dump's phases and RNG state. As in the JAX CLI, every
    make_stepper call (a re-grid too) starts from there (ROADMAP Queue
    3)."""
    from sphexa_tpu_torch.physics.turbulence import TurbulenceData
    turb = TurbulenceData.create(verbose=not args.quiet)
    if "turb" in extras:
        turb.restore(extras["turb"])
    return turb


def _check_finite(state):
    """--debug-nans: every row of the state finite, else
    FloatingPointError naming the first field that is not."""
    from sphexa_tpu_torch.state import _FIELDS
    it = int(state.iteration) - 1
    for name in _FIELDS[:-1]:
        if not bool(torch.isfinite(getattr(state.p, name)).all()):
            raise FloatingPointError(
                f"--debug-nans: non-finite values in field {name!r} after "
                f"iteration {it}")
    for name in ("ttot", "dt"):
        if not bool(torch.isfinite(getattr(state, name))):
            raise FloatingPointError(
                f"--debug-nans: non-finite {name} after iteration {it}")


def _grow_box(box, bounds, h_max):
    """Open boundaries: when particles approach an open face, the box
    grows by 15% of its largest edge past them (the static-shape analog
    of the reference's per-sync makeGlobalBox, box_mpi.hpp:84). Returns
    the new box, or None when no face is near."""
    b = np.asarray(host(bounds), np.float64)
    margin = 2.0 * h_max
    grow = (
        (box.bx == Boundary.open
         and (b[0] < box.xmin + margin or b[1] > box.xmax - margin))
        or (box.by == Boundary.open
            and (b[2] < box.ymin + margin or b[3] > box.ymax - margin))
        or (box.bz == Boundary.open
            and (b[4] < box.zmin + margin or b[5] > box.zmax - margin)))
    if not grow:
        return None
    pad = 0.15 * max(box.lx, box.ly, box.lz)
    return box.with_bounds(
        min(box.xmin, b[0] - pad), max(box.xmax, b[1] + pad),
        min(box.ymin, b[2] - pad), max(box.ymax, b[3] + pad),
        min(box.zmin, b[4] - pad), max(box.zmax, b[5] + pad))


def main(argv=None):
    args = parse_args(argv)
    device = _device()
    if args.glass:
        from sphexa_tpu_torch.init.glass import set_glass_template
        set_glass_template(args.glass)
    state, box, cfg, extras = build_sim(args, device)

    alive = host(state.p.alive)
    n_active = int(alive.sum())
    h_max = float(np.max(host(state.p.h)[alive]))
    step_fn, grid = make_stepper(args, box, cfg, h_max, n_active, extras,
                                 state=state, device=device)

    write_enabled = (args.output_every not in ("0", "") or bool(args.wextra))
    writer = None
    if write_enabled:
        if args.ascii:
            from sphexa_tpu_torch.io.ascii import AsciiWriter
            writer = AsciiWriter(args.outfile)
        else:
            from sphexa_tpu_torch.io.hdf5 import HDF5Writer
            if os.path.exists(args.outfile):
                os.remove(args.outfile)
            writer = HDF5Writer(args.outfile)
            if "settings" in extras:  # provenance (settings.hpp:45)
                writer.write_file_attrs(extras["settings"])

    from sphexa_tpu_torch.observables import conserved_quantities
    from sphexa_tpu_torch.observables.factory import make_observables

    # settings-keyed observable selection (observables/factory.hpp:48-66)
    obs = make_observables(extras.get("case"), extras.get("settings"))
    const_f = None
    if args.constants:
        write_header = not (os.path.exists(args.constants)
                            and os.path.getsize(args.constants) > 0)
        const_f = open(args.constants, "a")
        if write_header:
            const_f.write(obs.header() + "\n")

    viz = None
    if args.viz_every:
        from sphexa_tpu_torch.io.viz import VizHook
        viz = VizHook(every=args.viz_every)

    if not args.quiet:
        print(f"# sphexa-tpu-torch: {args.init} N={n_active} "
              f"prop={args.prop} grid={grid} device={device}", flush=True)

    prof = None
    if args.profile:
        # per-kernel device times (the analog of the reference's
        # per-substage Timer, util/timer.hpp): traces to ./sphexa-trace
        from sphexa_tpu_torch.util import xprofile
        prof = xprofile.start_trace(device)

    try:
        t_start = time.perf_counter()
        # the resident tiered step takes no retry point (the JAX engine
        # donates its frame): on a fold it re-tiers from the current state
        can_retry = args.prop != "ve-tiered-resident"
        consec_fails = 0
        it = 0
        while it < args.steps:
            t0 = time.perf_counter()
            # retry point: a fail-stopped step ran with truncated
            # candidate sets, so its outputs are discarded (the reference
            # throws instead, xmass_gpu.cu:120-128). No stepper writes
            # into its input, so holding it is free.
            prev_state = state if can_retry else None
            state, diag = step_fn(state)
            dt_wall = time.perf_counter() - t0
            if args.debug_nans:
                _check_finite(state)

            # fail-stop check FIRST: a truncated step must not be logged,
            # written, or used for grid adaptation. diag.max_cell_count
            # is, for the slot-frame engines, a COUNT of dropped particles
            # (any nonzero value is truncated physics) and, for the
            # gather path, the realized max cell occupancy (bad only past
            # the gather capacity cell_cap)
            slot_frame = args.prop in _SLOT_FRAME
            cell_bad = (int(diag.max_cell_count) > 0 if slot_frame
                        else int(diag.max_cell_count) > cfg.cell_cap)
            # ve-pallas-tiles: a tile outgrew its static window
            replan = bool(getattr(diag, "replan", False))
            if int(diag.max_nc) > cfg.ngpad or cell_bad or replan:
                consec_fails += 1
                if consec_fails > 3:
                    raise RuntimeError(
                        f"capacity overflow persists after "
                        f"{consec_fails - 1} re-grids (max_nc="
                        f"{int(diag.max_nc)}, max_cell="
                        f"{int(diag.max_cell_count)})")
                if prev_state is not None:
                    state = prev_state   # discard the truncated step
                if args.prop in _RETIER_PROPS:
                    # re-tier: make_stepper re-plans the tiers from the
                    # state's h distribution
                    if not args.quiet:
                        print(f"# tier fold ({int(diag.max_cell_count)}): "
                              f"re-tiering from "
                              f"{'restored' if can_retry else 'current'} "
                              f"state", file=sys.stderr)
                elif replan:
                    # the new adapter plans the windows from the
                    # restored state (plan_tile_caps)
                    if not args.quiet:
                        print("# tile windows outgrown: re-planning from "
                              "the restored state", file=sys.stderr)
                elif slot_frame:
                    # slot overflow: re-pick (cap, grid) with more
                    # headroom from the restored positions
                    extras["cap_headroom"] = int(
                        extras.get("cap_headroom", 8)) + 48
                    print(f"# slot overflow ({int(diag.max_cell_count)}): "
                          f"re-gridding with headroom "
                          f"{extras['cap_headroom']}", file=sys.stderr)
                else:
                    cfg = cfg.replace(
                        ngpad=max(cfg.ngpad, 2 * int(diag.max_nc)),
                        cell_cap=max(cfg.cell_cap,
                                     2 * int(diag.max_cell_count)))
                    print(f"# re-gridded with larger caps: ngpad="
                          f"{cfg.ngpad} cell_cap={cfg.cell_cap}",
                          file=sys.stderr)
                h_max = float(np.max(host(state.p.h)[host(state.p.alive)]))
                step_fn, grid = make_stepper(args, box, cfg, h_max,
                                             n_active, extras, state=state,
                                             device=device)
                continue   # retry this iteration (it is not consumed)
            consec_fails = 0

            # grid resolution follows h growth
            new_h_max = float(diag.h_max)
            if new_h_max > h_max * 1.25:
                h_max = new_h_max
                step_fn, grid = make_stepper(args, box, cfg, h_max,
                                             n_active, extras, state=state,
                                             device=device)
                if not args.quiet:
                    print(f"# re-gridded for h_max={h_max:.4g}: {grid}")

            # dynamic global box for open boundaries
            if getattr(diag, "bounds", None) is not None \
                    and Boundary.open in (box.bx, box.by, box.bz):
                grown = _grow_box(box, diag.bounds, h_max)
                if grown is not None:
                    box = grown
                    step_fn, grid = make_stepper(args, box, cfg, h_max,
                                                 n_active, extras,
                                                 state=state, device=device)
                    if not args.quiet:
                        print(f"# box expanded to [{box.xmin:.3g},"
                              f"{box.xmax:.3g}]^3-ish; re-gridded")

            q = conserved_quantities(state.p, cfg, egrav=float(diag.egrav))
            if const_f:
                const_f.write(obs.line(state, diag, cfg, box) + "\n")
                const_f.flush()

            if not args.quiet:
                # reference-style "### Check" iteration line
                # (ipropagator.hpp:100-128)
                h_nonconv = getattr(diag, "h_nonconv", None)
                print(f"### Check ### iter {int(state.iteration)-1}: "
                      f"t={float(diag.ttot):.6g} dt={float(diag.dt):.4g} "
                      f"etot={float(q.etot):.8g} ecin={float(q.ecin):.6g} "
                      f"eint={float(q.eint):.6g} egrav={float(q.egrav):.6g} "
                      f"nc~{float(diag.nc_mean):.0f} "
                      + (f"h_nonconv={int(h_nonconv)} "
                         if h_nonconv is not None and int(h_nonconv) else "")
                      + f"wall={dt_wall*1e3:.0f}ms", flush=True)
            t_now = float(diag.ttot)
            t_prev = t_now - float(diag.dt)
            wall_exceeded = (args.duration is not None
                             and time.perf_counter() - t_start
                             > args.duration)
            triggered = (_is_output_step(it + 1, args.output_every)
                         or _is_output_time(t_prev, t_now, args.output_every)
                         or _is_extra_output(args.wextra, it + 1, t_prev,
                                             t_now)
                         or (wall_exceeded and write_enabled))
            if writer and triggered:
                turb_state = None
                if hasattr(step_fn, "turb"):
                    turb_state = step_fn.turb.checkpoint_state()
                bdt_state = None
                if hasattr(step_fn, "checkpoint_state"):
                    bdt_state = step_fn.checkpoint_state(state.p.n)
                # derived output columns (-f) for the reference's
                # compare_*.py comparators
                wanted = {t.strip() for t in args.fields.split(",")
                          if t.strip()}
                out_fields = {}
                for name in wanted:
                    v = getattr(diag, name, None)
                    if isinstance(v, torch.Tensor) and v.ndim == 1:
                        out_fields[name] = v
                writer.write_step(state, cfg, box, fields=out_fields or None,
                                  turb_state=turb_state, bdt_state=bdt_state)
            if viz:
                viz.execute(state, box, int(state.iteration) - 1)

            it += 1
            if args.sim_time is not None and float(diag.ttot) >= args.sim_time:
                break
            if wall_exceeded:
                if not args.quiet:
                    print(f"# wall-clock limit {args.duration}s reached")
                break

        if prof is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            done, prof = prof, None    # stopped here, not in the finally
            xprofile.stop_trace(done)
            print(f"# profile trace written to ./{xprofile.TRACE_DIR}")
            xprofile.print_table(done, steps=max(int(state.iteration), 1))

        wall = time.perf_counter() - t_start
        if not args.quiet:
            its = int(state.iteration) - 1
            print(f"# done: {its} iterations, {wall:.1f}s wall, "
                  f"{n_active * max(it, 1) / wall / 1e6:.2f}M "
                  f"particle-updates/s")
    finally:
        if prof is not None:   # a raise inside the loop
            prof.stop()
        if writer:
            writer.close()
        if const_f:
            const_f.close()
    return state


if __name__ == "__main__":
    main()
