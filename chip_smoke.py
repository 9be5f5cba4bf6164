#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sphexa_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from sphexa_tpu_torch/csrc (nvcc, in parallel);
  3. kernel check at Sedov 30^3: every kernel against its plain PyTorch
     version on identical, perturbed inputs, with the CPU tests'
     tolerances; (a) each gated stage (K2g) against its gated plain
     version on a seeded activity pattern; then the resident engine on
     the card against the same engine on the CPU (plain versions) for 3
     steps at Sedov 10^3, and (b) the block-time-step engine BdtVE on the
     card against the CPU for two rung cycles at Sedov 10^3 (its CPU
     side in a child process from the build on, held after phase (k));
  4. the main path: ResidentVE on the card at Sedov 100^3 (1M particles),
     one warm-up step, then 10 timed steps with a forced rebin; launch
     counters are zeroed just before and read just after;
  5. each kernel timed at the main path's own inputs, beside its plain
     version, its bound and (K1) a library gather; K1 and the gather
     also split into device time (a CUDA graph of the launches) and
     host dispatch; K4's, K5's, K6's and K7's in-support pairs, warp
     body executions and lane efficiency counted on the card from their
     inputs; K3's walks counted by the kernel on the card and held
     equal to the count its inputs predict (one a slot, one more a
     controller round that moved its h); the registers and spills of
     K3-K7 from the build's ptxas output; the invalid interior slots of
     K4-K7 hold their fill values exactly (K4 1.0, the others 0);
  6. (c) the block-time-step path: BdtVE at Sedov 100^3, 4 rungs, one
     warm-up cycle, then 2 timed cycles of 8 substeps (counters zeroed
     just before, read just after; the gate pass pair_gate five times a
     substep); (d) each gated stage timed at the inputs of a substep
     that skips cells, beside the ungated stage, its gated plain
     version, its bound and the same launch with no active supercell;
     then the gate pass: its device count, list and supercell flags
     against supercell_active and its plain version, and its time
     alone;
  7. the moment-matmul and avClean bodies (SphConfig mxu_moments +
     mxu_momentum, + mxu_bf16, av_clean): (e) K8, K9, K10 (float32 and
     bf16) and K7c against their plain versions at Sedov 30^3, and the
     gated K8-K10 on the seeded activity pattern; (f) ResidentVE on the
     card against the CPU at 10^3 for 3 steps under each of the three
     configurations; (g) the main path under mxu_moments + mxu_momentum
     at Sedov 100^3, one warm-up step then 10 timed steps with a forced
     rebin (K8-K10 once a step, K5-K7 never), then 3 timed steps each
     under + mxu_bf16 and under av_clean, and BdtVE under the moment
     bodies for one timed cycle (the gated K8-K10); (h) each new kernel
     timed at those inputs beside its direct counterpart (K5, K6, K7),
     its plain version and its bound; K10's tensor-core blocks (issued,
     staged, dense) counted by the kernel on the card (a stats buffer)
     and held against the count its inputs predict (mm_block_counts),
     K9's lane counts and fill values (cell, K2g and K11 forms), and the
     registers and spills of every K8, K9 and K10 form;
  8. (i) the column launch K11: at Sedov 30^3 (perturbed) under each of
     the four configurations every column stage against its plain
     version and against the cell launch on the same inputs at several
     z-segments (interior slots bit-equal, the rest zero); at Sedov
     100^3 under each configuration the resident step with a
     column-mode pve for 3 steps against the cell-mode step from the
     same bound state (counters zeroed before each run), then each
     column stage timed at its z-segment and at the others, beside the
     cell launch;
  9. (j) the probes P1-P5: each swept at its script's sizes (counters
     zeroed before, read after), each kernel against its plain version
     (the TMA variants also through the libcuda build), the library
     yardsticks (index_select of the windows, torch.matmul of the
     products);
  10. (k) the slab-sharded engines, every shard a thread on the one
     card: K1z (ghost_refresh_xy) against its plain version on the
     100^3 D = 2 and D = 4 local grids and the 30^3 grid, 1-15 rows,
     periodic and open x-y, bit-equal; the sharded step (2 steps) and a
     ShardedBdtVE cycle on the card against the CPU at Sedov 12^3,
     D = 2; the sharded step at Sedov 100^3 sized by plan_slab, D = 2
     and D = 4, one warm-up then 5 timed steps (counters zeroed just
     before, read just after), each pair launch of one more step
     against its plain version on sampled cells (cap 256), the state
     after 3 steps against make_ve_step_cellmajor on the same global
     grid, and K1z (split as K1), the z exchange, migration and the
     pair kernels timed, K4-K7's lane counts, fill values and K3's
     walks at cap 256; ShardedBdtVE at
     100^3, D = 2, 4 rungs, one warm-up and one timed cycle, its rungs
     beside BdtVE's on the same global grid, and one more substep of
     the shards under PyTorch's sync check set to errors;
  11. (l) single-device self-gravity: each solver on the card against
     the same solver on the CPU (direct_gravity on 4096 seeded
     particles; fmm_gravity on Evrard 30 at level 5 with cuDNN's TF32
     left on, and on a seeded cluster whose leaves overflow leaf_cap,
     nf_truncated equal and nonzero; ewald_gravity on 512 particles in
     a periodic box; 3 N-body steps); ResidentVE (3 steps) and BdtVE
     (3 rungs, 2 cycles) on the card against the CPU at Evrard 10 under
     the FMM and the direct sum; Evrard 100 (523,984 particles, the
     planner's cap-768 grid) on ResidentVE with the FMM at level 6, one
     warm-up and 5 timed steps (counters zeroed just before, read just
     after), gated on overflow 0, nf_truncated 0, finite rows, energy
     drift < 5e-3 and bench.py's density L1 < 0.15, each step split
     into the hydro pipeline, P2M + M2M, M2L, L2L + L2P, P2P and the
     rest; K3-K7 at cap 768 against their plain versions on sampled
     cells, their fill values, their times, K1 on the open box
     bit-equal; BdtVE at Evrard 100 (4 rungs), one warm-up and one
     timed cycle;
  12. (m) the command line: make_ve_step (the gather path, --prop ve)
     on the card against the CPU at Sedov 10^3 (3 steps) and Evrard 10
     with the FMM (2 steps), the first step's cell permutation and
     neighbour counts equal, rows within 1e-5 of scale; main([...]) in
     this process at Sedov 100^3 (--dt0 3e-5) under --prop ve (2
     steps, each step split into the cell list, the neighbour list, the
     five stages, EOS and the rest, its device activities counted by
     torch.profiler), ve-pallas (5 steps) and ve-bdt (1 cycle): ms a
     step from CUDA events around each call of the step function, peak
     memory, the kernels' launches, energy drift < 5e-3 from the
     constants file, no fail-stop after the first accepted step, finite
     rows; python -m sphexa_tpu_torch.main as a subprocess (Evrard 30,
     3 steps, an ASCII dump, and a restart from it); the Sedov
     similarity constant alpha(5/3) = 0.4936 (scipy on the host);
  13. (n) subsonic turbulence, the std formulation and the remaining
     cases: TurbBdtVE (one cycle of 2 rungs), TurbVeProp and
     make_std_step (Noh; 2 steps each) on the card against the CPU at
     10^3; main([...]) in this process at turbulence 100^3 under --prop
     turbulence-ve-bdt (one warm-up and 2 timed cycles) and
     turbulence-ve (2 steps), --prop std at Noh 100^3 (2 steps), and
     gresho-chan, isobaric-cube, kelvin-helmholtz and wind-shock at
     n = 50 under --prop ve and ve-pallas (2 steps; kelvin-helmholtz
     and wind-shock under ve-pallas must meet the planner's refusal,
     EXPECTED_REFUSALS, and every other run must run),
     kelvin-helmholtz at n = 50 with --glass (a 2^3 template: its glass
     branch), gated on finite rows, one retried call a fail-stop (a
     re-grid, which may follow the first accepted step where h or the
     open box grows, as in the JAX CLI), the slot-frame props launching
     their kernels, the RMS Mach number growing under stirring and the
     energy drift < 5e-3 elsewhere; TurbBdtVE at 100^3 driven directly
     (one warm-up and one timed cycle, the rung histogram, a fully
     active substep split into the gated stages, the ghost refreshes,
     the stirring sum and the rest, each gated stage timed beside its
     ungated cell launch and its bound, one substep under the sync
     check), then each gated stage against its plain version on
     sampled cells of a fully active cap-128 check frame (the lattice
     perturbed as the Sedov checks are); TurbShardedBdtVE at 100^3,
     D = 2 (one warm-up and one timed cycle);
  14. (o) the h-tier zoom grids: main([...]) at Evrard 100 under
     --prop ve-tiered-resident, whose ladder (choose_tiers_auto,
     cap_max 128, planned on the host from the initial state) is
     printed tier by tier (band, grid, cap, slots, frame and owned rows)
     beside the uniform frame of phase (l), the band audit (C) at 0
     violations; on that ladder, under phase (l)'s FMM, the resident
     tiered step (one warm-up and 3 timed steps; rebuilds, folds,
     nf_truncated 0, energy drift, peak memory; the step split into the
     tiered SPH forces, gravity and the rest beside the uniform
     resident step of phase (l)), with --tiers the CLI's re-plan after
     the first step on that state (choose_tiers_robust), the
     particle-frame tiered step (1 + 2) and
     TieredBdtVE (4 rungs, one timed cycle: active fraction, rungs,
     fold); K3-K7 on every tier frame against their plain versions on
     sampled occupied cells, timed beside their bounds from each tier's
     in-support pairs (into the kernel rows as `tiers`), and K2g with
     its gate pass on the finest tier under a seeded activity pattern;
     main([...]) in this process at Evrard 100 under --prop ve-tiered
     and ve-tiered-bdt as under ve-tiered-resident (the FMM set on the
     steppers it makes: the CLI has no solver flag), where a run may
     end in the JAX CLI's own outcome, EXPECTED_TIER_FAULT (the re-plan
     that an h re-grid or a box growth asks for after an accepted step,
     choose_tiers_auto, finds no rung), with no fold before it and the
     calls before it gated as a whole run is (tier_fault_gates); and
     Sedov 100^3 under --prop ve-tiered (one tier, 2 steps);
  15. (p) radiative cooling, the split restart, --profile and
     --viz-every: (p1) make_std_cooling_step on the card against the CPU
     at Evrard-cooling n = 10 (2 steps, without and with chemistry,
     direct sum and FMM); (p2) main([...]) at --init evrard-cooling
     -n 100 (523,984 particles, the FMM at level 7 set on its steppers),
     2 accepted steps and an ASCII dump: ms a step, which of the hydro
     dt and dt_cool binds, the temperature range, fail-stops and
     re-grids, gated on finite rows, the chemistry's fractions in [0, 1]
     summing to 1, temp >= t_floor / temp_to_k, egrav < 0, nf_truncated
     0, no fail-stop after the first accepted step and etot not rising
     past 5e-3 of |e0|; (p3) Sedov 50^3 built on the card and split
     S = 8 by io/hdf5.split_state (1,000,000 particles), 2 steps of the
     CLI's ve-pallas stepper (K1, K3-K7; counters zeroed just before,
     read just after), gated on overflow 0, finite rows, the drift gate
     and the total mass; (p4) main([...]) at Sedov 100^3 under
     --prop ve-pallas --profile --viz-every 1 (2 steps): the trace
     written, the table's rows for K1 and K3-K7 with as many calls as
     their wrappers counted, a PNG a step (a line says so where
     matplotlib is missing, and that is not a pass);
  16. (q) multi-device through the command line, SPHEXA_NUM_DEVICES=2
     (every shard a thread on the card): the five props at Evrard,
     Sedov and turbulence 10 on the card against the CPU (the CPU runs
     in processes of their own, beside the card's runs); main([...]) at
     full size: ve-bdt-sharded at Evrard 100 (the slab FMM, the JAX
     slab plan CMGrid(n=18, cap=1664, nzi=9); its first cycle's rung
     histograms equal BdtVE's on the same global grid; 2 cycles, the
     second on the plan of the h re-grid after the first, both plans
     logged), ve-hilbert at Evrard 100 (the generic FMM,
     2 steps) and at Evrard 50 with D = 4, ve-tiered-sharded at Evrard
     100 (2 steps), ve-pallas-sharded at Sedov 100^3 (2 steps),
     turbulence-ve-bdt-sharded at turbulence 100^3 (1 cycle), each
     gated on the adapter's fail-stops (lost, overflow, n_owned), finite
     rows, the energy drift and, for Evrard, the density L1, with ms a
     call beside the single-device runs; every K3-K7 (slab) and K2g
     (BDT substep 1, every tier) launch of one more call against its
     plain version on sampled active cells (turbulence: on the run's
     state perturbed as phase (n)'s check frame); dryrun_multichip(4);
  17. (r) the last multi-device engines, every shard a thread on the
     card: (r1) the 2-D tiles (make_ve_step_pallas_tiles, 2 x 2), the
     column ranges (make_ve_step_pallas_hilbert, D = 2) and the slab
     gather engine (make_ve_step_sharded, D = 2) at Sedov 10^3 on the
     card against the CPU (in processes of their own, beside the
     card's runs), 2 steps each; (r2) main([...]) under --prop
     ve-pallas-tiles at D = 4 at Evrard 100 (the generic FMM) and Sedov
     100^3, 2 steps each, gated as phase (q)'s runs are and on span_ok
     and n_total, with the tiles' imbalance; the column engine at Sedov
     100^3 (2 steps) and the slab gather engine (1 step), D = 2, gated
     on lost, overflow, row_span_ok, n_total, the gather caps, finite
     rows and the energy drift, ms a call and peak memory beside the
     runs they stand with; (r3) every K3-K7 launch of one more tile
     call (both runs) and column call against its plain version on
     sampled occupied cells, timed beside its bound from that shard's
     in-support pairs, into the kernel rows (`tiles`, `columns`);
  18. (s) every pair kernel past cap 1024: a seeded clump frame on
     CMGrid(n=2) at caps 1152, 2048 and 4096 (the densest cell holding
     more than 1024 rows at each, more than half the cap), the inputs of
     one resident step under the direct, mm and avClean configurations;
     K3-K7, K8-K10, K10-bf16 and K7c, K2g of K3-K10 with its gate pass
     (the pass's list and flags against its plain version) under a
     seeded activity pattern, and K11 (bit-equal to the cell launch on
     the interior), each against its plain version on sampled occupied
     cells (BIGCAP_CELLS) at the kernel checks' tolerances, timed beside
     its bound from the frame's in-support pairs and its shared memory
     (cell_pair.cu's pair_smem), into the kernel rows (`cap_past_1024`);
  19. the kernel table as one JSON line, then the device line.
Details go to chiprun_out/chip_smoke.json.

python3 chip_smoke.py --compare [tag] times K1, K1z, K3-K7, 3 resident
steps and 2 BdtVE cycles at Sedov 100^3, the five gated stages at the
inputs of substep 1 and with no active supercell, K8, K9 and K10
(float32, bf16) and 3 steps under mxu_moments + mxu_momentum at 100^3,
and K3-K7 in a D = 2 sharded step at cap 256, only (see compare_main),
to compare two checkouts of the repository in one call.
python3 chip_smoke.py --gravity runs the build and phase (l) alone,
with no result lines; python3 chip_smoke.py --cli, the build and phase
(m) alone; python3 chip_smoke.py --turb, the build and phase (n)
alone; python3 chip_smoke.py --tiers, the build and phase (o) alone;
python3 chip_smoke.py --cool, the build and phase (p) alone;
python3 chip_smoke.py --multi, the build and phase (q) alone;
python3 chip_smoke.py --domains, the build and phase (r) alone;
python3 chip_smoke.py --bigcap, the build and phase (s) alone.
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import os
import subprocess
import sys
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
CHECK_SIDE = 30       # kernel check (perturbed Sedov)
MAIN_SIDE = 100       # main path: 1M particles, bench.py's Sedov size

# published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, the tensor cores' dense TF32 and bf16, and device-memory
# bandwidth
FP32_PEAK = 67e12
TF32_PEAK = 495e12
BF16_PEAK = 989e12
HBM_BW = 3.35e12

# float operations per pair (FMA = 2, divide/sqrt/exp/log = 1), counted
# from csrc/cell_pair.cu: GEO for every candidate's distance test, BODY
# for each candidate inside the support, RECOUNT for each further
# neighbour count of K3 (d2 held: a multiply by 1/h^2 and a compare)
GEO_FLOPS = 9
RECOUNT_FLOPS = 2
BODY_FLOPS = {"pair_xh": 18, "pair_gradh": 40, "pair_iad": 62,
              "pair_av": 55, "pair_momentum": 170,
              # K8: K5's tau part and 16 moment FMAs; K9: the vsig
              # term, W and 8 moment FMAs; K7c: K7 and the avClean
              # correction (two quadratic forms, exp, guarded divide);
              # K10: phase A, the five pair weights
              "pair_iad_mm": 72, "pair_av_mm": 47,
              "pair_momentum_avclean": 219, "pair_momentum_mm": 95}
# K10 phase B, on the tensor cores: 49 multiply-adds per (pair, family)
# with a nonzero weight
MM_FAMILY_FLOPS = 98
# K10's tensor-core schedule (csrc/cell_pair.cu mm::mm_cell): i-slots a
# block (16-row i-tiles), j-slots a staged unit (an occupied 32-slot
# group), and the 5 families
MM_IB, MM_UJ, MM_NF = 64, 32, 5
# moment columns built per (i-cell, staged j-slot)
COL_FLOPS = {"pair_iad_mm": 21, "pair_av_mm": 12, "pair_momentum_mm": 51}
GATED_REPLACES = "sphexa_tpu/ops/pallas_ve.py:162-253"
GATE_REPLACES = "sphexa_tpu/ops/pallas_ve.py:242-251"
REPLACES = {
    "ghost_refresh": "sphexa_tpu/ops/pallas_ve.py:349",
    "pair_xh": "sphexa_tpu/ops/pallas_ve.py:537",
    "pair_gradh": "sphexa_tpu/ops/pallas_ve.py:622",
    "pair_iad": "sphexa_tpu/ops/pallas_ve.py:704",
    "pair_av": "sphexa_tpu/ops/pallas_ve.py:900",
    "pair_momentum": "sphexa_tpu/ops/pallas_ve.py:1022",
    "pair_iad_mm": "sphexa_tpu/ops/pallas_ve.py:769",
    "pair_av_mm": "sphexa_tpu/ops/pallas_ve.py:949",
    "pair_momentum_mm": "sphexa_tpu/ops/pallas_ve.py:1190",
    "pair_momentum_avclean": "sphexa_tpu/ops/pallas_ve.py:1094-1116",
}
# the direct stage each new kernel stands in for
DIRECT = {"pair_iad_mm": "pair_iad", "pair_av_mm": "pair_av",
          "pair_momentum_mm": "pair_momentum",
          "pair_momentum_avclean": "pair_momentum"}
MM = dict(mxu_moments=True, mxu_momentum=True)
CONFIGS = {"mm": MM, "mm_bf16": dict(MM, mxu_bf16=True),
           "avclean": dict(av_clean=True)}
# (i): K11, the column launch, and the stages each configuration adds
COLUMN_REPLACES = "sphexa_tpu/ops/pallas_ve.py:273"
COLUMN_STAGES = {None: ("pair_xh", "pair_gradh", "pair_iad", "pair_av",
                        "pair_momentum"),
                 "mm": ("pair_iad_mm", "pair_av_mm", "pair_momentum_mm"),
                 "mm_bf16": ("pair_momentum_mm",),
                 "avclean": ("pair_momentum_avclean",)}
COLUMN_STEPS = 3
PROBE_REPLACES = {
    "fma_chains": "scripts/vpu_ceiling.py:26",
    "staging_loads": "scripts/dma_lab.py:61",
    "staging_many": "scripts/dma_lab.py:61",
    "staging_many_tma": "scripts/dma_lab.py:61",
    "staging_few_tma": "scripts/dma_lab.py:111",
    "staging_pipe": "scripts/dma_lab.py:155",
    "mma_cells": "scripts/mxu_micro.py:30",
}

# output rows compared as one group (a matrix or vector is compared at
# its own scale: near-zero components such as curlv of a radial flow or
# the off-diagonal IAD terms of a lattice carry only sum-order noise)
GROUPS = {"pair_xh": [[0], [1]], "pair_gradh": [[0], [1]],
          "pair_iad": [list(range(6)), list(range(6, 14))],
          "pair_av": [[0]], "pair_momentum": [[0, 1, 2], [3], [4]]}
GROUPS.update(pair_iad_mm=GROUPS["pair_iad"], pair_av_mm=[[0]],
              pair_momentum_mm=GROUPS["pair_momentum"],
              pair_momentum_avclean=GROUPS["pair_momentum"])
EXACT = {"pair_xh": [2, 3]}                       # nc, nonconv
RELATIVE = {"pair_xh": [0, 1], "pair_gradh": [0, 1], "pair_av": [0],
            "pair_momentum": [4], "pair_av_mm": [0],
            "pair_momentum_mm": [4],
            "pair_momentum_avclean": [4]}         # rtol 1e-5
# K9's graddivv is a cancelling moment sum: on the main path's Sedov
# state most particles are at rest, graddivv there is rounding noise and
# alpha follows its summation order (1.4e-5 relative at 100^3). On those
# inputs (per_row False) alpha is held at 1e-4 of its scale; on the
# perturbed inputs of (e) at rtol 1e-5.
NOISY_AT_REST = {"pair_av_mm"}
# K10 under mxu_bf16 is held against its plain version at this share of
# the plain version's own bf16-to-float32 distance (per row, at the
# row's scale): an operand one float32 ulp apart (FMA contraction, the
# cell-mean summation order) can round to the neighbouring bf16 value,
# and where a moment sum cancels (cells wide against h) one such flip
# moves it by a share of bf16's own error (measured on the card: 0.5%
# of it at 12^3, 5.7% at 30^3, 9.2% at the 100^3 main-path inputs; a
# kernel that rounded wrongly would sit near 100%)
BF16_SHARE = 0.25
# the value a tiled pair stage stores on an invalid i-slot (csrc/
# cell_pair.cu, St::fill; K4 1.0: kx is a divisor downstream,
# pallas_ve.py:667), held exactly on the invalid interior slots
FILL = {"pair_gradh": 1.0, "pair_iad": 0.0, "pair_av": 0.0,
        "pair_momentum": 0.0, "pair_momentum_avclean": 0.0,
        "pair_iad_mm": 0.0, "pair_av_mm": 0.0}
# the stages on the tiled routine whose lane counts are reported, and
# their report keys
LANE_STAGES = {"pair_gradh": "k4_lanes", "pair_iad": "k5_lanes",
               "pair_av": "k6_lanes", "pair_momentum": "k7_lanes"}


def stage_of(name: str) -> str:
    """The ungated stage a kernel name belongs to (K2g runs its body)."""
    return name.removesuffix("_gated")


def body_of(name: str) -> str:
    """The cell stage whose body a kernel runs (K2g and K11 forms)."""
    return stage_of(name).removesuffix("_column")


def log(*a):
    print(*a, flush=True)


def check_fill(k, J, out, intmask):
    """The invalid slots of `intmask` (the interior slots; a gated
    stage's: those of its active supercells) hold the FILL value of the
    tiled stage's body exactly. Returns how many slots were held."""
    name = body_of(k.name)
    if name not in FILL:
        return 0
    bad = intmask & ~valid_slots(J)
    if not bool((out[:, bad] == FILL[name]).all()):
        raise AssertionError(f"{k.name}: invalid interior slots differ from "
                             f"{FILL[name]}")
    return int(bad.sum())


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """ms a call of fn over `reps` calls between CUDA events, after one
    warm-up call; warmup=False for the plain versions at 100^3 (one
    call of each takes up to seconds, so a warm-up doubles its cost)."""
    import torch
    if warmup:
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def split_ms(fn, reps: int = 20):
    """One call's time three ways, in ms: CUDA events around `reps`
    back-to-back calls (what cuda_ms reports); the replay of the same
    `reps` calls captured in one CUDA graph, which leaves out the host's
    dispatch (device time); and the host's time to enqueue one call
    (dispatch time, no sync inside the loop)."""
    import torch
    events = cuda_ms(fn, reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return dict(events_ms=events, device_ms=a.elapsed_time(b) / reps,
                host_ms=host)


def ghost_split(calls, src):
    """K1 or K1z over recorded calls [(kernel, (stack, grid, box, xyz))]
    beside one index_select of its sources into a ghost-sized buffer
    (the same bytes, no shift, no FILL_POS), each split by split_ms and
    summed over the calls: the kernel's and the library call's events,
    device and host times."""
    import torch
    tot = {f"{who}_{m}": 0.0 for who in ("kernel", "index_select")
           for m in ("events_ms", "device_ms", "host_ms")}
    for k, (st, g, b, xyz) in calls:
        work = st.clone()
        buf = st.new_empty((st.shape[0], src.numel()))
        for who, fn in (("kernel", lambda: k._launch(work, g, b, xyz)),
                        ("index_select", lambda: torch.index_select(
                            st, 1, src, out=buf))):
            for m, v in split_ms(fn).items():
                tot[f"{who}_{m}"] += v
    return tot


def log_split(what, sp):
    log(f"  {what}: kernel events {sp['kernel_events_ms']:.4f} ms, device "
        f"{sp['kernel_device_ms']:.4f} ms (CUDA graph), host dispatch "
        f"{sp['kernel_host_ms']:.4f} ms; index_select events "
        f"{sp['index_select_events_ms']:.4f}, device "
        f"{sp['index_select_device_ms']:.4f}, host "
        f"{sp['index_select_host_ms']:.4f} ms")


def compare(name, ref, out, mask, per_row: bool):
    """(max abs error, max error relative to its row's scale) on interior
    valid slots; raises past tolerance. per_row: each cancelling row at
    its own scale (perturbed inputs, as the CPU tests); else each group
    at the group's scale."""
    import torch
    name = stage_of(name)
    ref, out = ref[:, mask].double(), out[:, mask].double()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (ref - out).abs()
    rel = float((err.amax(1) / ref.abs().amax(1).clamp_min(1e-30)).max())
    for r in EXACT.get(name, []):
        if err[r].max() != 0:
            raise AssertionError(f"{name}: row {r} not exact "
                                 f"({int((err[r] > 0).sum())} slots)")
    rel_rows = [] if name in NOISY_AT_REST and not per_row else \
        RELATIVE.get(name, [])
    for r in rel_rows:
        bad = err[r] > 1e-5 * ref[r].abs()
        if bad.any():
            worst = float((err[r] / ref[r].abs()).max())
            raise AssertionError(f"{name}: row {r} beyond rtol 1e-5 "
                                 f"(max rel {worst:.3e})")
    for grp in GROUPS[name]:
        rows = [r for r in grp if r not in rel_rows]
        if not rows:
            continue
        groups = [[r] for r in rows] if per_row else [rows]
        for g in groups:
            scale = float(ref[g].abs().max())
            if float(err[g].max()) > 1e-4 * max(scale, 1e-30):
                raise AssertionError(
                    f"{name}: rows {g} err {float(err[g].max()):.3e} "
                    f"> 1e-4 x {scale:.3e}")
    return float(err.max()), rel


def bf16_compare(k, args, out, mask, cells=None):
    """K10 under mxu_bf16 against its plain version: within BF16_SHARE of
    the plain bf16-to-float32 distance, and at least half that distance
    from float32 (the rounding is applied); maxvsignal (no bf16 operand)
    rtol 1e-5. With `cells` the plain versions run on those cells only
    (mask within them). Returns (max abs error against plain bf16, the
    largest error as a share of that distance)."""
    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv
    J, I2, g, c = args

    def plain(cfg):
        if cells is None:
            return k.plain(J, I2, g, cfg)
        return pv._run_plain(k.body, J, I2, g, k.fo, cells=cells,
                             **k._body_kw(cfg))
    ref_b = plain(c)[:, mask].double()
    ref_f = plain(c.replace(mxu_bf16=False))[:, mask].double()
    o = out[:, mask].double()
    if not torch.isfinite(o).all():
        raise AssertionError("bf16: non-finite kernel output")
    worst = 0.0
    for r in range(4):
        scale = float(ref_f[r].abs().max())
        d_ref = float((ref_b[r] - ref_f[r]).abs().max()) / scale
        d_out = float((o[r] - ref_b[r]).abs().max()) / scale
        d_f32 = float((o[r] - ref_f[r]).abs().max()) / scale
        if not (d_out <= BF16_SHARE * d_ref and d_f32 >= 0.5 * d_ref):
            raise AssertionError(
                f"bf16 row {r}: kernel-plain {d_out:.3e}, kernel-fp32 "
                f"{d_f32:.3e}, plain bf16-fp32 {d_ref:.3e}")
        worst = max(worst, d_out / d_ref)
    bad = (o[4] - ref_b[4]).abs() > 1e-5 * ref_b[4].abs()
    if bad.any():
        raise AssertionError("bf16: maxvsignal beyond rtol 1e-5")
    return float((o - ref_b).abs().max()), worst


def k9_noise_body(I, Jn, i2, *, cfg, K3d, n_w, icell=None):
    """K9's alpha (pair_ve._av_mm_body) and its float32 rounding noise
    relative to it, from the inputs, evaluated in the rows' dtype
    (float64): the unit roundoff times the magnitude of graddivv's terms
    (each moment sum of G_b taken over |terms|, G's combination through
    |c_ij|) over |graddivv|, times alpha's relative sensitivity to
    graddivv. No summation-length factor: the float32 orders measured
    (kernel, plain, JAX) sit within 4.5 times it. icell: the whole own
    cell, where _run_plain gives a slice of it (the origin's cell)."""
    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv
    RC, _, RXM, RDIVV, RVX, RVY, RVZ = range(pv.NBASE, pv.NBASE + 7)
    hinv = 1.0 / I[pv.RH]
    ox, oy, oz, odv = pv._cell_means(I if icell is None else icell,
                                     (pv.RX, pv.RY, pv.RZ, RDIVV))
    xib = (I[pv.RX] - ox, I[pv.RY] - oy, I[pv.RZ] - oz)
    xjc = (Jn[pv.RX] - ox, Jn[pv.RY] - oy, Jn[pv.RZ] - oz)
    dvic = I[RDIVV] - odv
    rx, ry, rz, d2 = pv._geo(I, Jn)
    w = pv._w_v2(d2 * hinv * hinv, n_w)
    volj = Jn[RXM] / Jn[RC + 1]
    vd = volj * (Jn[RDIVV] - odv)

    def S(t):
        return torch.sum(w * t, dim=-1, keepdim=True)

    G = [xib[b] * (dvic * S(volj) - S(vd)) - (dvic * S(volj * xjc[b])
                                              - S(vd * xjc[b]))
         for b in range(3)]
    M = [xib[b].abs() * (dvic.abs() * S(volj) + S(vd.abs()))
         + dvic.abs() * S(volj * xjc[b].abs()) + S((vd * xjc[b]).abs())
         for b in range(3)]
    c = [[i2[0], i2[1], i2[2]], [i2[1], i2[3], i2[4]],
         [i2[2], i2[4], i2[5]]]
    g = torch.sqrt(sum(sum(c[a][b] * G[b] for b in range(3)) ** 2
                       for a in range(3)))
    dg = torch.sqrt(sum(sum(c[a][b].abs() * M[b] for b in range(3)) ** 2
                        for a in range(3)))
    rv = (rx * (I[RVX] - Jn[RVX]) + ry * (I[RVY] - Jn[RVY])
          + rz * (I[RVZ] - Jn[RVZ]))
    vsig = torch.where((w > 0) & (rv < 0.0), I[RC] + Jn[RC] - 3.0 * rv
                       * torch.rsqrt(torch.clamp_min(d2, 1e-30)), pv._NEG)
    vs = torch.maximum(torch.amax(vsig, -1, keepdim=True), 1e-30 * I[RC])
    scale = K3d * hinv ** 3

    def alpha(gd):
        return pv._alpha_tail(i2, gd, vs, I[RDIVV], I[pv.RH], I[RC], cfg)

    a0, eps = alpha(g * scale), 1e-6
    sens = (alpha(g * scale * (1 + eps)) - a0).abs() / eps
    noise = 2.0 ** -24 * sens * dg / torch.clamp_min(g, 1e-300)
    ok = pv._oki(I)
    return [torch.where(ok, a0, 0.0),
            torch.where(ok, noise / torch.clamp_min(a0.abs(), 1e-300), 0.0)]


def k9_noise_floor(J, I2, grid, cfg, cells=None):
    """K9's alpha from the inputs in float64 and its relative float32
    noise floor (k9_noise_body), [n_slots] each, on J's device (on the
    padded cell ids `cells` only, where given); and the slots at that
    floor: where four times the noise reaches K9's rtol of 1e-5 (the mm
    alpha property, ROADMAP Queue 3: graddivv is a difference of centred
    moment sums). Such slots are held within 8 times their noise of the
    float64 alpha, the others at rtol 1e-5 (tests/test_torch_cuda.py
    past cap 128, phase (s))."""
    from sphexa_tpu_torch.ops import pair_ve as pv
    k = pv.pair_av_mm
    ref, noise = pv._run_plain(k9_noise_body, J.double(), I2.double(),
                               grid, 2, cells=cells, **k._body_kw(cfg))
    return ref, noise, 4.0 * noise >= 1e-5


class Spy:
    """Records every launch of the port's kernels (inputs and output)."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.calls = []

    def __enter__(self):
        for k in self.kernels:
            orig = type(k)._launch

            def launch(*args, k=k, orig=orig):
                if k.name.startswith("ghost_refresh"):
                    before = args[0].clone()
                    out = orig(k, *args)
                    self.calls.append((k, (before,) + args[1:], out))
                    return out
                out = orig(k, *args)
                self.calls.append((k, args, out))
                return out
            k._launch = launch
        return self

    def __exit__(self, *exc):
        for k in self.kernels:
            del k._launch


def perturbed(state, seed):
    """The state with its positions jittered by 3% of h, random
    velocities (sigma 0.3) and alpha (uniform in [0.05, 0.5]), so that no
    stage's output is a cancelling sum of rounding noise."""
    import torch
    r = np.random.default_rng(seed)
    p = state.p
    n, dev = p.x.numel(), p.x.device
    h0 = float(p.h[0])
    upd = {c: getattr(p, c) + torch.from_numpy(
        r.normal(0, 0.03 * h0, n).astype(np.float32)).to(dev)
        for c in "xyz"}
    upd.update({c: torch.from_numpy(r.normal(0, 0.3, n).astype(
        np.float32)).to(dev) for c in ("vx", "vy", "vz")})
    upd["alpha"] = torch.from_numpy(r.uniform(0.05, 0.5, n).astype(
        np.float32)).to(dev)
    return state.replace(p=p.replace(**upd))


def sedov(side, device, perturb_seed=None, flags=None):
    import torch
    from sphexa_tpu_torch.config import SphConfig
    from sphexa_tpu_torch.init.sedov import init_sedov
    from sphexa_tpu_torch.ops.cellmajor import choose_cap_and_grid

    state, box, cfg = init_sedov(side, SphConfig(), dt0=3e-5, device=device)
    cfg = cfg.replace(**(flags or {}))
    n = side ** 3
    if perturb_seed is not None:
        state = perturbed(state, perturb_seed)
    xyz = [getattr(state.p, c).cpu().numpy() for c in "xyz"]
    cap, grid = choose_cap_and_grid(box, float(state.p.h.max()) * 1.2, n,
                                    *xyz)
    return state, box, cfg, grid


def kernel_check(report):
    """Phase 3: kernels vs plain versions at Sedov 30^3 (perturbed)."""
    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv
    from sphexa_tpu_torch.propagator.ve_cellmajor import ResidentVE
    from sphexa_tpu_torch.sfc.box import Box, Boundary

    state, box, cfg, grid = sedov(CHECK_SIDE, DEVICE, perturb_seed=0)
    eng = ResidentVE(box, grid, cfg, device=DEVICE)
    rst = eng.bind(state)
    with Spy(pv.KERNELS[1:]) as spy:
        eng.step(rst)
    torch.cuda.synchronize()
    errs = {}
    for k, (J, I2, g, c), out in spy.calls:
        ref = k.plain(J, I2, g, c)
        mask = valid_slots(J) & eng.intmask
        err, rel = compare(k.name, ref, out, mask, per_row=True)
        nfill = check_fill(k, J, out, eng.intmask)
        errs[k.name] = dict(max_abs_err=err, max_rel_err=rel,
                            fill_slots=nfill)
        log(f"  {CHECK_SIDE}^3 {k.name:14s} max abs err {err:.3e}, "
            f"max rel err (to row scale) {rel:.3e}"
            + (f"; {nfill} invalid interior slots at {FILL[k.name]}"
               if nfill else ""))
    r = np.random.default_rng(1)
    for bnd in (Boundary.periodic, Boundary.open):
        gbox = Box(-0.5, 0.5, -0.5, 0.5, -0.5, 0.5, bnd, bnd, bnd)
        for rows in ((0, 1, 2), None):
            st = torch.from_numpy(r.normal(0, 1, (12, grid.n_slots)).astype(
                np.float32)).to(DEVICE)
            ref = pv.ghost_refresh.plain(st.clone(), grid, gbox, rows)
            out = pv.ghost_refresh._launch(st.clone(), grid, gbox, rows)
            if not torch.equal(ref, out):
                raise AssertionError(f"ghost_refresh {bnd.name} {rows}: "
                                     f"not bit-equal")
            log(f"  {CHECK_SIDE}^3 ghost_refresh {bnd.name:8s} "
                f"xyz={rows}: bit-equal")
    report["check_30"] = dict(grid=str(grid), errors=errs)
    return spy.calls, eng


def engine_check(report, cname=None):
    """Phase 3b (and (f) with cname, under CONFIGS[cname]): the whole
    resident step on the card against the same engine on the CPU (plain
    versions), Sedov 10^3, 3 steps, forced rebin; bounds of
    tests/test_torch_resident.py."""
    from sphexa_tpu_torch.propagator.ve_cellmajor import ResidentVE

    diags = {}
    for dev in (DEVICE, "cpu"):
        state, box, cfg, grid = sedov(10, dev, flags=CONFIGS.get(cname))
        eng = ResidentVE(box, grid, cfg, device=dev)
        rst = eng.bind(state)
        ds = []
        for i in range(3):
            if i == 1:
                rst = rst.replace(drift=rst.drift.new_tensor(1e9))
            rst, d = eng.step(rst)
            ds.append({k: float(v) for k, v in d._asdict().items()})
        diags[dev] = ds
    for a, b in zip(diags["cpu"], diags[DEVICE]):
        assert a["rebinned"] == b["rebinned"]
        np.testing.assert_allclose(b["dt"], a["dt"], rtol=1e-5)
        np.testing.assert_allclose(b["eint"], a["eint"], rtol=1e-6)
        np.testing.assert_allclose(b["ecin"], a["ecin"], rtol=1e-3,
                                   atol=1e-12)
    a, b = diags["cpu"][-1], diags[DEVICE][-1]
    log(f"  10^3 engine{'' if cname is None else ' ' + cname} {DEVICE} vs "
        f"cpu, 3 steps: dt {b['dt']:.6e} vs {a['dt']:.6e}, eint "
        f"{b['eint']:.9f} vs {a['eint']:.9f}, ecin {b['ecin']:.6e} vs "
        f"{a['ecin']:.6e}")
    report["engine_10" if cname is None else f"engine_10_{cname}"] = diags


def all_kernels():
    """Every kernel wrapper with a launch counter."""
    from sphexa_tpu_torch.ops import pair_ve as pv
    return (pv.ghost_refresh, pv.ghost_refresh_xy, pv.pair_gate) \
        + pv.PAIR_KERNELS


def main_path(report, cname=None, steps=10, rebin_at=5):
    """Phase 4 (and (g) under CONFIGS[cname]): Sedov 100^3 on the
    resident engine, one warm-up step, then `steps` timed steps with a
    forced rebin. Every kernel the engine's stages use launches once a
    step (K1 five times), every other kernel never."""
    import torch
    from sphexa_tpu_torch.propagator.common import compute_energies
    from sphexa_tpu_torch.propagator.ve_cellmajor import ResidentVE

    side = MAIN_SIDE
    t0 = time.perf_counter()
    state, box, cfg, grid = sedov(side, DEVICE, flags=CONFIGS.get(cname))
    e0 = float(sum(compute_energies(state.p, cfg)))
    eng = ResidentVE(box, grid, cfg, device=DEVICE)
    rst = eng.bind(state)
    assert int(rst.overflow) == 0, "slot overflow at bind"
    rst, _ = eng.step(rst)                   # warm-up
    torch.cuda.synchronize()
    log(f"  setup + warm-up {time.perf_counter() - t0:.1f} s; cap "
        f"{grid.cap}, grid {grid}, n_slots {grid.n_slots}")

    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    diags = []
    ev[0].record()
    for i in range(steps):
        if i == rebin_at:
            rst = rst.replace(drift=rst.drift.new_tensor(1e9))
        rst, d = eng.step(rst)
        ev[i + 1].record()
        diags.append(d)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}

    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
    n = side ** 3
    d = {k: [float(getattr(x, k)) for x in diags] for k in
         ("dt", "etot", "ecin", "eint", "overflow", "h_nonconv", "rebinned",
          "h_max", "nc_mean")}
    assert max(d["overflow"]) == 0, "slot overflow"
    assert d["rebinned"][rebin_at] == 1.0, "forced rebin did not run"
    for f in ("x", "y", "z", "h", "vx", "vy", "vz", "temp", "alpha",
              "du_m1"):
        assert torch.isfinite(getattr(rst, f)).all(), f"non-finite {f}"
    drift = abs(d["etot"][-1] - e0) / e0
    assert drift < 5e-3, f"energy drift {drift:.3e}"
    used = {k.name for k in eng.pve.kernels}
    want = {k.name: steps if k.name in used else 0 for k in kernels}
    want["ghost_refresh"] = 5 * steps
    assert launches == want, (launches, want)
    mean_ms = float(np.mean(step_ms))
    sim_per_wall = sum(d["dt"]) / (sum(step_ms) * 1e-3)
    log(f"  {side}^3: {mean_ms:.3f} ms/step (CUDA events, mean of {steps}; "
        f"steps {[round(s, 3) for s in step_ms]}), "
        f"{n / (mean_ms * 1e-3):.4e} particle-updates/s, sim-time per "
        f"wall-second {sim_per_wall:.6e}")
    log(f"  |etot - e0|/e0 = {drift:.3e}; h_nonconv {d['h_nonconv']}; "
        f"launches {dict((k, v) for k, v in launches.items() if v)}, "
        f"every other kernel 0")
    report["main_path" if cname is None else f"main_path_{cname}"] = dict(
        side=side, n=n, cap=grid.cap, grid=str(grid), n_slots=grid.n_slots,
        steps=steps, rebin_at=rebin_at, step_ms=step_ms, mean_step_ms=mean_ms,
        particle_updates_per_s=n / (mean_ms * 1e-3),
        sim_time_per_wall_s=sim_per_wall, e0=e0,
        energy_drift=drift, diags=d, launches=launches)
    return eng, rst, grid, launches


def valid_slots(J):
    """Slots holding a particle (or its image), read off the frame's x
    row: invalid slots carry FILL_POS."""
    from sphexa_tpu_torch.ops.pair_ve import FILL_POS
    return J[0] < 0.5 * FILL_POS


def pair_counts(J, eng, grid, nc_sph):
    """Valid candidate pairs (27-cell neighbourhoods) and in-support
    pairs of this frame, for the bounds; and per slot its candidates
    (0 outside interior valid slots)."""
    import torch
    shape = (grid.npx, grid.np_, grid.npz, grid.cap)
    valid = (valid_slots(J) & eng.intmask).view(shape)
    cnt = valid_slots(J).view(shape).sum(-1).double()
    nb = sum(cnt[1 + dx:grid.npx - 1 + dx, 1 + dy:grid.np_ - 1 + dy,
                 1 + dz:grid.npz - 1 + dz]
             for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1))
    per_slot = torch.zeros(shape, dtype=torch.float64, device=J.device)
    per_slot[1:-1, 1:-1, 1:-1] = nb[..., None]
    per_slot = torch.where(valid, per_slot, 0.0).view(-1)
    cand = float(per_slot.sum())
    inside = float(torch.where(valid.view(-1), nc_sph, 0.0).double().sum())
    return cand, inside, per_slot


def lane_counts(J, grid, intmask, batch_pairs=2 ** 28):
    """The work of the tiled pair routine (csrc/cell_pair.cu
    tile::pair_cell: K4-K9, K7c) on these inputs, counted on the card
    from J (rows x, y, z, h), with the kernels' own support test:
    in-support pairs (valid interior i, valid j), and the lane
    efficiency (pairs / (32 * warp body executions)) of three designs.
    Old (a thread per i-slot walking every j-slot, the former skeleton): a
    warp runs the body for each (warp, j-slot) where any lane is in
    support. Compacted (K7, K7c): per warp of 32 i-slots and chunk of 32
    staged j-slots, the in-support pairs run in rounds of 32 lanes.
    Per lane (K4, K5, K6, K8, K9): per warp and chunk, each lane walks
    its own in-support pairs, so the warp runs the body as often as its
    busiest lane. Also the support tests each design issues per warp: old every
    slot of the 27 cells for every warp; new, warps with a valid i-slot
    over each j-tile's slots up to its last valid one."""
    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv

    cap = grid.cap
    cells = torch.tensor(pv.interior_cells(grid), device=J.device)
    offs = torch.tensor(pv._nbr_offsets(grid), device=J.device)
    lane = torch.arange(cap, device=J.device)
    valid = valid_slots(J)
    hinv = 1.0 / J[3]
    hinv2 = hinv * hinv
    T = min(cap, 128)
    cnt = dict(pairs=0, old_bodies=0, new_rounds=0, lane_bodies=0,
               old_tests=0, new_tests=0)
    chunk = max(1, batch_pairs // (27 * cap * cap))
    for c0 in range(0, cells.numel(), chunk):
        cc = cells[c0:c0 + chunk]
        C = cc.numel()
        own = cc[:, None] * cap + lane                        # [C, cap]
        nb = (cc[:, None] + offs)[:, :, None] * cap + lane     # [C, 27, cap]
        vi = valid[own] & intmask[own]
        vj = valid[nb]
        d2 = sum((J[r][own][:, :, None, None] - J[r][nb][:, None]) ** 2
                 for r in range(3))
        ins = (d2 * hinv2[own][:, :, None, None] < 4.0) \
            & vi[:, :, None, None] & vj[:, None]               # [C,cap,27,cap]
        cnt["pairs"] += int(ins.sum())
        w = ins.view(C, cap // 32, 32, 27, cap)
        cnt["old_bodies"] += int(w.any(2).sum())
        per_lane = w.view(C, cap // 32, 32, 27, cap // 32, 32).sum(5)
        cnt["new_rounds"] += int(((per_lane.sum(2) + 31) // 32).sum())
        cnt["lane_bodies"] += int(per_lane.amax(2).sum())
        cnt["old_tests"] += C * (cap // 32) * 27 * cap
        active = vi.view(C, cap // 32, 32).any(-1).sum(1)     # [C]
        last = torch.where(vj, lane + 1, 0).view(C, 27, cap // T, T) \
            - (torch.arange(cap // T, device=J.device) * T)[:, None]
        kmax = last.clamp_min(0).amax(-1).sum((1, 2))          # [C]
        cnt["new_tests"] += int((active * kmax).sum())
    pairs = max(cnt["pairs"], 1)
    cnt["old_lane_eff"] = pairs / (32 * max(cnt["old_bodies"], 1))
    cnt["new_lane_eff"] = pairs / (32 * max(cnt["new_rounds"], 1))
    cnt["lane_lane_eff"] = pairs / (32 * max(cnt["lane_bodies"], 1))
    return cnt


def log_lanes(what, lc):
    log(f"  {what}: {lc['pairs']:.4e} in-support pairs; old design "
        f"{lc['old_bodies']:.4e} warp body executions (lane efficiency "
        f"{lc['old_lane_eff']:.4f}), {lc['old_tests']:.4e} warp tests; "
        f"new {lc['new_tests']:.4e} warp tests, compacted "
        f"{lc['new_rounds']:.4e} rounds ({lc['new_lane_eff']:.4f}), per "
        f"lane {lc['lane_bodies']:.4e} warp bodies "
        f"({lc['lane_lane_eff']:.4f})")


def stage_lanes(calls, grid, intmask):
    """lane_counts of each LANE_STAGES stage's J from (kernel, args,
    out) calls; stages reading the same x, y, z, h rows (K4-K7 of one
    step) share one count."""
    import torch
    done, out = [], {}
    for name in LANE_STAGES:
        J = next(a[0] for k, a, _ in calls if k.name == name)
        lc = next((c for J0, c in done if torch.equal(J0[:4], J[:4])), None)
        if lc is None:
            lc = lane_counts(J, grid, intmask)
            done.append((J, lc))
        out[name] = lc
    return out


def routine_ptxas():
    """Registers and spills of the pair kernels of csrc/cell_pair.cu
    from the build's ptxas -v output, keyed by the demangled names of
    the functions it lists (c++filt; the mangled name where it is
    missing): the kernels (xh::cell_xh<Gated, Column>, tile::cell_tile<
    Stage, Gated, Column>, mm::cell_mm<BF16, Gated, Column>, ...) and
    the routines they call (xh::xh_cell, tile::pair_cell<Stage>,
    mm::mm_cell<BF16>)."""
    import re
    from sphexa_tpu_torch.ops import _cuda

    text = _cuda.build_info.get("cell_pair.cu", {}).get("ptxas", "")
    pat = (r"(?:Compiling entry function|Function properties for) "
           r"'?([\w.$]+)")
    names = sorted({m.group(1) for m in re.finditer(pat, text)
                    if not m.group(1).startswith("_ZZ")})
    try:
        filt = subprocess.run(["c++filt"], input="\n".join(names),
                              capture_output=True, text=True, check=True)
        plain = filt.stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        plain = names
    if len(plain) != len(names):
        plain = names
    # the demangled name without the anonymous namespaces, the internal
    # linkage prefix, the return type and the arguments
    keys = {}
    for n, d in zip(names, plain):
        d = re.sub(r"_INTERNAL_\w+::", "",
                   d.replace("(anonymous namespace)::", ""))
        keys[n] = re.sub(r"^void ", "", d.split("(")[0])

    # ptxas compiles a routine once for each kernel that calls it and
    # prints its properties after that kernel's: each copy is keyed
    # "routine in kernel"
    out, name, entry = {"raw": []}, None, None
    for line in text.splitlines():
        m = re.search(pat, line)
        if m:
            name = m.group(1)
            if "Compiling entry function" in line:
                entry = name
        k = keys.get(name)
        if k is None:
            continue
        if name != entry and entry in keys:
            k = f"{k} in {keys[entry]}"
        out["raw"].append(line.strip())
        rec = out.setdefault(k, {})
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rec["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rec["spill_stores"], rec["spill_loads"] = map(int, m.groups())
    return out


def xh_recounts(J, grid, cfg, per_slot):
    """Candidates K3 must count again on these inputs: d2 is computed
    once, and a slot needs one more count over its candidates for each
    controller round that changed its h (read off the plain version run
    with 1..h_iter rounds).
    Returns (recount candidates, slots whose h moved, walks the kernel
    must run: one a slot with candidates, one more a round that moved
    its h; csrc/cell_pair.cu xh::xh_cell)."""
    import dataclasses
    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv

    hs = [J[pv.RH]]
    for t in range(1, cfg.h_iter + 1):
        hs.append(pv.pair_xh.plain(J, None, grid,
                                   dataclasses.replace(cfg, h_iter=t))[1])
    rounds = sum((a != b).double() for a, b in zip(hs, hs[1:]))
    has = per_slot > 0
    return (float((rounds * per_slot).sum()), int((rounds > 0)[has].sum()),
            int((1 + rounds)[has].sum()))


def xh_walks(k, args):
    """K3's walks on the card: one launch with a stats buffer
    (csrc/cell_pair.cu xh::xh_cell) counts the walks its lanes ran, its
    warp walks and the candidates those walked. None for a kernel
    without the counter (a parent checkout in --compare)."""
    import inspect
    import torch
    if "stats" not in inspect.signature(k._launch).parameters:
        return None
    st = torch.zeros(3, dtype=torch.int64, device=DEVICE)
    k._launch(*args, stats=st)
    torch.cuda.synchronize()
    return dict(zip(("slot_walks", "warp_walks", "warp_tests"),
                    (int(v) for v in st.tolist())))


def check_walks(what, call, predicted, slots):
    """K3's walks counted on the card beside xh_recounts' prediction for
    the same inputs; they must be equal (a lane walks once, and once
    more a controller round that moved its h)."""
    k, args, _ = call
    got = xh_walks(k, args)
    log(f"  {what}: {got['slot_walks']} walks on the card for {slots} "
        f"valid interior slots ({got['slot_walks'] / max(slots, 1):.4f} a "
        f"slot; predicted {predicted}); {got['warp_walks']} warp walks, "
        f"{got['warp_tests']:.4e} candidates walked by warps")
    if got["slot_walks"] != predicted:
        raise AssertionError(f"K3 walks {got['slot_walks']} != predicted "
                             f"{predicted}")
    return dict(got, predicted=predicted, slots=slots)


def timing(report, eng, rst, grid, launches):
    """Phase 5: each kernel at the main path's inputs of one step."""
    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv

    with Spy(pv.KERNELS) as spy:
        eng.step(rst)
    torch.cuda.synchronize()
    rows = []
    ghost_calls = [c for c in spy.calls if c[0].name == "ghost_refresh"]
    pair_calls = [c for c in spy.calls
                  if not c[0].name.startswith("ghost_refresh")]
    xh_out = next(out for k, _, out in pair_calls if k.name == "pair_xh")
    nc_sph = xh_out[2] + 1
    xh_J, _, _, xh_cfg = next(a for k, a, _ in pair_calls
                              if k.name == "pair_xh")
    cand, inside, per_slot = pair_counts(xh_J, eng, grid, nc_sph)
    recount, moved, walks = xh_recounts(xh_J, grid, xh_cfg, per_slot)
    report["pairs"] = dict(candidates=cand, in_support=inside,
                           xh_recount_candidates=recount, xh_h_moved=moved)
    log(f"  pairs: {cand:.4e} valid candidates, {inside:.4e} in support; "
        f"xmass: h moved on {moved} slots, {recount:.4e} candidates "
        f"counted again")
    report["k3_walks"] = check_walks(
        "K3 at the main path's inputs",
        next(c for c in pair_calls if c[0].name == "pair_xh"), walks,
        int((per_slot > 0).sum()))

    lanes = stage_lanes(pair_calls, grid, eng.intmask)
    for kname, lc in lanes.items():
        report[LANE_STAGES[kname]] = lc
        log_lanes(f"{kname} at cap {grid.cap}", lc)
    regs = routine_ptxas()
    log(f"  K3-K8 and K10 registers and spills (ptxas): "
        f"{dict((k, v) for k, v in regs.items() if k != 'raw')}")
    spilled = [k for k, v in regs.items() if k != "raw"
               and (v.get("spill_stores") or v.get("spill_loads"))]
    log(f"  spills in K3-K8, K10 and their copies: {spilled or 'none'}")
    report["tile_ptxas"] = regs
    for k, (J, I2, g, c), out in pair_calls:
        ref = k.plain(J, I2, g, c)
        err, rel = compare(k.name, ref, out, valid_slots(J) & eng.intmask,
                           per_row=False)
        check_fill(k, J, out, eng.intmask)
        ms = cuda_ms(lambda: k._launch(J, I2, g, c), 5)
        plain_ms = cuda_ms(lambda: k.plain(J, I2, g, c), 1, warmup=False)
        ops = cand * GEO_FLOPS + inside * BODY_FLOPS[k.name]
        if k.name == "pair_xh":
            ops += recount * RECOUNT_FLOPS
        nbytes = 4 * (J.numel() + (I2.numel() if I2 is not None else 0)
                      + out.numel())
        t_ops, t_bytes = ops / FP32_PEAK * 1e3, nbytes / HBM_BW * 1e3
        rows.append(dict(
            name=k.name, route="cuda", source="sphexa_tpu_torch/csrc/"
            "cell_pair.cu", replaces=REPLACES[k.name],
            launches=launches[k.name], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=None))
        log(f"  {k.name:14s} {ms:9.3f} ms  plain {plain_ms:10.3f} ms  bound "
            f"{max(t_ops, t_bytes):.4f} ms  err {err:.3e} (rel {rel:.3e})")

    # library call: one index_select of the ghost slots' sources into a
    # ghost-sized buffer (the same bytes as K1; no shift, no FILL_POS)
    gm = pv._ghost_maps(grid, eng.box)
    src = torch.tensor(gm["src"], device=DEVICE)
    ms = plain_ms = lib_ms = nbytes = err = 0.0
    for k, (st, g, b, xyz), out in ghost_calls:
        ref = k.plain(st.clone(), g, b, xyz)
        if not torch.equal(ref, out):
            raise AssertionError("ghost_refresh: kernel != plain at 100^3")
        err = max(err, float((ref - out).abs().max()))
        work = st.clone()
        buf = st.new_empty((st.shape[0], src.numel()))
        ms += cuda_ms(lambda: k._launch(work, g, b, xyz), 20)
        plain_ms += cuda_ms(lambda: k.plain(st.clone(), g, b, xyz), 3)
        lib_ms += cuda_ms(lambda: torch.index_select(st, 1, src, out=buf), 20)
        nbytes += 2 * 4 * st.shape[0] * src.numel()
    sp = ghost_split([c[:2] for c in ghost_calls], src)
    log_split(f"K1 device/dispatch split, sums over the "
              f"{len(ghost_calls)} refreshes", sp)
    log(f"  K1 target (no slower than index_select, events): "
        f"{'met' if ms <= lib_ms else 'missed'}")
    report["k1_split"] = sp
    rows.insert(0, dict(
        name="ghost_refresh", route="cuda",
        source="sphexa_tpu_torch/csrc/ghost_refresh.cu",
        replaces=REPLACES["ghost_refresh"], launches=launches["ghost_refresh"],
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=nbytes / HBM_BW * 1e3, bound_by="bytes", library_ms=lib_ms))
    log(f"  ghost_refresh  {ms:9.3f} ms  plain {plain_ms:10.3f} ms  bound "
        f"{nbytes / HBM_BW * 1e3:.4f} ms  index_select {lib_ms:.3f} ms "
        f"(sums over the {len(ghost_calls)} refreshes of one step)")
    report["kernels"] = rows
    return rows


def activity_pattern(grid, valid, seed):
    """A 0/1 activity row over [npx, npd, npz, cap]: in every third (x, y)
    column all valid interior slots are active, in every third none, and
    in the rest each z-cell is active, inactive or has one active slot,
    at random. Returns (act, per-supercell counts of each kind)."""
    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv
    from sphexa_tpu_torch.ops.cellmajor import _interior_cells_np

    shape = (grid.npx, grid.np_, grid.npz, grid.cap)
    r = np.random.default_rng(seed)
    vi = valid.view(shape).cpu().numpy() & np.repeat(
        _interior_cells_np(grid), grid.cap).reshape(shape)
    kind = r.integers(0, 3, shape[:3])
    cx, cy = np.meshgrid(np.arange(grid.npx), np.arange(grid.np_),
                         indexing="ij")
    kind[(cx + cy) % 3 == 0] = 0
    kind[(cx + cy) % 3 == 1] = 2
    act = np.zeros(shape, np.float32)
    act[kind == 2] = 1.0
    first = np.argmax(vi, axis=-1)                # one valid slot a cell
    one = np.zeros(shape, bool)
    np.put_along_axis(one, first[..., None], True, axis=-1)
    act[(kind == 1)[..., None] & one] = 1.0
    act *= vi
    Z = pv.resolve_zgroup(grid)
    sc = (act.reshape(grid.npx, grid.np_, grid.npz // Z, Z, grid.cap)
          .max(-1))                                # per cell: any active
    occ = vi.reshape(sc.shape + (grid.cap,)).any(-1)
    n_act = (sc * occ).sum(-1)
    n_occ = occ.sum(-1)
    kinds = dict(active=int(((n_act == n_occ) & (n_occ > 0)).sum()),
                 inactive=int(((n_act == 0) & (n_occ > 0)).sum()),
                 mixed=int(((n_act > 0) & (n_act < n_occ)).sum()))
    return torch.from_numpy(act.reshape(-1)).to(valid.device), kinds


def gated_compare(kg, args, out, intmask, per_row):
    """K2g output against its gated plain version: bit-equal to prev on
    the interior slots of inactive supercells, the ungated tolerances on
    the valid slots of active ones. Returns (max abs err, rel)."""
    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv

    J, I2, g, c, (act, prev), zgroup = args
    ref = kg.plain(*args)
    on = pv.supercell_active(act, g, pv.resolve_zgroup(g, zgroup))
    on = on.repeat_interleave(g.cap)
    keep = intmask & ~on
    if not (torch.equal(out[:, keep], prev[:, keep])
            and torch.equal(ref[:, keep], prev[:, keep])):
        raise AssertionError(f"{kg.name}: inactive supercells != prev")
    if out[:, ~intmask].any():
        raise AssertionError(f"{kg.name}: slots outside the interior != 0")
    return compare(kg.name, ref, out, valid_slots(J) & intmask & on,
                   per_row=per_row)


def gated_check(report, calls, eng):
    """Phase 3a: each K2g stage against its gated plain version at Sedov
    30^3 (the inputs of phase 3), seeded activity, seeded prev rows."""
    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv

    grid = eng.grid
    J0 = calls[0][1][0]
    act, kinds = activity_pattern(grid, valid_slots(J0), seed=3)
    log(f"  {CHECK_SIDE}^3 activity: supercells (Z = "
        f"{pv.resolve_zgroup(grid)}) {kinds}")
    assert min(kinds.values()) > 0, kinds
    r = np.random.default_rng(4)
    errs = {}
    for k, (J, I2, g, c), _ in calls:
        kg = next(x for x in pv.GATED_KERNELS if stage_of(x.name) == k.name)
        prev = torch.from_numpy(r.normal(0, 1, (kg.fo, g.n_slots)).astype(
            np.float32)).to(J.device)
        args = (J, I2, g, c, (act, prev), 0)
        out = kg._launch(*args)
        err, rel = gated_compare(kg, args, out, eng.intmask, per_row=True)
        errs[kg.name] = dict(max_abs_err=err, max_rel_err=rel)
        log(f"  {CHECK_SIDE}^3 {kg.name:20s} inactive bit-equal to prev; "
            f"active max abs err {err:.3e}, rel {rel:.3e}")
    report["check_30_gated"] = dict(kinds=kinds, errors=errs)


def bdt_setup(side, device, num_rungs, grid=None, dt0=None, flags=None):
    """Sedov state and a BdtVE on `device` (grid from the planner unless
    given)."""
    from sphexa_tpu_torch.config import SphConfig
    from sphexa_tpu_torch.init.sedov import init_sedov
    from sphexa_tpu_torch.propagator.ve_bdt import BdtVE

    if grid is None:
        state, box, cfg, grid = sedov(side, device, flags=flags)
    else:
        state, box, cfg = init_sedov(side, SphConfig(), dt0=dt0,
                                     device=device)
    return state, BdtVE(box, grid, cfg, num_rungs=num_rungs, device=device)


def bdt_engine_run(dev):
    """BdtVE at Sedov 10^3 on CMGrid(n=4, cap=128), 3 rungs, two cycles
    on `dev`: (each substep's diagnostics, the rungs after each cycle)."""
    from sphexa_tpu_torch.ops.cellmajor import CMGrid

    state, eng = bdt_setup(10, dev, 3, CMGrid(n=4, cap=128), 2e-4)
    bst = eng.bind_bdt(state)
    ds, rungs = [], []
    for _ in range(2):
        bst, dd = eng.run_cycle(bst)
        ds += [{k: np.asarray(v.cpu()).tolist()
                for k, v in d._asdict().items()} for d in dd]
        rungs.append(bst.rung.cpu().numpy())
    return ds, rungs


def bdt_cpu_ref_main() -> int:
    """--cpu-ref-bdt OUT: bdt_engine_check's CPU side (bdt_engine_run on
    the CPU, plain versions) in a process of its own, to OUT (.json)."""
    sys.path.insert(0, ROOT)
    ds, rungs = bdt_engine_run("cpu")
    with open(sys.argv[2], "w") as f:
        json.dump(dict(ds=ds, rungs=[r.tolist() for r in rungs]), f)
    return 0


def bdt_ref_start():
    """bdt_engine_check's CPU reference, started as a child process at
    the beginning of the script (it takes about a minute on the card's
    host): (process, path)."""
    path = os.path.join(ROOT, "chiprun_out", "bdt_engine_10_cpu.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    return subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
         "--cpu-ref-bdt", path], cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True), path


def bdt_engine_check(report, ref):
    """Phase 3b: BdtVE on the card against BdtVE on the CPU (plain
    versions), Sedov 10^3, CMGrid(n=4, cap=128), 3 rungs, two cycles;
    bounds of tests/test_torch_bdt.py. ref: bdt_ref_start's child
    process computing the CPU side."""
    b, rb = bdt_engine_run(DEVICE)
    proc, path = ref
    _, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, f"BdtVE CPU reference: {err[-2000:]}"
    with open(path) as f:
        cpu = json.load(f)
    a, ra = cpu["ds"], [np.asarray(r) for r in cpu["rungs"]]
    for x, y in zip(a, b):
        assert x["overflow"] == y["overflow"] == 0
        np.testing.assert_allclose(y["dt"], x["dt"], rtol=1e-5)
        np.testing.assert_allclose(y["eint"], x["eint"], rtol=1e-6)
        np.testing.assert_allclose(y["ecin"], x["ecin"], rtol=1e-3,
                                   atol=1e-12)
        assert y["rung_hist"] == x["rung_hist"], (y, x)
        assert y["active_cell_frac"] == x["active_cell_frac"], (y, x)
    for x, y in zip(ra, rb):
        np.testing.assert_array_equal(y, x)
    log(f"  10^3 BdtVE {DEVICE} vs cpu, 2 cycles: rung_hist "
        f"{[d['rung_hist'] for d in b]} equal, active_cell_frac "
        f"{[round(d['active_cell_frac'], 4) for d in b]} equal, last eint "
        f"{b[-1]['eint']:.9f} vs {a[-1]['eint']:.9f}")
    report["bdt_engine_10"] = dict(card=b, cpu=a)


def bdt_main_path(report, cname=None, cycles=2):
    """Phase 6c (and (g) under CONFIGS[cname]): BdtVE at Sedov 100^3
    (the main path's grid), 4 rungs, one warm-up cycle, then `cycles`
    timed cycles of 8 substeps."""
    import torch
    from sphexa_tpu_torch.propagator.common import compute_energies

    side, nr = MAIN_SIDE, 4
    t0 = time.perf_counter()
    state, eng = bdt_setup(side, DEVICE, nr, flags=CONFIGS.get(cname))
    e0 = float(sum(compute_energies(state.p, eng.cfg)))
    bst = eng.bind_bdt(state)
    assert int(bst.rv.overflow) == 0, "slot overflow at bind"
    bst, _ = eng.run_cycle(bst)                        # warm-up
    torch.cuda.synchronize()
    log(f"  setup + warm-up cycle {time.perf_counter() - t0:.1f} s; cap "
        f"{eng.grid.cap}, grid {eng.grid}, Z {eng.pve_gated.zgroup}")

    # an event after the resync and after each substep of run_cycle
    marks = []
    resync, substep = eng.resync, eng.substep

    def marked(fn, what):
        def call(b):
            out = fn(b)
            marks.append((what, torch.cuda.Event(enable_timing=True)))
            marks[-1][1].record()
            return out
        return call
    eng.resync = marked(resync, "resync")
    eng.substep = marked(substep, "substep")
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    diags = []
    start.record()
    for _ in range(cycles):
        bst, ds = eng.run_cycle(bst)
        diags += ds
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    del eng.resync, eng.substep

    nsub = cycles << (nr - 1)
    used = {k.name for k in eng.pve_gated.kernels}
    want = {k.name: nsub if k.name in used else 0 for k in kernels}
    want["ghost_refresh"] = 5 * nsub
    want["pair_gate"] = 5 * nsub          # one a gated stage
    assert launches == want, (launches, want)
    per = 1 + (1 << (nr - 1))          # events a cycle: resync, substeps
    whats = [w for w, _ in marks]
    assert whats == (["resync"] + ["substep"] * (per - 1)) * cycles, whats
    evs = [start] + [e for _, e in marks]
    span = [a.elapsed_time(b) for a, b in zip(evs, evs[1:])]
    cycle_ms = [sum(span[i * per:(i + 1) * per]) for i in range(cycles)]
    resync_ms = span[::per]
    sub_ms = [x for i, x in enumerate(span) if i % per]
    d = {k: [np.asarray(getattr(x, k).cpu()).tolist() for x in diags]
         for k in ("dt", "etot", "ecin", "eint", "active_frac",
                   "active_cell_frac", "rung_hist", "overflow")}
    assert max(d["overflow"]) == 0, "slot overflow"
    rows = [f.name for f in dataclasses.fields(bst) if f.name != "rv"]
    for f in rows:
        assert torch.isfinite(getattr(bst, f)).all(), f"non-finite {f}"
    for f in ("x", "y", "z", "h", "vx", "vy", "vz", "temp", "alpha",
              "du_m1"):
        assert torch.isfinite(getattr(bst.rv, f)).all(), f"non-finite {f}"
    assert min(d["active_cell_frac"]) < 1.0, d["active_cell_frac"]
    drift = abs(d["etot"][-1] - e0) / e0
    assert drift < 5e-3, f"energy drift {drift:.3e}"
    wall = sum(cycle_ms) * 1e-3
    sim_per_wall = sum(d["dt"]) / wall

    # the substep takes no host sync: one more, untimed and uncounted,
    # with PyTorch's sync check turned to errors
    b2, _ = eng.resync(bst)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.substep(b2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

    log(f"  {side}^3 BDT, {nr} rungs: {np.mean(cycle_ms):.3f} ms/cycle "
        f"(cycles {[round(x, 3) for x in cycle_ms]}), "
        f"{sum(cycle_ms) / nsub:.3f} ms/substep, sim-time per wall-second "
        f"{sim_per_wall:.6e}")
    log(f"  active_frac {[round(x, 4) for x in d['active_frac']]}")
    log(f"  active_cell_frac {[round(x, 4) for x in d['active_cell_frac']]}")
    log(f"  rung_hist {d['rung_hist'][-1]}; |etot - e0|/e0 = {drift:.3e}; "
        f"overflow 0; rows finite; substep ran with no host sync")
    log(f"  resync (layout rebin) ms {[round(x, 3) for x in resync_ms]}; "
        f"substep ms {[round(x, 3) for x in sub_ms]}")
    log(f"  launches {dict((k, v) for k, v in launches.items() if v)}, "
        f"every other kernel 0; resyncs (layout rebins) {cycles}")
    report["bdt_main_path" if cname is None
           else f"bdt_main_path_{cname}"] = dict(
        side=side, num_rungs=nr, cycles=cycles, cycle_ms=cycle_ms,
        substep_ms=sum(cycle_ms) / nsub, sim_time_per_wall_s=sim_per_wall,
        resync_ms=resync_ms, substeps_ms=sub_ms, e0=e0, energy_drift=drift,
        diags=d, launches=launches, resyncs=cycles)
    return eng, bst, launches


def bdt_timing(report, eng, bst, launches, cname=None):
    """Phase 6d (and (h) for the gated K8-K10 under CONFIGS[cname]):
    each gated stage at the inputs of substep 1 of a cycle (cells
    skipped), beside the ungated stage at the same inputs."""
    import torch
    import torch.nn.functional as F
    from sphexa_tpu_torch.ops import pair_ve as pv

    grid = eng.grid
    bst, _ = eng.resync(bst)
    bst, _ = eng.substep(bst)                       # all active
    with Spy(eng.pve_gated.kernels) as spy:
        _, d = eng.substep(bst)
    torch.cuda.synchronize()
    acf = float(d.active_cell_frac)
    assert acf < 1.0, acf
    calls = spy.calls
    xh_args = next(a for k, a, _ in calls if k.name == "pair_xh_gated")
    J = xh_args[0]
    act = xh_args[4][0]
    on = pv.supercell_active(act, grid, eng.pve_gated.zgroup)
    on_slot = on.repeat_interleave(grid.cap)
    # in-support pairs of every cell from the ungated stage at the same
    # inputs (the gated output holds prev in inactive supercells)
    nc_sph = pv.pair_xh._launch(J, None, grid, xh_args[3])[2] + 1
    cand, inside, per_slot = pair_counts(J, eng, grid, nc_sph)
    per_act = torch.where(on_slot, per_slot, 0.0)
    cand_a = float(per_act.sum())
    inside_a = float(torch.where(on_slot & valid_slots(J) & eng.intmask,
                                 nc_sph, 0.0).double().sum())
    recount, moved, _ = xh_recounts(J, grid, xh_args[3], per_act)
    # cells whose J rows an active cell reads: active cells and their
    # 26 neighbours
    shape = (grid.npx, grid.np_, grid.npz)
    cell_on = (on.view(shape) & eng.intmask.view(-1, grid.cap)[:, 0]
               .view(shape)).float()
    near = F.max_pool3d(cell_on[None, None], 3, stride=1, padding=1)[0, 0]
    n_read = float(near.sum()) * grid.cap
    n_on = float(cell_on.sum()) * grid.cap
    n_int = float(eng.intmask.sum())
    log(f"  substep 1 inputs: active_cell_frac {acf:.4f}, active "
        f"supercells hold {n_on / n_int:.4f} of interior slots; "
        f"{cand_a:.4e} of {cand:.4e} candidates and {inside_a:.4e} of "
        f"{inside:.4e} in-support pairs in active supercells")
    report["bdt_pairs" if cname is None else f"bdt_pairs_{cname}"] = dict(
        active_cell_frac=acf, candidates=cand, in_support=inside,
        active_candidates=cand_a, active_in_support=inside_a,
        xh_recount_candidates=recount, xh_h_moved=moved,
        active_slot_frac=n_on / n_int, read_slot_frac=n_read / n_int)

    rows = []
    ok_on = on_slot & valid_slots(J) & eng.intmask
    act_mask = on_slot & eng.intmask
    for kg, args, out in calls:
        J, I2, g, c, (act, prev), zgroup = args
        if cname is not None and kg.name.removesuffix("_gated") not in DIRECT:
            continue                # the direct stages are timed above
        k = next(x for x in pv.PAIR_KERNELS
                 if not x.gated and x.name == stage_of(kg.name))
        err, rel = gated_compare(kg, args, out, eng.intmask,
                                 per_row=False)
        nfill = check_fill(kg, J, out, act_mask)
        if kg.name == "pair_av_mm_gated":
            lc = lane_counts(J, g, act_mask)
            report["k9_gated_lanes"] = lc
            log_lanes(f"{kg.name} at cap {g.cap}, active supercells", lc)
        ms = cuda_ms(lambda: kg._launch(*args), 5)
        ungated_ms = cuda_ms(lambda: k._launch(J, I2, g, c), 5)
        plain_ms = cuda_ms(lambda: kg.plain(*args), 1, warmup=False)
        # the same launch with no active supercell: the gate pass, the
        # blocks past the device count and the copy only; both also as
        # device time (a CUDA graph) and host dispatch
        idle = (torch.zeros_like(act), prev)
        idle_ms = cuda_ms(lambda: kg._launch(J, I2, g, c, idle, zgroup), 5)
        sp = split_ms(lambda: kg._launch(*args))
        sp_idle = split_ms(lambda: kg._launch(J, I2, g, c, idle, zgroup))
        report.setdefault("bdt_gated_split", {})[kg.name] = dict(
            substep1=sp, none_active=sp_idle)
        ops = cand_a * GEO_FLOPS + inside_a * BODY_FLOPS[k.name]
        if k.name == "pair_xh":
            ops += recount * RECOUNT_FLOPS
        mm = mm_extra_flops(k.name, J, g, c, ok_on, float(cell_on.sum()))
        fi2 = I2.shape[0] if I2 is not None else 0
        nbytes = 4 * (J.shape[0] * n_read + fi2 * n_on + g.n_slots
                      + kg.fo * (n_int - n_on) + kg.fo * n_int)
        bound, by = pair_bound(ops, nbytes, mm, c.mxu_bf16)
        rows.append(dict(
            name=kg.name, route="cuda",
            source="sphexa_tpu_torch/csrc/cell_pair.cu",
            replaces=GATED_REPLACES, launches=launches[kg.name],
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=None, idle_ms=idle_ms))
        report.setdefault("bdt_ungated_ms", {})[kg.name] = ungated_ms
        log(f"  {kg.name:20s} {ms:9.3f} ms  ungated {ungated_ms:9.3f} ms  "
            f"none active {idle_ms:7.3f} ms  plain {plain_ms:10.3f} ms  "
            f"bound {bound:.4f} ms ({by})  err {err:.3e} (rel {rel:.3e})"
            + (f"; {nfill} invalid active slots at their fill" if nfill
               else ""))
        log(f"    device (CUDA graph) {sp['device_ms']:.4f} ms, none active "
            f"{sp_idle['device_ms']:.4f} ms; host dispatch "
            f"{sp['host_ms']:.4f} ms")
    if cname is None:
        rows.append(gate_timing(report, calls, launches))
    report["kernels_gated" if cname is None
           else f"kernels_gated_{cname}"] = rows
    return rows


def gate_timing(report, calls, launches):
    """Phase (d), after the timing: K2g's gate pass at the substep-1
    inputs (one act row for the five stages): its device count, sorted
    list and supercell flags against supercell_active and its plain
    version (gate_plan), then timed alone (its kernel row, per launch).
    A list built once a substep and shared by the five stages would save
    four of these passes."""
    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv

    gp = pv.pair_gate
    _, (J, I2, g, c, (act, prev), zgroup), _ = calls[0]
    Z = pv.resolve_zgroup(g, zgroup)
    ws = gp._launch(act, g, Z)
    ref = gp.plain(act, g, Z)
    inner = torch.tensor(pv.interior_cells(g), device=act.device)
    n_cells = int(pv.supercell_active(act, g, Z)[inner].sum())
    count, n_ref = int(ws[0]), int(ref[0])
    m = min(count, n_ref)
    listed = ws[pv.GATE_HDR:pv.GATE_HDR + count].sort().values
    flags = pv.gate_flags(g)
    # mismatches: the counts apart, then list entries and flags that differ
    bad = (abs(count - n_cells) + abs(count - n_ref)
           + int((listed[:m] != ref[pv.GATE_HDR:pv.GATE_HDR + m]).sum())
           + int((ws[flags:] != ref[flags:]).sum()))
    if bad:
        raise AssertionError(f"gate pass: count {count}, supercell_active "
                             f"{n_cells}, plain {n_ref}; {bad} mismatches")
    sp = split_ms(lambda: gp._launch(act, g, Z))
    ms = sp["events_ms"]
    plain_ms = cuda_ms(lambda: gp.plain(act, g, Z), 3)
    # act of the interior columns' supercells (their z-ghost cells
    # too) read once; the header, the list and the flags written
    nbytes = 4 * (g.nx * g.n * g.npz * g.cap + pv.GATE_HDR + count
                  + ws.numel() - flags)
    bound = nbytes / HBM_BW * 1e3
    report["gate_pass"] = dict(sp, plain_ms=plain_ms, bound_ms=bound,
                               count=count)
    log(f"  pair_gate  {ms:.4f} ms  plain {plain_ms:.3f} ms  bound "
        f"{bound:.4f} ms (bytes); device (CUDA graph) {sp['device_ms']:.4f} "
        f"ms, host dispatch {sp['host_ms']:.4f} ms; device count {count} = "
        f"supercell_active's, list and flags = its plain version's; a list "
        f"shared by the five stages would save 4 x {sp['device_ms']:.4f} ms "
        f"of device time a substep")
    return dict(
        name="pair_gate", route="cuda",
        source="sphexa_tpu_torch/csrc/cell_pair.cu", replaces=GATE_REPLACES,
        launches=launches["pair_gate"], max_abs_err=float(bad), ms=ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
        library_ms=None)


def _mm_count_body(I, Jn, i2, **_):
    """Per i-slot: in-support pairs, those with W_j > 0, and the
    approaching ones (visc != 0): the pairs for which K10's five weights
    are nonzero (families 0 and 2 / 1 / 3 and 4)."""
    from sphexa_tpu_torch.ops import pair_ve as pv
    rx, ry, rz, d2 = pv._geo(I, Jn)
    hinv = 1.0 / I[pv.RH]
    inside = d2 * (hinv * hinv) < 4.0
    hj_inv = 1.0 / Jn[pv.RH]
    wj = inside & (d2 * (hj_inv * hj_inv) < 4.0)
    rv = (rx * (I[5] - Jn[5]) + ry * (I[6] - Jn[6])
          + rz * (I[7] - Jn[7]))
    return [pv._sum(x.float()) for x in (inside, wj, inside & (rv < 0.0))]


def mm_extra_flops(name, J, grid, cfg, slot_mask, n_cells):
    """Flops of a moment body beyond its per-pair count, as (float32-core
    flops, tensor-core flops): the columns built per (i-cell, staged
    j-slot) for the n_cells computed cells, and K10's contraction, 49
    multiply-adds per pair and family with a nonzero weight over the
    i-slots of slot_mask (counted on these inputs)."""
    from sphexa_tpu_torch.ops import pair_ve as pv
    if name not in COL_FLOPS:
        return 0.0, 0.0
    ops, tc = COL_FLOPS[name] * n_cells * 27 * grid.cap, 0.0
    if name == "pair_momentum_mm":
        cnt = pv._run_plain(_mm_count_body, J, None, grid, 3)
        n_in, n_wj, n_visc = (float(cnt[r][slot_mask].double().sum())
                              for r in range(3))
        tc = MM_FAMILY_FLOPS * (2 * n_in + n_wj + 2 * n_visc)
    return ops, tc


def pair_bound(ops, nbytes, mm=(0.0, 0.0), bf16=False):
    """(bound ms, bound_by) of a pair kernel: the largest of its
    float32-core flops (ops and mm's first) over FP32_PEAK, its
    tensor-core flops (mm's second: K10's contraction, three TF32
    products a flop in 3xTF32, one bf16 product under mxu_bf16) over
    their peak, and its bytes over HBM_BW."""
    t_ops = max((ops + mm[0]) / FP32_PEAK,
                mm[1] / BF16_PEAK if bf16 else 3 * mm[1] / TF32_PEAK) * 1e3
    t_bytes = nbytes / HBM_BW * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def mm_nonzero_blocks(w, ks):
    """[C, R // 16, W // ks]: which (16-row i-tile, k-step of ks j-slots)
    blocks of K10's pair weights w [C, R, W] (one family) hold a nonzero
    weight: the blocks the kernel issues (mm::mm_cell's warp vote)."""
    C, R, W = w.shape
    return (w != 0).view(C, R // 16, 16, W // ks, ks).any(4).any(2)


def mm_block_counts(J, grid, cfg):
    """K10's (16-row i-tile, k-step, family) blocks on these inputs under
    the kernel's schedule (csrc/cell_pair.cu mm::mm_cell): the i-tiles of
    each interior cell against the occupied 32-slot groups of its 27
    neighbour cells in nb-then-slot order, cut into k-steps of 8 j-slots
    (16 under mxu_bf16). Returns (the blocks whose weights for a family,
    by the plain version's arithmetic and bf16-rounded under mxu_bf16,
    are not all zero: what the kernel issues; the blocks of each
    group's k-steps up to its last valid slot in the 64-slot i-blocks
    holding a valid slot: what it stages; the dense count over every
    slot of the 27 cells)."""
    import torch
    from unittest import mock
    from sphexa_tpu_torch.ops import pair_ve as pv

    cap, dev = grid.cap, J.device
    G, ks = cap // MM_UJ, 16 if cfg.mxu_bf16 else 8
    nit = -(-cap // 16)
    valid = valid_slots(J)
    cells = torch.tensor(pv.interior_cells(grid), device=dev)
    offs = torch.tensor(pv._nbr_offsets(grid), device=dev)
    lane = torch.arange(cap, device=dev)
    slot = torch.arange(MM_UJ, device=dev)
    kw = pv.pair_momentum_mm._body_kw(cfg)
    issued, staged = [0], 0

    def contract(w, cols):
        issued[0] += int(mm_nonzero_blocks(w, ks).sum())
        return w.new_zeros((*w.shape[:2], len(cols)))

    chunk = max(1, pv._PAIR_BUDGET // (27 * cap * cap))
    for c0 in range(0, cells.shape[0], chunk):
        cc = cells[c0:c0 + chunk]
        C = cc.shape[0]
        groups = ((cc[:, None] + offs)[:, :, None] * cap + lane).view(
            C, 27 * G, MM_UJ)
        gv = valid[groups]
        occ = gv.any(-1)
        order = torch.argsort((~occ).to(torch.int8), dim=1, stable=True)
        nrun = MM_UJ * int(occ.sum(1).max())
        run = groups.gather(1, order[..., None].expand(-1, -1, MM_UJ)).view(
            C, -1)[:, :nrun]
        own = cc[:, None] * cap + lane
        I = J[:, own].reshape(J.shape[0], C, cap, 1)
        Jn = J[:, run].reshape(J.shape[0], C, 1, nrun)
        with mock.patch.object(pv, "_contract", contract):
            pv._momentum_mm_body(I, Jn, None, **kw)
        last = torch.where(gv, slot, -1).amax(-1)
        nks = torch.where(last >= 0, last // ks + 1, 0).sum(1)
        iv = valid[own]
        blocks = sum(iv[:, b:b + MM_IB].any(1).long()
                     for b in range(0, cap, MM_IB))
        staged += int((MM_NF * (MM_IB // 16) * nks * blocks).sum())
    dense = cells.shape[0] * MM_NF * nit * 27 * cap // ks
    return issued[0], staged, dense


def mm_blocks(k, args, what):
    """K10's issued and staged blocks counted on the card (a stats
    buffer, mm::mm_cell) beside mm_block_counts' prediction for the same
    inputs: the staged count must be equal, the issued one within 1e-3
    of it (a weight at the edge of zero can differ in its last bits
    between the kernel's and the plain version's arithmetic)."""
    import torch
    J, I2, g, c = args
    st = torch.zeros(3, dtype=torch.int64, device=DEVICE)
    k._launch(*args, stats=st)
    torch.cuda.synchronize()
    got_i, got_s = (int(v) for v in st.tolist()[:2])
    pred_i, pred_s, dense = mm_block_counts(J, g, c)
    log(f"  {what}: {got_i} mma blocks issued (predicted {pred_i}), "
        f"{got_s} staged (predicted {pred_s}), {dense} dense: "
        f"{got_i / max(got_s, 1):.4f} of the staged, "
        f"{got_i / max(dense, 1):.4f} of the dense")
    if got_s != pred_s or abs(got_i - pred_i) > 1e-3 * pred_i:
        raise AssertionError(f"K10 blocks: issued {got_i} (predicted "
                             f"{pred_i}), staged {got_s} ({pred_s})")
    return dict(issued=got_i, staged=got_s, dense=dense,
                predicted_issued=pred_i, predicted_staged=pred_s)


def mm_ptxas():
    """Registers and spills of every K8, K9 and K10 form
    (routine_ptxas)."""
    regs = routine_ptxas()
    return {k: v for k, v in regs.items() if k != "raw" and
            ("IadMm" in k or "AvMm" in k or "mm_cell" in k
             or "cell_mm" in k)}


def mm_kernel_check(report):
    """Phase (e): K8, K9, K10 (float32 and bf16) and K7c against their
    plain versions at Sedov 30^3 (perturbed), on the inputs of one step
    of the engine under each configuration; then the gated K8-K10 on
    the seeded activity pattern."""
    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv
    from sphexa_tpu_torch.propagator.ve_cellmajor import ResidentVE

    calls = {}
    for cname in ("mm", "avclean"):
        state, box, cfg, grid = sedov(CHECK_SIDE, DEVICE, perturb_seed=0,
                                      flags=CONFIGS[cname])
        eng = ResidentVE(box, grid, cfg, device=DEVICE)
        with Spy(pv.MM_KERNELS + (pv.pair_momentum_avclean,)) as spy:
            eng.step(eng.bind(state))
        torch.cuda.synchronize()
        for k, args, out in spy.calls:
            calls[k.name] = (k, args, out)
    assert sorted(calls) == sorted(DIRECT), sorted(calls)
    k, (J, I2, g, c), _ = calls["pair_momentum_mm"]
    bf = (J, I2, g, c.replace(mxu_bf16=True))
    calls["pair_momentum_mm_bf16"] = (k, bf, k._launch(*bf))
    errs = {}
    for name, (k, args, out) in calls.items():
        mask = valid_slots(args[0]) & eng.intmask
        if name.endswith("_bf16"):
            err, share = bf16_compare(k, args, out, mask)
            errs[name] = dict(max_abs_err=err, share_of_bf16_error=share)
            log(f"  {CHECK_SIDE}^3 {name:22s} max abs err {err:.3e}, at "
                f"most {share:.3e} of the bf16-to-float32 distance")
            continue
        err, rel = compare(k.name, k.plain(*args), out, mask, per_row=True)
        nfill = check_fill(k, args[0], out, eng.intmask)
        errs[name] = dict(max_abs_err=err, max_rel_err=rel, fill_slots=nfill)
        log(f"  {CHECK_SIDE}^3 {name:22s} max abs err {err:.3e}, "
            f"max rel err (to row scale) {rel:.3e}"
            + (f"; {nfill} invalid interior slots at {FILL[name]}"
               if nfill else ""))
    J0 = calls["pair_iad_mm"][1][0]
    act, kinds = activity_pattern(grid, valid_slots(J0), seed=3)
    r = np.random.default_rng(4)
    for name in ("pair_iad_mm", "pair_av_mm", "pair_momentum_mm"):
        k, (J, I2, g, c), _ = calls[name]
        kg = next(x for x in pv.GATED_KERNELS if x.name == name + "_gated")
        prev = torch.from_numpy(r.normal(0, 1, (kg.fo, g.n_slots)).astype(
            np.float32)).to(J.device)
        args = (J, I2, g, c, (act, prev), 0)
        err, rel = gated_compare(kg, args, kg._launch(*args), eng.intmask,
                                 per_row=True)
        errs[kg.name] = dict(max_abs_err=err, max_rel_err=rel)
        log(f"  {CHECK_SIDE}^3 {kg.name:22s} inactive bit-equal to prev; "
            f"active max abs err {err:.3e}, rel {rel:.3e}")
    report["check_30_mm"] = dict(grid=str(grid), kinds=kinds, errors=errs)
    return {name: (k, args) for name, (k, args, _) in calls.items()}


def mm_timing(report, eng, rst, grid, launches, bf16_launches=None):
    """Phase (h): each new kernel that the engine `eng` (state rst) runs,
    at the 100^3 inputs of one of its steps, beside its direct
    counterpart on the same inputs, its plain version and its bound.
    With bf16_launches (the counts of the mxu_bf16 run), K10 again with
    mxu_bf16 on the same inputs."""
    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv

    with Spy(pv.KERNELS[1:] + pv.MM_KERNELS
             + (pv.pair_momentum_avclean,)) as spy:
        eng.step(rst)
    torch.cuda.synchronize()
    calls = {k.name: (k, args, out) for k, args, out in spy.calls}
    xh_J = calls["pair_xh"][1][0]
    nc_sph = calls["pair_xh"][2][2] + 1
    cand, inside, _ = pair_counts(xh_J, eng, grid, nc_sph)
    ok = valid_slots(xh_J) & eng.intmask
    n_cells = grid.nx * grid.n * grid.nz
    runs = [(name, name, launches[name], args, out)
            for name, (k, args, out) in calls.items() if name in DIRECT]
    if bf16_launches is not None:
        J, I2, g, c = calls["pair_momentum_mm"][1]
        args = (J, I2, g, c.replace(mxu_bf16=True))
        runs.append(("pair_momentum_mm", "pair_momentum_mm_bf16",
                     bf16_launches["pair_momentum_mm"], args,
                     pv.pair_momentum_mm._launch(*args)))
    rows = []
    if "pair_momentum_mm" in calls:
        regs = mm_ptxas()
        spilled = [k for k, v in regs.items()
                   if v.get("spill_stores") or v.get("spill_loads")]
        log(f"  K8, K9 and K10 registers and spills (ptxas): {regs}")
        log(f"  spills in the K8, K9 and K10 forms: {spilled or 'none'}")
        report["mm_ptxas"] = regs
    for name, row_name, launched, args, out in runs:
        k = calls[name][0]
        J, I2, g, c = args
        if name == "pair_momentum_mm":
            report[f"{row_name}_blocks"] = mm_blocks(
                k, args, f"{row_name} at the 100^3 inputs")
        if c.mxu_bf16:
            err, rel = bf16_compare(k, args, out, ok)
        else:
            err, rel = compare(name, k.plain(*args), out, ok, per_row=False)
        nfill = check_fill(k, J, out, eng.intmask)
        if name == "pair_av_mm":
            lc = lane_counts(J, g, eng.intmask)
            report["k9_lanes"] = lc
            log_lanes(f"{name} at cap {g.cap} ({nfill} invalid interior "
                      f"slots at 0)", lc)
        ms = cuda_ms(lambda: k._launch(*args), 5)
        plain_ms = cuda_ms(lambda: k.plain(*args), 1, warmup=False)
        direct = next(x for x in pv.KERNELS if x.name == DIRECT[name])
        Jd = J[:direct.fj].contiguous()
        direct_ms = cuda_ms(lambda: direct._launch(Jd, I2, g, c), 5)
        ops = cand * GEO_FLOPS + inside * BODY_FLOPS[name]
        nbytes = 4 * (J.numel() + (I2.numel() if I2 is not None else 0)
                      + out.numel())
        bound, by = pair_bound(ops, nbytes,
                               mm_extra_flops(name, J, g, c, ok, n_cells),
                               c.mxu_bf16)
        rows.append(dict(
            name=row_name, route="cuda",
            source="sphexa_tpu_torch/csrc/cell_pair.cu",
            replaces=REPLACES[name], launches=launched, max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=None, direct_ms=direct_ms))
        log(f"  {row_name:22s} {ms:9.3f} ms  {DIRECT[name]} "
            f"{direct_ms:8.3f} ms  plain {plain_ms:10.3f} ms  bound "
            f"{bound:.4f} ms ({by})  err {err:.3e} (rel {rel:.3e})")
    report.setdefault("kernels_mm", []).extend(rows)
    return rows


def cell_kernel(kc):
    """The cell-launch kernel of a column kernel."""
    from sphexa_tpu_torch.ops import pair_ve as pv
    return next(k for k in pv.PAIR_KERNELS if not k.gated and not k.column
                and k.name == kc.name.removesuffix("_column"))


def launch_zseg(kc, args, zseg):
    """One K11 launch at z-segment zseg."""
    saved = kc.zseg
    kc.zseg = zseg
    try:
        return kc._launch(*args)
    finally:
        kc.zseg = saved


def column_row_name(kc, cfg):
    return kc.name + ("_bf16" if cfg.mxu_bf16 else "")


def column_check(report):
    """(i) K11 at Sedov 30^3 (perturbed), under each configuration: the
    inputs of one column-mode step; every column stage against its plain
    version (the cell stages' tolerances) and against the cell launch on
    the same inputs at z-segments 1, 3 and nz: interior slots bit-equal,
    the rest 0."""
    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv
    from sphexa_tpu_torch.propagator.ve_cellmajor import ResidentVE

    errs = {}
    for cname, stages in COLUMN_STAGES.items():
        state, box, cfg, grid = sedov(CHECK_SIDE, DEVICE, perturb_seed=0,
                                      flags=CONFIGS.get(cname))
        eng = ResidentVE(box, grid, cfg, device=DEVICE)
        eng.pve = pv.PairVE(grid, cfg, kernel_mode="column")
        with Spy(pv.COLUMN_KERNELS) as spy:
            eng.step(eng.bind(state))
        torch.cuda.synchronize()
        assert len(spy.calls) == 5, [k.name for k, _, _ in spy.calls]
        inside = eng.intmask
        for kc, args, out in spy.calls:
            name = kc.name.removesuffix("_column")
            if name not in stages:
                continue
            J, I2, g, c = args
            mask = valid_slots(J) & inside
            if c.mxu_bf16:
                err, rel = bf16_compare(kc, args, out, mask)
            else:
                err, rel = compare(name, kc.plain(*args), out, mask,
                                   per_row=True)
            cell = cell_kernel(kc)._launch(*args)
            forms = (1, 3, g.nz)
            for zseg in forms:
                o = launch_zseg(kc, args, zseg)
                if not (torch.equal(o[:, inside], cell[:, inside])
                        and not o[:, ~inside].any()):
                    raise AssertionError(
                        f"{kc.name} zseg {zseg}: not bit-equal to the cell "
                        f"launch")
            row = column_row_name(kc, c)
            errs[row] = dict(max_abs_err=err, rel=rel, zsegs=forms)
            log(f"  {CHECK_SIDE}^3 {row:30s} plain err {err:.3e} (rel "
                f"{rel:.3e}); bit-equal to the cell launch at z-segments "
                f"{forms}")
        del eng
    report["check_30_column"] = errs


def column_main_path(report, cname):
    """(i) Sedov 100^3 under CONFIGS[cname] (None: the direct bodies):
    the resident step with a column-mode pve for COLUMN_STEPS steps,
    against the cell-mode step from the same bound state, counters zeroed
    before each run and read after. Returns (column engine, state,
    launches of the column run)."""
    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv
    from sphexa_tpu_torch.propagator.common import compute_energies
    from sphexa_tpu_torch.propagator.ve_cellmajor import ResidentVE

    state, box, cfg, grid = sedov(MAIN_SIDE, DEVICE, flags=CONFIGS.get(cname))
    e0 = float(sum(compute_energies(state.p, cfg)))
    kernels = all_kernels()
    runs = {}
    for mode in ("cell", "column"):
        eng = ResidentVE(box, grid, cfg, device=DEVICE)
        eng.pve = pv.PairVE(grid, cfg, kernel_mode=mode)
        rst = eng.bind(state)
        assert int(rst.overflow) == 0, "slot overflow at bind"
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(COLUMN_STEPS + 1)]
        ev[0].record()
        diags = []
        for i in range(COLUMN_STEPS):
            rst, d = eng.step(rst)
            ev[i + 1].record()
            diags.append({k: float(v) for k, v in d._asdict().items()})
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in kernels}
        used = {k.name for k in eng.pve.kernels}
        want = {k.name: COLUMN_STEPS if k.name in used else 0
                for k in kernels}
        want["ghost_refresh"] = 5 * COLUMN_STEPS
        assert launches == want, (mode, launches, want)
        runs[mode] = dict(eng=eng, rst=rst, diags=diags, launches=launches,
                          step_ms=[a.elapsed_time(b)
                                   for a, b in zip(ev, ev[1:])])
    a, b = runs["cell"]["diags"], runs["column"]["diags"]
    for x, y in zip(a, b):
        assert x["overflow"] == y["overflow"] == 0, "slot overflow"
        np.testing.assert_allclose(y["dt"], x["dt"], rtol=1e-5)
        np.testing.assert_allclose(y["eint"], x["eint"], rtol=1e-6)
        np.testing.assert_allclose(y["ecin"], x["ecin"], rtol=1e-3,
                                   atol=1e-12)
    drift = abs(b[-1]["etot"] - e0) / e0
    assert drift < 5e-3, f"energy drift {drift:.3e}"
    rc, rl = runs["cell"]["rst"], runs["column"]["rst"]
    fields = [f.name for f in dataclasses.fields(rl)
              if isinstance(getattr(rl, f.name), torch.Tensor)]
    for f in fields:
        assert torch.isfinite(getattr(rl, f).float()).all(), f"non-finite {f}"
    bit_equal = all(torch.equal(getattr(rc, f), getattr(rl, f))
                    for f in fields)
    key = "direct" if cname is None else cname
    used = [k.name for k in runs["column"]["eng"].pve.kernels]
    ms = {m: [round(x, 3) for x in runs[m]["step_ms"]] for m in runs}
    log(f"  100^3 {key}: column step ms {ms['column']}, cell step ms "
        f"{ms['cell']}; "
        f"dt, eint, ecin within the resident bounds, overflow 0, drift "
        f"{drift:.3e}, state bit-equal to the cell step: {bit_equal}; "
        f"launches {used} {COLUMN_STEPS} each, cell pair kernels 0")
    report.setdefault("column_main_path", {})[key] = dict(
        cell_step_ms=runs["cell"]["step_ms"],
        column_step_ms=runs["column"]["step_ms"], cell=a, column=b,
        energy_drift=drift, bit_equal=bit_equal,
        launches=runs["column"]["launches"])
    del runs["cell"]
    return runs["column"]["eng"], rl, runs["column"]["launches"]


def column_timing(report, cname, eng, rst, launches):
    """(i) each column stage of the config at the 100^3 inputs of one
    column-mode step: ms at its z-segment and at the others tried,
    beside the cell launch, the plain version and the bound."""
    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv

    grid = eng.grid
    with Spy(pv.COLUMN_KERNELS) as spy:
        eng.step(rst)
    torch.cuda.synchronize()
    calls = {k.name: (k, args, out) for k, args, out in spy.calls}
    xh = calls["pair_xh_column"]
    nc_sph = xh[2][2] + 1
    xh_J, _, _, xh_cfg = xh[1]
    cand, inside, per_slot = pair_counts(xh_J, eng, grid, nc_sph)
    ok = valid_slots(xh_J) & eng.intmask
    n_cells = grid.nx * grid.n * grid.nz
    rows = []
    for kc, args, out in spy.calls:
        name = kc.name.removesuffix("_column")
        if name not in COLUMN_STAGES[cname]:
            continue
        J, I2, g, c = args
        if c.mxu_bf16:
            err, rel = bf16_compare(kc, args, out, ok)
        else:
            err, rel = compare(name, kc.plain(*args), out, ok, per_row=False)
        nfill = check_fill(kc, J, out, eng.intmask)
        if name == "pair_av_mm":
            lc = lane_counts(J, g, eng.intmask)
            report["k9_column_lanes"] = lc
            log_lanes(f"{kc.name} at cap {g.cap} ({nfill} invalid interior "
                      f"slots at 0)", lc)
        ms = cuda_ms(lambda: kc._launch(*args), 5)
        forms = {f"S{zseg}": cuda_ms(lambda: launch_zseg(kc, args, zseg), 3)
                 for zseg in (1, 2, 4, 8, g.nz)}
        cell = cell_kernel(kc)
        cell_ms = cuda_ms(lambda: cell._launch(*args), 5)
        plain_ms = cuda_ms(lambda: kc.plain(*args), 1, warmup=False)
        ops = cand * GEO_FLOPS + inside * BODY_FLOPS[name]
        if name == "pair_xh":
            ops += xh_recounts(J, g, c, per_slot)[0] * RECOUNT_FLOPS
        nbytes = 4 * (J.numel() + (I2.numel() if I2 is not None else 0)
                      + out.numel())
        bound, by = pair_bound(ops, nbytes,
                               mm_extra_flops(name, J, g, c, ok, n_cells),
                               c.mxu_bf16)
        row_name = column_row_name(kc, c)
        rows.append(dict(
            name=row_name, route="cuda",
            source="sphexa_tpu_torch/csrc/cell_pair.cu",
            replaces=COLUMN_REPLACES, launches=launches[kc.name],
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by,
            library_ms=None, cell_ms=cell_ms, form=f"S{kc.zseg}"))
        report.setdefault("column_forms_ms", {})[row_name] = forms
        log(f"  {row_name:30s} {ms:9.3f} ms (S{kc.zseg})  cell "
            f"{cell_ms:8.3f} ms  "
            f"plain {plain_ms:10.3f} ms  bound {bound:.4f} ms ({by}) "
            f" err {err:.3e}")
        log("    forms: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                      forms.items()))
    report.setdefault("kernels_column", []).extend(rows)
    return rows


def probes_phase(report):
    """(j) P1-P5: each probe's sweep at its script's sizes (counters
    zeroed before, read after), then each kernel against its plain
    version on the card, the TMA variants also through the libcuda
    build, and the library yardsticks. P2-P4: a call's bytes three ways
    and the designs on sources that fit the L2. P5: both designs (and
    wgmma with its overlap off) in every mode at vpu_flops 0 and 30,
    each a row with its own bound, and wgmma's time at 2 NCELL."""
    import torch
    from sphexa_tpu_torch.ops import _cuda
    from sphexa_tpu_torch.probes import fma_ceiling as p1
    from sphexa_tpu_torch.probes import mma_micro as p5
    from sphexa_tpu_torch.probes import mma_parts
    from sphexa_tpu_torch.probes import staging_lab as st

    probes = [p1.fma_chains, *st.PROBES.values()]
    for p in probes:
        p.launches = 0
    p5.mma_cells.launches = dict.fromkeys(p5.mma_cells.launches, 0)
    s1 = p1.sweep()
    for p in s1:
        log(f"  P1 rows={p['rows']:<2d} chains={p['nchain']:<2d} "
            f"{p['ms']:8.3f} ms  {p['gflops']:9.0f} Gflop/s (2 a step)  "
            f"{p['fp32_pipe_gflops']:9.0f} Gflop/s (fp32 pipe)")
    s5 = p5.sweep()
    for q in s5:
        log(f"  P5 {q['mode']:12s} vpu={q['vpu_flops']:<2d} "
            f"{q['design']:12s} {q['ms']:8.3f} ms"
            f"  {q['card_cycles_per_cell']:7.1f} cyc/cell (card)  "
            f"{q['sm_cycles_per_cell']:8.0f} cyc/cell (one SM) at "
            f"{q['sm_mhz']:.0f} MHz")
    s2 = st.sweep()
    torch.cuda.synchronize()
    launches = {p.name: p.launches for p in probes}
    launches.update({"p5_" + d: n
                     for d, n in p5.mma_cells.launches.items()})
    assert all(launches.values()), launches
    report["probe_sweeps"] = dict(P1=s1, P2_P4=s2, P5=s5)
    rows = []

    # P1: every chain count at rows 8 against plain (seeded inputs); the
    # row at rows 32 and the chain count of the highest rate
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.uniform(0.5, 2.0, (p1.NCELL * 8, p1.W)).astype(
        np.float32)).to(DEVICE)
    err1 = 0.0
    for nchain in p1.CHAINS:
        length = p1.STEPS // nchain
        out = p1.fma_chains._launch(x, nchain, length)
        ref = p1.fma_chains.plain(x, nchain, length)
        torch.testing.assert_close(out, ref, rtol=1e-6, atol=0)
        err1 = max(err1, float((out - ref).abs().max()))
    best = max((p for p in s1 if p["rows"] == 32),
               key=lambda p: p["fp32_pipe_gflops"])
    n = p1.NCELL * 32 * p1.W
    xb = torch.ones((n // p1.W, p1.W), dtype=torch.float32, device=DEVICE)
    plain_ms = cuda_ms(lambda: p1.fma_chains.plain(xb, best["nchain"],
                                                   best["length"]), 1)
    t_ops = n * p1.STEPS * 2 / (FP32_PEAK / 2) * 1e3
    t_bytes = 8 * n / HBM_BW * 1e3
    rows.append(dict(name="fma_chains", route="cuda",
                     source="sphexa_tpu_torch/csrc/probes.cu",
                     replaces=PROBE_REPLACES["fma_chains"],
                     launches=launches["fma_chains"], max_abs_err=err1,
                     ms=best["ms"], plain_ms=plain_ms,
                     bound_ms=max(t_ops, t_bytes),
                     bound_by="operations" if t_ops >= t_bytes else "bytes",
                     library_ms=None, point=f"rows 32, chains "
                     f"{best['nchain']}"))
    plateau = max(p["fp32_pipe_gflops"] for p in s1)
    log(f"  P1 plateau {plateau:.0f} Gflop/s on the fp32 pipe (data sheet "
        f"67000); rows 32 best at {best['nchain']} chains")
    report["fp32_plateau_gflops"] = plateau

    # P2-P4 at the script's sizes, 4 reps summed
    src, starts = (t.to(DEVICE) for t in st.inputs(st.K, st.F, st.NS,
                                                   st.NPROG))
    nprog = st.NPROG

    def reps(fn):
        out = torch.zeros((nprog * 8, 128), dtype=torch.float32,
                          device=DEVICE)
        for _ in range(st.REPS):
            fn(out)
        return out
    refs = {}
    for design, probe in st.PROBES.items():
        fn = st.VARIANTS[design][1]
        if fn not in refs:
            refs[fn] = reps(lambda o: probe.plain(src, starts, o, st.K))
        out = reps(lambda o: probe._launch(src, starts, o, st.K))
        torch.testing.assert_close(out, refs[fn], rtol=1e-6, atol=0)
    enc = {lib: _cuda.tma_encoder(lib) for lib in ("probes.cu",
                                                     "probes_libcuda")}
    for variant, fn in ((2, "many"), (3, "few")):
        out = reps(lambda o: _cuda.staging_launch(
            variant, src, starts, o, st.K, library="probes_libcuda"))
        torch.testing.assert_close(out, refs[fn], rtol=1e-6, atol=0)
    log(f"  P2-P4 outputs equal their plain versions (4 reps summed); TMA "
        f"encoder reached {enc} (1: runtime entry point, 2: libcuda), the "
        f"libcuda build's TMA variants equal too")
    report["tma_encoder"] = enc
    # the bytes of a call three ways (staging_lab.byte_counts: touched
    # lanes once, the windows as staged, an LRU cache of this card's L2
    # in the script's program order; counted on the host, so they stay
    # out of the kernel rows), and the designs on sources of 12.6 to 201
    # MB with the same windows: the time when the source fits L2
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    counts = {fn: st.byte_counts(fn, starts.cpu(), st.K, st.F, st.NS, nprog,
                                 l2) for fn in ("many", "few", "pipe")}
    foot = st.footprint_sweep()
    report["staging_counts"] = dict(l2_bytes=l2, counts=counts,
                                    footprint=foot)
    for c in foot:
        log(f"  {c['design']:9s} source {c['source_mb']:6.1f} MB "
            f"{c['ms']:8.3f} ms/call")
    for p in s2:
        design = p["design"]
        probe = st.PROBES[design]
        fn = st.VARIANTS[design][1]
        idx = st._INDEX[fn](src, starts, st.K, nprog).reshape(-1)
        buf = src.new_empty((src.shape[0], idx.numel()))
        lib_ms = cuda_ms(lambda: torch.index_select(src, 1, idx, out=buf), 10)
        o = torch.zeros((nprog * 8, 128), dtype=torch.float32, device=DEVICE)
        plain_ms = cuda_ms(lambda: probe.plain(src, starts, o, st.K), 2)
        c = counts[fn]
        t = {k: (c[k] + c["extra"]) / HBM_BW * 1e3
             for k in ("unique", "windows", "lru")}
        l2_ms = min(q["ms"] for q in foot if q["design"] == design)
        rows.append(dict(name=probe.name, route="cuda",
                         source="sphexa_tpu_torch/csrc/probes.cu",
                         replaces=PROBE_REPLACES[probe.name],
                         launches=launches[probe.name], max_abs_err=0.0,
                         ms=p["ms"], plain_ms=plain_ms,
                         bound_ms=t["unique"], bound_by="bytes",
                         library_ms=lib_ms, l2_resident_ms=l2_ms))
        log(f"  {design:9s} {p['ms']:8.3f} ms/call  "
            f"{p['us_per_window'] * 1e3:8.2f} ns/window  {p['gbs']:8.1f} "
            f"GB/s of windows  index_select {lib_ms:.3f} ms  counted bytes "
            f"at 3.35 TB/s: unique {t['unique']:.4f} ms, windows "
            f"{t['windows']:.4f}, LRU {t['lru']:.4f} (share "
            f"{t['lru'] / p['ms']:.3f}); L2-resident {l2_ms:.3f} ms")

    # P5: every design, mode and vpu_flops against plain (seeded x) at
    # the script's NCELL, the wgmma kernel at 2 NCELL (every cell's work
    # runs: 1.8-2.2x), and a row a design, mode and vpu_flops
    x5 = torch.from_numpy(np.random.default_rng(1).uniform(
        -1.0, 1.0, (p5.FJ, p5.RUNW)).astype(np.float32)).to(DEVICE)
    tol = {"none": 1e-5, "f32": 5e-3, "f32_highest": 1e-5, "bf16": 1e-5}
    err5 = {}
    for q in s5:
        mode, vf, design = q["mode"], q["vpu_flops"], q["design"]
        out = p5.mma_cells._launch(x5, mode, vf, p5.NCELL, design)
        ref = p5.mma_cells.plain(x5, mode, vf, p5.NCELL)
        e = float((out - ref).abs().max()) / float(ref.abs().max())
        if e > tol[mode]:
            raise AssertionError(f"P5 {design} {mode} vpu={vf}: {e:.3e} of "
                                 f"scale")
        err5[(design, mode, vf)] = float((out - ref).abs().max())
    scal = p5.scaling()
    report["p5_scaling"] = scal
    for q in scal:
        log(f"  P5 wgmma {q['mode']:12s} vpu={q['vpu_flops']:<2d} "
            f"{q['ms']:8.3f} ms at NCELL, {q['ms_2x']:8.3f} at 2 NCELL "
            f"({q['ratio']:.3f}x)")
        if not 1.8 <= q["ratio"] <= 2.2:
            raise AssertionError(f"P5 wgmma {q['mode']} vpu="
                                 f"{q['vpu_flops']}: 2 NCELL takes "
                                 f"{q['ratio']:.3f}x NCELL's time")
    B = x5[0:p5.K, 0:p5.RUNW].T.contiguous()
    xr = x5[0:1, :p5.RUNW] + torch.arange(p5.CAP, dtype=torch.float32,
                                          device=DEVICE)[:, None]
    A = torch.cat([xr * (1.0 + g) for g in range(9)]).repeat(p5.NCELL, 1)
    lib = {}                    # the values do not change a product's time
    for tf32 in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        lib["f32" if tf32 else "f32_highest"] = cuda_ms(lambda: A @ B, 5)
    torch.backends.cuda.matmul.allow_tf32 = False
    Ab, Bb = A.bfloat16(), B.bfloat16()
    lib["bf16"] = cuda_ms(lambda: Ab @ Bb, 5)
    del A, Ab
    # the wgmma kernel with its elementwise work or its product removed
    parts = mma_parts.sweep()
    report["p5_parts"] = parts
    part_ms = {(q["mode"], q["vpu_flops"], q["part"]): q["ms"] for q in parts}
    for q in parts:
        log(f"  P5 wgmma {q['mode']:12s} vpu={q['vpu_flops']:<2d} "
            f"{q['part']:12s} {q['ms']:8.4f} ms")
    tc = {"none": 0.0, "f32": p5.dot_flops() / TF32_PEAK * 1e3,
          "f32_highest": 3 * p5.dot_flops() / TF32_PEAK * 1e3,
          "bf16": p5.dot_flops() / BF16_PEAK * 1e3}
    plain5 = {}
    for q in s5:
        mode, vf, design = q["mode"], q["vpu_flops"], q["design"]
        if (mode, vf) not in plain5:
            plain5[(mode, vf)] = cuda_ms(lambda: p5.mma_cells.plain(
                x5, mode, vf, p5.NCELL), 3)
        bound = max(p5.vpu_ops(vf) / (FP32_PEAK / 2) * 1e3, tc[mode])
        name = (f"mma_cells_none_vpu{vf}" if mode == "none"
                else f"mma_cells_{design}_{mode}_vpu{vf}")
        rows.append(dict(name=name, route="cuda",
                         source="sphexa_tpu_torch/csrc/probes.cu",
                         replaces=PROBE_REPLACES["mma_cells"],
                         launches=launches["p5_" + design],
                         max_abs_err=err5[(design, mode, vf)], ms=q["ms"],
                         plain_ms=plain5[(mode, vf)], bound_ms=bound,
                         bound_by="operations", library_ms=lib.get(mode),
                         registers=q["registers"],
                         local_bytes=q["local_bytes"],
                         blocks_per_sm=q["blocks_per_sm"],
                         product_ms=part_ms.get((mode, 0, "product"))
                         if design == "wgmma" else None,
                         elementwise_ms=part_ms.get((mode, vf, "elementwise"))
                         if design == "wgmma" else None))
        log(f"  {name:36s} {q['ms']:8.3f} ms  bound {bound:.4f} ms (share "
            f"{bound / q['ms']:.3f})  {q['registers']} registers, "
            f"{q['local_bytes']} B spilled, {q['blocks_per_sm']} blocks/SM")
    log(f"  P5 library (torch.matmul of the {9 * p5.NCELL} products): TF32 "
        f"{lib['f32']:.3f} ms, float32 {lib['f32_highest']:.3f} ms, bf16 "
        f"{lib['bf16']:.3f} ms")
    report["kernels_probes"] = rows
    return rows


# ---------------------------------------------------------------------------
# (k): the slab-sharded engines on one card, and K1z
# ---------------------------------------------------------------------------

SHARD_SIDE = 12               # card against CPU (tests/test_torch_sharded*)
SHARD_D = (2, 4)              # 100^3 resident runs
SHARD_STEPS = 5               # timed steps after one warm-up step
SHARD_CHECK_AT = 3            # steps from the bound state held against one card
SHARD_SAMPLE_CELLS = 128      # cells of each pair call held against plain
K1Z_REPLACES = "sphexa_tpu/ops/pallas_ve.py:397-403"
# the z-exchanges of one resident sharded step: base rows, j rows, then
# _run_pipeline's [xm, h], [kx, gradh], [cij, divv, curlv], [alpha]
ZX_ROWS = ((5, 2), (6, -1), (2, -1), (2, -1), (8, -1), (1, -1))


_SHARDED = {}


def sharded_setup(D):
    """Sedov 100^3 on the card, sized for D shards by the port's slab
    planner (the JAX adapter's _slab_setup)."""
    from sphexa_tpu_torch.config import SphConfig
    from sphexa_tpu_torch.init.sedov import init_sedov
    from sphexa_tpu_torch.propagator.ve_sharded import plan_slab

    if D not in _SHARDED:
        state, box, cfg = init_sedov(MAIN_SIDE, SphConfig(), dt0=3e-5,
                                     device=DEVICE)
        host = {c: getattr(state.p, c).cpu().numpy() for c in "xyz"}
        grid, sc = plan_slab(host, box, float(state.p.h.max()), D)
        assert sc.n_slabs == D, (sc, D)
        _SHARDED[D] = (state, box, cfg, grid, sc)
    return _SHARDED[D]


def shard_states(state, box, sc, mesh):
    from sphexa_tpu_torch.propagator.ve_sharded import distribute
    from sphexa_tpu_torch.state import _FIELDS
    alive = state.p.alive.cpu().numpy()
    host = {f: getattr(state.p, f).cpu().numpy()[alive]
            for f in _FIELDS[:-1]}
    return [state.replace(p=p) for p in distribute(host, box, sc, mesh)]


def k1z_check(report, grids):
    """(k) K1z against its plain version on the card on `grids` (name ->
    local grid): periodic and open x-y with z open (the sharded engines'
    box), 1 to 15 rows, with and without coordinate rows; bit-equal."""
    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv
    from sphexa_tpu_torch.sfc.box import Box, Boundary

    gen = torch.Generator(device=DEVICE).manual_seed(6)
    out = {}
    for name, grid in grids.items():
        cases = 0
        for b in (Boundary.periodic, Boundary.open):
            box = Box(-0.5, 0.5, -0.5, 0.5, -0.5, 0.5, b, b, Boundary.open)
            for nrows in range(1, 16):
                for rows in ((None, (0, 1, 2)) if nrows >= 3 else (None,)):
                    st = torch.randn((nrows, grid.n_slots), device=DEVICE,
                                     generator=gen)
                    ref = pv.ghost_refresh_xy.plain(st.clone(), grid, box,
                                                    rows)
                    got = pv.ghost_refresh_xy._launch(st.clone(), grid, box,
                                                      rows)
                    if not torch.equal(ref, got):
                        raise AssertionError(
                            f"K1z {name} {b.name} rows {nrows} xyz {rows}: "
                            f"not bit-equal")
                    cases += 1
        out[name] = dict(grid=str(grid), cases=cases)
        log(f"  K1z {name} {grid}: {cases} cases (periodic and open x-y, "
            f"1-15 rows, with and without coordinate rows) bit-equal")
    report["k1z_check"] = out


def sharded_engine_check(report):
    """(k) card against CPU at Sedov 12^3, D = 2 (the tests' grid): the
    sharded resident step for 2 steps at engine_check's bounds, and one
    ShardedBdtVE cycle (2 rungs) with equal rung histograms."""
    from sphexa_tpu_torch.config import SphConfig
    from sphexa_tpu_torch.domain.mesh import SlabMesh
    from sphexa_tpu_torch.domain.slab import SlabConfig
    from sphexa_tpu_torch.init.sedov import init_sedov
    from sphexa_tpu_torch.ops.cellmajor import CMGrid
    from sphexa_tpu_torch.propagator.ve_bdt_sharded import ShardedBdtVE
    from sphexa_tpu_torch.propagator.ve_pallas_sharded import (
        make_ve_step_pallas_sharded)

    D, n = 2, SHARD_SIDE ** 3
    grid = CMGrid(n=4, cap=64, nzi=2)
    res = {}
    for dev in (DEVICE, "cpu"):
        state, box, cfg = init_sedov(SHARD_SIDE, SphConfig(
            cell_cap=256, ngpad=256), dt0=2e-4, device=dev)
        mesh = SlabMesh(D, devices=[dev])
        sc = SlabConfig(n_slabs=D, cap=int(n / D * 2.5) + 64, halo_cap=64,
                        mig_cap=256)
        step = make_ve_step_pallas_sharded(box, grid, cfg, sc, mesh)
        states, ds = shard_states(state, box, sc, mesh), []
        for _ in range(2):
            states, d = step(states)
            ds.append({k: float(v) for k, v in d._asdict().items()})
        eng = ShardedBdtVE(box, grid, cfg, SlabConfig(
            n_slabs=D, cap=(n // D) * 2 + 64, halo_cap=8, mig_cap=256), mesh,
            num_rungs=2)
        _, bd = eng.run_cycle(eng.distribute_bind(state))
        res[dev] = (ds, [{k: np.asarray(v.cpu()).tolist()
                          for k, v in x._asdict().items()} for x in bd])
    (a, ba), (b, bb) = res["cpu"], res[DEVICE]
    for x, y in zip(a, b):
        assert y["lost"] == x["lost"] == 0 and y["overflow"] == 0
        assert y["n_owned"] == x["n_owned"] == n
        np.testing.assert_allclose(y["dt"], x["dt"], rtol=1e-5)
        np.testing.assert_allclose(y["eint"], x["eint"], rtol=1e-6)
        np.testing.assert_allclose(y["ecin"], x["ecin"], rtol=1e-3,
                                   atol=1e-12)
    for x, y in zip(ba, bb):
        assert y["overflow"] == x["overflow"] == 0
        assert y["rung_hist"] == x["rung_hist"], (y, x)
        np.testing.assert_allclose(y["eint"], x["eint"], rtol=1e-6)
    log(f"  {SHARD_SIDE}^3 D={D} {DEVICE} vs cpu: sharded step 2 steps dt "
        f"{b[-1]['dt']:.6e} vs {a[-1]['dt']:.6e}, eint {b[-1]['eint']:.9f} "
        f"vs {a[-1]['eint']:.9f}; ShardedBdtVE cycle rung_hist "
        f"{[x['rung_hist'] for x in bb]} equal")
    report["sharded_engine_12"] = dict(card=b, cpu=a, bdt_card=bb,
                                       bdt_cpu=ba)


def _sample_cells(grid, seed):
    """Interior cells held against plain: the z-edge planes (they read
    the exchanged ghost planes) and random others."""
    from sphexa_tpu_torch.ops import pair_ve as pv
    cells = pv.interior_cells(grid)
    cz = cells % grid.npz
    r = np.random.default_rng(seed)
    half = SHARD_SAMPLE_CELLS // 2
    edge = cells[(cz == 1) | (cz == grid.nz)]
    pick = np.concatenate([r.choice(edge, min(half, len(edge)), False),
                           r.choice(cells, min(half, len(cells)), False)])
    return np.unique(pick)


def sharded_pair_check(grid, pair_calls):
    """Each recorded pair launch of a sharded step (cap 256) against its
    plain version on sampled cells, and the fill values of its invalid
    interior slots (every cell: at cap 256 most cells' second i-tile is
    empty). Returns {stage: max abs err}."""
    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv
    from sphexa_tpu_torch.ops.cellmajor import interior_mask

    errs = {}
    for i, (k, (J, I2, g, c), out) in enumerate(pair_calls):
        cells = torch.tensor(_sample_cells(g, i), device=DEVICE)
        ref = pv._run_plain(k.body, J, I2, g, k.fo, cells=cells,
                            **k._body_kw(c))
        slots = torch.zeros(g.n_slots, dtype=torch.bool, device=DEVICE)
        lane = torch.arange(g.cap, device=DEVICE)
        slots[(cells[:, None] * g.cap + lane).reshape(-1)] = True
        err, _ = compare(k.name, ref, out, valid_slots(J) & slots,
                         per_row=False)
        check_fill(k, J, out, interior_mask(g, J.device))
        errs[k.name] = max(errs.get(k.name, 0.0), err)
    return errs


def sharded_main_path(report, D):
    """(k) Sedov 100^3 on the resident sharded step, D shards on the one
    card: one warm-up step, then SHARD_STEPS timed steps (counters
    zeroed just before, read just after); every pair launch of one more
    step against its plain version on sampled cells; the state after
    SHARD_CHECK_AT steps against make_ve_step_cellmajor on the same
    global grid; times of K1z, the z exchange, migration and the pair
    kernels at the step's inputs. Returns K1z's kernel row."""
    import torch
    from scipy.spatial import cKDTree
    from sphexa_tpu_torch.domain.mesh import SlabMesh
    from sphexa_tpu_torch.domain.slab import migrate
    from sphexa_tpu_torch.ops import pair_ve as pv
    from sphexa_tpu_torch.ops.cellmajor import CMGrid, interior_mask
    from sphexa_tpu_torch.propagator.common import compute_energies
    from sphexa_tpu_torch.propagator.ve_cellmajor import make_ve_step_cellmajor
    from sphexa_tpu_torch.propagator.ve_pallas_sharded import (
        make_ve_step_pallas_sharded, make_zxchg)
    from sphexa_tpu_torch.sfc.box import Boundary

    t0 = time.perf_counter()
    state, box, cfg, grid, sc = sharded_setup(D)
    n = MAIN_SIDE ** 3
    e0 = float(sum(compute_energies(state.p, cfg)))
    mesh = SlabMesh(D, devices=[DEVICE])
    step = make_ve_step_pallas_sharded(box, grid, cfg, sc, mesh)
    states = shard_states(state, box, sc, mesh)
    states, _ = step(states)                                   # warm-up
    torch.cuda.synchronize()
    log(f"  D={D}: plan {grid}, npz {grid.npz}, {sc}; setup + warm-up "
        f"{time.perf_counter() - t0:.1f} s")

    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    ev = [torch.cuda.Event(enable_timing=True)
          for _ in range(SHARD_STEPS + 1)]
    host_ms, diags, snap = [], [], None
    ev[0].record()
    for i in range(SHARD_STEPS):
        h0 = time.perf_counter()
        states, d = step(states)
        ev[i + 1].record()
        host_ms.append((time.perf_counter() - h0) * 1e3)
        diags.append(d)
        if i + 2 == SHARD_CHECK_AT:
            snap = ({f: torch.cat([getattr(s.p, f) for s in states]).cpu()
                     .numpy() for f in ("x", "y", "z", "vx", "alive")},
                    {k: float(v) for k, v in d._asdict().items()})
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    step_ms = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]

    used = {k.name for k in pv.PairVE(grid, cfg).kernels}
    want = {k.name: D * SHARD_STEPS if k.name in used else 0
            for k in kernels}
    want["ghost_refresh_xy"] = len(ZX_ROWS) * D * SHARD_STEPS
    assert launches == want, (launches, want)
    dd = {k: [float(getattr(x, k)) for x in diags] for k in
          ("dt", "etot", "ecin", "eint", "lost", "overflow", "n_owned",
           "h_max", "max_nc")}
    assert max(dd["lost"]) == 0 and max(dd["overflow"]) == 0, dd
    assert min(dd["n_owned"]) == max(dd["n_owned"]) == n, dd["n_owned"]
    for s in states:
        for f in ("x", "y", "z", "h", "vx", "vy", "vz", "temp", "alpha",
                  "du_m1"):
            v = getattr(s.p, f)[s.p.alive]
            assert torch.isfinite(v).all(), f"non-finite {f}"
    drift = abs(dd["etot"][-1] - e0) / e0
    assert drift < 5e-3, f"energy drift {drift:.3e}"
    mean_ms = float(np.mean(step_ms))

    # the same state after SHARD_CHECK_AT steps on one card
    g1 = CMGrid(n=grid.n, cap=grid.cap, nzi=D * grid.nz)
    step1 = make_ve_step_cellmajor(box, g1, cfg, device=DEVICE)
    s1, ev1 = state, [torch.cuda.Event(enable_timing=True)
                      for _ in range(SHARD_CHECK_AT + 1)]
    ev1[0].record()
    for i in range(SHARD_CHECK_AT):
        s1, d1 = step1(s1)
        ev1[i + 1].record()
    torch.cuda.synchronize()
    single_ms = [a.elapsed_time(b) for a, b in zip(ev1, ev1[1:])]
    sf, sd = snap
    np.testing.assert_allclose(sd["dt"], float(d1.dt), rtol=1e-5)
    np.testing.assert_allclose(sd["eint"], float(d1.eint), rtol=1e-6)
    np.testing.assert_allclose(sd["ecin"], float(d1.ecin), rtol=2e-3,
                               atol=1e-9)
    a = {f: getattr(s1.p, f).cpu().numpy() for f in ("x", "y", "z", "vx")}
    al = sf["alive"]
    dist, j = cKDTree(np.c_[a["x"], a["y"], a["z"]]).query(
        np.c_[sf["x"][al], sf["y"][al], sf["z"][al]])
    assert len(j) == n and len(np.unique(j)) == n
    pos_err = float(dist.max())
    vx_err = float(np.abs(sf["vx"][al] - a["vx"][j]).max()
                   / np.abs(a["vx"]).max())
    assert pos_err < 1e-5 and vx_err < 2e-3, (pos_err, vx_err)
    del s1, step1

    # every launch of one more step, recorded; pair launches against plain
    with Spy((pv.ghost_refresh_xy,) + pv.KERNELS[1:]) as spy:
        step(states)
    torch.cuda.synchronize()
    k1z_calls = [c for c in spy.calls if c[0] is pv.ghost_refresh_xy]
    pair_calls = [c for c in spy.calls if c[0] is not pv.ghost_refresh_xy]
    assert len(k1z_calls) == len(ZX_ROWS) * D
    pair_errs = sharded_pair_check(grid, pair_calls)
    lanes = stage_lanes(pair_calls, grid, interior_mask(grid, DEVICE))
    for kname, lc in lanes.items():
        log_lanes(f"{kname} at cap {grid.cap} (shard 0 of D={D})", lc)
    xh_call = next(c for c in pair_calls if c[0].name == "pair_xh")
    xh_J, _, _, xh_cfg = xh_call[1]
    own = (valid_slots(xh_J) & interior_mask(grid, xh_J.device)).double()
    walks = check_walks(f"K3 at cap {grid.cap} (shard 0 of D={D})", xh_call,
                        xh_recounts(xh_J, grid, xh_cfg, own)[2],
                        int(own.sum()))
    pair_ms = {}
    for k, args, _ in pair_calls:
        pair_ms[k.name] = pair_ms.get(k.name, 0.0) + cuda_ms(
            lambda: k._launch(*args), 3)

    # K1z: every launch of the step, beside its plain version, the bound
    # and an index_select of its sources into a ghost-sized buffer
    gm = pv._ghost_maps(grid, dataclasses.replace(box, bz=Boundary.open),
                        False)
    src = torch.tensor(gm["src"], device=DEVICE)
    k1z = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, err=0.0)
    for k, (st, g, b, xyz), out in k1z_calls:
        ref = k.plain(st.clone(), g, b, xyz)
        if not torch.equal(ref, out):
            raise AssertionError(f"K1z: kernel != plain at 100^3 D={D}")
        k1z["err"] = max(k1z["err"], float((ref - out).abs().max()))
        work = st.clone()
        buf = st.new_empty((st.shape[0], src.numel()))
        k1z["ms"] += cuda_ms(lambda: k._launch(work, g, b, xyz), 20)
        k1z["plain_ms"] += cuda_ms(lambda: k.plain(st.clone(), g, b, xyz), 3)
        k1z["library_ms"] += cuda_ms(
            lambda: torch.index_select(st, 1, src, out=buf), 20)
        k1z["bytes"] += 2 * 4 * st.shape[0] * src.numel()
    k1z["split"] = ghost_split([c[:2] for c in k1z_calls], src)

    # the z exchange and migration alone, in one mesh.run of 10 repeats
    zx = make_zxchg(grid, box, mesh)
    stacks = [[torch.zeros((r, grid.n_slots), device=DEVICE)
               for r, _ in ZX_ROWS] for _ in range(D)]

    def exchanges(comm, sts):
        for _ in range(10):
            for st, (_, zrow) in zip(sts, ZX_ROWS):
                zx(comm, st, zrow)

    def migrations(comm, s):
        for _ in range(10):
            migrate(comm, s.p, box, sc)

    def timed(fn, args):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        mesh.run(fn, args)
        torch.cuda.synchronize()
        a.record()
        mesh.run(fn, args)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / 10

    zx_ms, mig_ms = timed(exchanges, stacks), timed(migrations, states)

    log(f"  100^3 D={D}: {mean_ms:.3f} ms/step (CUDA events, mean of "
        f"{SHARD_STEPS}; steps {[round(x, 3) for x in step_ms]}; host "
        f"{[round(x, 1) for x in host_ms]} ms), "
        f"{n / (mean_ms * 1e-3):.4e} particle-updates/s; one card, same "
        f"global grid {g1}: {[round(x, 3) for x in single_ms]} ms/step")
    log(f"  lost 0, overflow 0, n_owned {n}, rows finite, |etot - e0|/e0 = "
        f"{drift:.3e}; after {SHARD_CHECK_AT} steps against one card: dt "
        f"{sd['dt']:.6e} vs {float(d1.dt):.6e}, eint {sd['eint']:.9f} vs "
        f"{float(d1.eint):.9f}, ecin {sd['ecin']:.6e} vs "
        f"{float(d1.ecin):.6e}, max position distance {pos_err:.3e}, vx "
        f"{vx_err:.3e} of scale")
    log(f"  per step, all shards: K1z {k1z['ms']:.3f} ms ({len(k1z_calls)} "
        f"launches; plain {k1z['plain_ms']:.3f}, index_select "
        f"{k1z['library_ms']:.3f}, bound "
        f"{k1z['bytes'] / HBM_BW * 1e3:.4f}), z exchange {zx_ms:.3f} ms, "
        f"migration {mig_ms:.3f} ms, pair kernels "
        f"{sum(pair_ms.values()):.3f} ms "
        f"{dict((k, round(v, 3)) for k, v in pair_ms.items())}")
    log_split(f"K1z D={D} device/dispatch split, sums over the step's "
              f"{len(k1z_calls)} launches", k1z["split"])
    log(f"  K1z D={D} target (no slower than index_select, events): "
        f"{'met' if k1z['ms'] <= k1z['library_ms'] else 'missed'}")
    log(f"  pair launches at cap {grid.cap} against plain on "
        f"{SHARD_SAMPLE_CELLS} sampled cells each: max abs err "
        f"{dict((k, float(f'{v:.3e}')) for k, v in pair_errs.items())}; "
        f"launches {dict((k, v) for k, v in launches.items() if v)}")
    report.setdefault("sharded_main_path", {})[f"D{D}"] = dict(
        grid=str(grid), slab=str(sc), global_grid=str(g1), step_ms=step_ms,
        host_ms=host_ms, mean_step_ms=mean_ms,
        particle_updates_per_s=n / (mean_ms * 1e-3), single_step_ms=single_ms,
        energy_drift=drift, diags=dd, launches=launches, check=dict(
            dt=[sd["dt"], float(d1.dt)], eint=[sd["eint"], float(d1.eint)],
            ecin=[sd["ecin"], float(d1.ecin)], pos_err=pos_err,
            vx_err=vx_err), k1z=k1z, zxchg_ms=zx_ms, migrate_ms=mig_ms,
        pair_ms=pair_ms, pair_errs=pair_errs, k3_walks=walks,
        **{LANE_STAGES[n]: lc for n, lc in lanes.items()})
    del states
    return dict(
        name="ghost_refresh_xy", route="cuda",
        source="sphexa_tpu_torch/csrc/ghost_refresh.cu",
        replaces=K1Z_REPLACES, launches=launches["ghost_refresh_xy"],
        max_abs_err=k1z["err"], ms=k1z["ms"], plain_ms=k1z["plain_ms"],
        bound_ms=k1z["bytes"] / HBM_BW * 1e3, bound_by="bytes",
        library_ms=k1z["library_ms"])


def sharded_bdt_main_path(report, D=2, nr=4):
    """(k) ShardedBdtVE at Sedov 100^3, D shards, nr rungs: one warm-up
    cycle, then one timed cycle (counters zeroed just before, read just
    after); the warm-up cycle's rung histograms beside BdtVE's on the
    same global grid, and the particles whose rung differs."""
    import torch
    from sphexa_tpu_torch.domain.mesh import SlabMesh
    from sphexa_tpu_torch.ops.cellmajor import CMGrid
    from sphexa_tpu_torch.propagator.common import compute_energies
    from sphexa_tpu_torch.propagator.ve_bdt import BdtVE
    from sphexa_tpu_torch.propagator.ve_bdt_sharded import ShardedBdtVE

    state, box, cfg, grid, sc = sharded_setup(D)
    n = MAIN_SIDE ** 3
    e0 = float(sum(compute_energies(state.p, cfg)))
    eng = ShardedBdtVE(box, grid, cfg, sc, SlabMesh(D, devices=[DEVICE]),
                       num_rungs=nr)
    bsts = eng.distribute_bind(state)
    bsts, warm = eng.run_cycle(bsts)
    ck = eng.checkpoint_rungs(bsts, n)["fields"]["bdt_rung"]
    torch.cuda.synchronize()

    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    bsts, ds = eng.run_cycle(bsts)
    b.record()
    torch.cuda.synchronize()
    cycle_ms = a.elapsed_time(b)
    launches = {k.name: k.launches for k in kernels}
    nsub = 1 << (nr - 1)
    used = {k.name for k in eng.shards[0].pve_gated.kernels}
    want = {k.name: D * nsub if k.name in used else 0 for k in kernels}
    # five refreshes a substep, and the resync's 15-row local bind
    want["ghost_refresh_xy"] = D * (5 * nsub + 1)
    want["pair_gate"] = D * 5 * nsub
    assert launches == want, (launches, want)
    etot = float(ds[-1].etot)
    drift = abs(etot - e0) / e0
    assert drift < 5e-3, f"energy drift {drift:.3e}"
    for bst in bsts:
        for f in ("x", "y", "z", "h", "vx", "temp", "alpha"):
            assert torch.isfinite(getattr(bst.rv, f)).all(), f
    sim = sum(float(d.dt) for d in ds)

    eng1 = BdtVE(box, CMGrid(n=grid.n, cap=grid.cap, nzi=D * grid.nz), cfg,
                 num_rungs=nr, device=DEVICE)
    b1, warm1 = eng1.run_cycle(eng1.bind_bdt(state))
    ck1 = eng1.checkpoint_rungs(b1, n)["fields"]["bdt_rung"]
    differ = int((ck != ck1).sum())
    hist = [x.rung_hist.tolist() for x in warm]
    hist1 = [x.rung_hist.tolist() for x in warm1]
    assert differ <= 1e-3 * n, (differ, hist, hist1)
    del eng1, b1

    # the shards' substep takes no host sync: one more, untimed and
    # uncounted, with PyTorch's sync check turned to errors
    b2, _ = eng.resync(bsts)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.substep(b2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"  100^3 ShardedBdtVE D={D}, {nr} rungs: {cycle_ms:.3f} ms/cycle, "
        f"sim-time per wall-second {sim / (cycle_ms * 1e-3):.6e}; overflow "
        f"0, lost 0, |etot - e0|/e0 = {drift:.3e}; the shards' substep ran "
        f"with no host sync")
    log(f"  warm-up cycle rung_hist sharded {hist[0]} vs one card "
        f"{hist1[0]}; particles whose rung differs: {differ}; launches "
        f"{dict((k, v) for k, v in launches.items() if v)}")
    report["sharded_bdt_main_path"] = dict(
        D=D, num_rungs=nr, cycle_ms=cycle_ms, sim_time_per_wall_s=sim / (
            cycle_ms * 1e-3), energy_drift=drift, rung_hist=hist,
        rung_hist_single=hist1, rung_differs=differ, launches=launches)


# ---------------------------------------------------------------------------
# (l): single-device self-gravity, and the Evrard collapse at 100^3
# ---------------------------------------------------------------------------

EVRARD_SIDE = 100         # 523,984 particles, bench.py's Evrard size
# the lowest FMM level at which no leaf of the Evrard 100 sphere holds
# more than leaf_cap (128) particles: level 5's densest leaf holds 388,
# so its P2P would drop pairs (nf_truncated > 0); level 6's holds 103
EVRARD_LEVEL = 6
EVRARD_STEPS = 5          # timed resident steps after one warm-up step
EVRARD_SAMPLE_CELLS = 48  # cells of each cap-768 pair launch held against plain
# the TPU package's tiered Evrard-50 density L1 (an accuracy comparison
# only: another size, engine and device)
TPU_EVRARD50_L1 = 0.0042
EVRARD_L1_BOUND = 0.15    # bench.py's physics gate


def evrard(side, device, solver="fmm", level=None):
    """Evrard state on `device`, gravity_solver `solver` (FMM at `level`,
    default SphConfig's), and the planner's grid
    (choose_cap_and_grid(cap_min=32, cap_max=1024) at 1.2 h_max)."""
    from sphexa_tpu_torch.config import SphConfig
    from sphexa_tpu_torch.init.evrard import init_evrard
    from sphexa_tpu_torch.ops.cellmajor import choose_cap_and_grid

    state, box, cfg = init_evrard(side, SphConfig(), dt0=3e-5, device=device)
    cfg = cfg.replace(gravity_solver=solver,
                      fmm_level=level or cfg.fmm_level)
    p = state.p
    alive = p.alive
    xyz = [getattr(p, c)[alive].cpu().numpy() for c in "xyz"]
    _, grid = choose_cap_and_grid(box, float(p.h[alive].max()) * 1.2,
                                  int(alive.sum()), *xyz, cap_min=32,
                                  cap_max=1024)
    return state, box, cfg, grid


def state_energy(state, box, cfg):
    """ecin + eint + egrav of a particle state (egrav from the FMM at
    cfg's level): the e0 of the energy gate."""
    from sphexa_tpu_torch.gravity.direct import egrav
    from sphexa_tpu_torch.gravity.fmm import FmmConfig, fmm_gravity
    from sphexa_tpu_torch.propagator.common import compute_energies

    p = state.p
    g = fmm_gravity(p.x, p.y, p.z, p.m, p.alive, box, cfg.gravG,
                    FmmConfig(level=cfg.fmm_level, min_sep=cfg.fmm_min_sep),
                    eps=cfg.eps)
    return float(sum(compute_energies(p, cfg))) + float(
        egrav(p.m, g.pot, p.alive))


def rows_close(what, got, want, rtol):
    """Each output row (ax, ay, az, pot, ...) of the card within rtol of
    the CPU row's largest absolute value. Returns the largest error as a
    share of its row's scale."""
    import torch
    worst = 0.0
    for i, (a, b) in enumerate(zip(want, got)):
        a, b = a.double().cpu(), b.double().cpu()
        if not bool(torch.isfinite(b).all()):
            raise AssertionError(f"{what} row {i}: non-finite on the card")
        rel = float((b - a).abs().max() / a.abs().max().clamp_min(1e-30))
        if rel > rtol:
            raise AssertionError(f"{what} row {i}: {rel:.3e} of scale > "
                                 f"{rtol}")
        worst = max(worst, rel)
    return worst


def leaf_counts(x, y, z, box, level):
    """Particles in each FMM leaf at `level` (the P2P's cap applies to
    these counts)."""
    import torch
    from sphexa_tpu_torch.gravity.fmm import FmmConfig, _leaf_binning
    cid = _leaf_binning(FmmConfig(level=level), box, x, y, z, None)
    return torch.bincount(cid.long(), minlength=8 ** level)


def gravity_solver_check(report):
    """(l) 1: each solver on the card against the same solver on the
    CPU, same seeded inputs, the CPU tests' tolerances; cuDNN's TF32
    left on around the FMM (the module turns it off for its
    convolutions)."""
    import torch
    from sphexa_tpu_torch.gravity import direct, ewald, fmm
    from sphexa_tpu_torch.sfc.box import Box, Boundary

    res = {}
    r = np.random.default_rng(7)
    n = 4096
    host = [r.uniform(-1, 1, n).astype(np.float32) for _ in range(3)] + [
        (r.uniform(0.5, 1.5, n) / n).astype(np.float32)]
    alive = np.arange(n) < n - 5

    def on(dev, arrs, live):
        return [torch.from_numpy(a).to(dev) for a in arrs] + [
            torch.from_numpy(live).to(dev)]

    g = {dev: direct.direct_gravity(*on(dev, host, alive), 1.0, 0.01)
         for dev in (DEVICE, "cpu")}
    res["direct_4096"] = rows_close("direct_gravity", g[DEVICE], g["cpu"],
                                    1e-5)
    e = {dev: float(direct.egrav(on(dev, host, alive)[3], g[dev].pot,
                                 on(dev, host, alive)[4]))
         for dev in (DEVICE, "cpu")}
    np.testing.assert_allclose(e[DEVICE], e["cpu"], rtol=1e-5)

    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        st, box, cfg, _ = evrard(30, "cpu")
        p = st.p
        ev = [getattr(p, c)[p.alive].numpy() for c in ("x", "y", "z", "m")]
        fc = fmm.FmmConfig(level=5, min_sep=3)
        ones = np.ones(ev[0].size, bool)
        g = {dev: fmm.fmm_gravity(*on(dev, ev, ones), box, 1.0, fc,
                                  eps=cfg.eps) for dev in (DEVICE, "cpu")}
        res["fmm_evrard30_l5"] = rows_close("fmm_gravity Evrard 30", g[DEVICE][:4],
                                            g["cpu"][:4], 1e-4)
        nf = [int(g[d].nf_truncated) for d in (DEVICE, "cpu")]
        assert nf[0] == nf[1] == 0, nf
        # a seeded Gaussian cluster whose central level-3 leaves
        # overflow leaf_cap
        cl = [np.clip(r.normal(0, 0.15, 20000), -0.99, 0.99).astype(
            np.float32) for _ in range(3)] + [np.full(20000, 5e-5,
                                                      np.float32)]
        fc3 = fmm.FmmConfig(level=3, min_sep=2)
        cbox = Box.cube(-1.0, 1.0, Boundary.open)
        live = np.ones(20000, bool)
        g = {dev: fmm.fmm_gravity(*on(dev, cl, live), cbox, 1.0, fc3,
                                  eps=0.01) for dev in (DEVICE, "cpu")}
        res["fmm_truncating"] = rows_close("fmm_gravity truncating",
                                           g[DEVICE][:4], g["cpu"][:4], 1e-4)
        nf = [int(g[d].nf_truncated) for d in (DEVICE, "cpu")]
        assert nf[0] == nf[1] > 0, nf
        res["nf_truncated_truncating"] = nf[0]
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32

    pb = Box.cube(0.0, 1.0, Boundary.periodic)
    pe = [0.5 * (a[:512] + 1.0) for a in host[:3]] + [host[3][:512]]
    g = {dev: ewald.ewald_gravity(*on(dev, pe, np.ones(512, bool)), pb, 1.0,
                                  eps=0.01) for dev in (DEVICE, "cpu")}
    res["ewald_512"] = rows_close("ewald_gravity", g[DEVICE], g["cpu"], 1e-4)

    from sphexa_tpu_torch.propagator.nbody import make_nbody_step
    diags = {}
    for dev in (DEVICE, "cpu"):
        st, box, cfg, _ = evrard(10, dev)
        step = make_nbody_step(box, cfg, device=dev)
        ds = []
        for _ in range(3):
            st, d = step(st)
            ds.append(d)
        diags[dev] = (st, ds)
    (sc, dc), (sg, dg) = diags["cpu"], diags[DEVICE]
    for a, b in zip(dc, dg):
        for k in ("dt", "etot", "ecin", "egrav"):
            np.testing.assert_allclose(float(getattr(b, k)),
                                       float(getattr(a, k)), rtol=1e-5,
                                       err_msg=f"nbody {k}")
        assert int(a.nf_truncated) == int(b.nf_truncated) == 0
    res["nbody_3_steps"] = rows_close(
        "nbody positions", [getattr(sg.p, c) for c in ("x", "y", "z", "vx")],
        [getattr(sc.p, c) for c in ("x", "y", "z", "vx")], 1e-5)
    log(f"  solvers card vs cpu (largest error as a share of its row's "
        f"scale): direct 4096 {res['direct_4096']:.3e} (egrav rtol 1e-5), "
        f"FMM Evrard 30 level 5 {res['fmm_evrard30_l5']:.3e} (nf 0), FMM "
        f"truncating frame {res['fmm_truncating']:.3e} (nf "
        f"{res['nf_truncated_truncating']} on both), Ewald 512 "
        f"{res['ewald_512']:.3e}, N-body 3 steps {res['nbody_3_steps']:.3e}")
    report["gravity_solvers"] = res


def gravity_engine_check(report):
    """(l) 2: ResidentVE (3 steps) and BdtVE (3 rungs, 2 cycles) on the
    card against the CPU at Evrard 10, under the FMM and the direct
    sum; the CPU tests' bounds (dt, eint, ecin rtol 1e-5, etot 1e-4)."""
    from sphexa_tpu_torch.propagator.ve_bdt import BdtVE
    from sphexa_tpu_torch.propagator.ve_cellmajor import ResidentVE

    keys = ("dt", "etot", "ecin", "eint")
    out = {}
    for solver in ("fmm", "direct"):
        runs = {}
        for dev in (DEVICE, "cpu"):
            state, box, cfg, grid = evrard(10, dev, solver)
            eng = ResidentVE(box, grid, cfg, device=dev)
            rst = eng.bind(state)
            rd = []
            for _ in range(3):
                rst, d = eng.step(rst)
                rd.append({k: float(getattr(d, k)) for k in keys
                           + ("nf_truncated", "overflow")})
            beng = BdtVE(box, grid, cfg, num_rungs=3, device=dev)
            bst = beng.bind_bdt(state)
            bd = []
            for _ in range(2):
                bst, ds = beng.run_cycle(bst)
                bd += [dict({k: float(getattr(d, k)) for k in keys
                             + ("overflow",)},
                            rung_hist=d.rung_hist.cpu().tolist())
                       for d in ds]
            runs[dev] = (rd, bd)
        for which in (0, 1):
            for a, b in zip(runs["cpu"][which], runs[DEVICE][which]):
                assert a["overflow"] == b["overflow"] == 0
                assert a.get("nf_truncated", 0) == b.get("nf_truncated", 0)
                for k in ("dt", "eint", "ecin"):
                    np.testing.assert_allclose(b[k], a[k], rtol=1e-5,
                                               err_msg=f"{solver} {k}")
                np.testing.assert_allclose(b["etot"], a["etot"], rtol=1e-4,
                                           err_msg=f"{solver} etot")
                assert a.get("rung_hist") == b.get("rung_hist"), (a, b)
        (ra, ba), (rb, bb) = runs["cpu"], runs[DEVICE]
        log(f"  Evrard 10 {solver}: ResidentVE 3 steps, last dt "
            f"{rb[-1]['dt']:.6e} vs {ra[-1]['dt']:.6e}, etot "
            f"{rb[-1]['etot']:.7f} vs {ra[-1]['etot']:.7f}; BdtVE 2 cycles, "
            f"rung_hist {bb[-1]['rung_hist']} equal, etot "
            f"{bb[-1]['etot']:.7f} vs {ba[-1]['etot']:.7f}")
        out[solver] = dict(card=runs[DEVICE], cpu=runs["cpu"])
    report["gravity_engine_10"] = out


def sample_occupied_cells(grid, valid, intmask, n_cells, seed):
    """Interior cells held against plain: the densest ones (the i-tiles
    of the full cap) and random occupied others."""
    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv
    cells = torch.tensor(pv.interior_cells(grid), device=valid.device)
    cnt = (valid & intmask).view(-1, grid.cap).sum(1)[cells]
    dense = cells[torch.argsort(cnt, descending=True)[:n_cells // 3]]
    occ = cells[cnt > 0].cpu().numpy()
    r = np.random.default_rng(seed)
    rnd = torch.tensor(r.choice(occ, min(n_cells - dense.numel(), occ.size),
                                False), device=valid.device)
    return torch.unique(torch.cat([dense, rnd]))


def fmm_phase_ms(x, y, z, m, box, fc, eps, reps=3):
    """The FMM's phases one by one on the card (events around `reps`
    calls each): P2M + M2M, M2L (all levels), L2L + L2P, P2P; and the
    whole fmm_gravity. The phases' sum is held against fmm_gravity's
    output."""
    import torch
    from sphexa_tpu_torch.gravity import fmm

    n = 1 << fc.level
    alive = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    cid = fmm._leaf_binning(fc, box, x, y, z, alive)
    co = fmm._box_centered(box, x, y, z)

    def p2m_m2m():
        c = fmm._leaf_binning(fc, box, x, y, z, alive)
        return fmm._m2m(fmm._raw_leaf_moments(fmm._box_centered(
            box, x, y, z), m, c, n), fc)

    raw = p2m_m2m()
    levels = range(2, fc.level + 1)

    def m2l():
        return [fmm._m2l(raw[lv], box, fc, lv) for lv in levels]

    contrib = m2l()

    def l2l_l2p():
        local = None
        for i, lv in enumerate(levels):
            local = contrib[i] if local is None else local + contrib[i]
            if lv < fc.level:
                local = fmm._l2l(local, box, lv)
        return fmm._l2p(local, co, cid, box, fc)

    def p2p():
        return fmm._p2p(x, y, z, m, cid, n, fc.leaf_cap, eps,
                        reach=fc.min_sep - 1)

    far, near = l2l_l2p(), p2p()
    whole = fmm.fmm_gravity(x, y, z, m, alive, box, 1.0, fc, eps=eps)
    for i, (a, b) in enumerate(zip(whole[:4], (far[1] + near[0],
                                               far[2] + near[1],
                                               far[3] + near[2],
                                               far[0] + near[3]))):
        rel = float((a - b).abs().max() / a.abs().max())
        assert rel < 1e-4, f"FMM phases row {i}: {rel:.3e}"
    ms = {k: cuda_ms(f, reps) for k, f in (
        ("p2m_m2m", p2m_m2m), ("m2l", m2l), ("l2l_l2p", l2l_l2p),
        ("p2p", p2p), ("fmm_gravity", lambda: fmm.fmm_gravity(
            x, y, z, m, alive, box, 1.0, fc, eps=eps)))}
    # the work as the solver does it: M2L's convolutions count every tap
    # of the S^3 kernel (masked taps included), 8 parities of (s/2)^3
    # outputs a level, 2 flops a multiply-add; P2P gathers
    # (2 min_sep - 1)^3 cells x leaf_cap lanes for every row
    S = 4 * fc.min_sep - 1
    work = dict(
        m2l_flops=float(sum(8 * (1 << (lv - 1)) ** 3 * fmm.NCH_L * fmm.NCH_M
                            * S ** 3 * 2 for lv in levels)),
        p2p_candidates=float(x.numel() * (2 * fc.min_sep - 1) ** 3
                             * fc.leaf_cap))
    return ms, work, int(whole.nf_truncated)


def evrard_main_path(report):
    """(l) 3: Evrard 100 on ResidentVE with FMM gravity at level 6, one
    warm-up step, then EVRARD_STEPS timed steps (counters zeroed just
    before, read just after); the gates; each step split into the hydro
    pipeline, P2M + M2M, M2L, L2L + L2P, P2P and the rest."""
    import torch
    from sphexa_tpu_torch.gravity.fmm import FmmConfig
    from sphexa_tpu_torch.propagator.ve_cellmajor import (ResidentVE,
                                                          _add_gravity,
                                                          _run_pipeline)

    side, steps = EVRARD_SIDE, EVRARD_STEPS
    t0 = time.perf_counter()
    state, box, cfg, grid = evrard(side, DEVICE, "fmm", EVRARD_LEVEL)
    p = state.p
    n = int(p.alive.sum())
    occ = {lv: int(leaf_counts(p.x[p.alive], p.y[p.alive], p.z[p.alive],
                               box, lv).max()) for lv in (5, 6)}
    e0 = state_energy(state, box, cfg)
    eng = ResidentVE(box, grid, cfg, device=DEVICE)
    rst = eng.bind(state)
    assert int(rst.overflow) == 0, "slot overflow at bind"
    rst, _ = eng.step(rst)                      # warm-up
    torch.cuda.synchronize()
    n_rows = int(eng.gravity_index(rst.valid).numel())
    log(f"  setup + warm-up {time.perf_counter() - t0:.1f} s; {n} "
        f"particles; plan cap {grid.cap}, grid {grid}, n_slots "
        f"{grid.n_slots}; FMM level {cfg.fmm_level}, min_sep "
        f"{cfg.fmm_min_sep}, leaf_cap 128: densest leaf {occ}; gravity "
        f"on {n_rows} compacted rows")

    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    diags = []
    ev[0].record()
    for i in range(steps):
        rst, d = eng.step(rst)
        ev[i + 1].record()
        diags.append(d)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
    d = {k: [float(getattr(x, k)) for x in diags] for k in
         ("dt", "etot", "ecin", "eint", "overflow", "nf_truncated",
          "h_nonconv", "rebinned", "h_max", "nc_mean")}
    assert max(d["overflow"]) == 0, "slot overflow"
    assert max(d["nf_truncated"]) == 0, \
        f"FMM near-field truncation {d['nf_truncated']}"
    for f in ("x", "y", "z", "h", "vx", "vy", "vz", "temp", "alpha",
              "du_m1"):
        assert torch.isfinite(getattr(rst, f)).all(), f"non-finite {f}"
    drift = abs(d["etot"][-1] - e0) / abs(e0)
    assert drift < 5e-3, f"energy drift {drift:.3e}"
    used = {k.name for k in eng.pve.kernels}
    want = {k.name: steps if k.name in used else 0 for k in kernels}
    want["ghost_refresh"] = 5 * steps
    assert launches == want, (launches, want)
    mean_ms = float(np.mean(step_ms))

    # the split, on the state after the timed steps
    validint = rst.valid & eng.intmask
    base = [rst.x, rst.y, rst.z, rst.h, rst.gid]

    def hydro():
        return _run_pipeline(eng.pve, eng.rf, base, rst.m, rst.vx, rst.vy,
                             rst.vz, rst.temp, rst.alpha, rst.dt, validint)

    out = hydro()
    idx = eng.gravity_index(rst.valid)
    hydro_ms = cuda_ms(hydro, 2)
    grav_ms = cuda_ms(lambda: _add_gravity(out, rst.x, rst.y, rst.z, rst.m,
                                           idx, box, cfg), 2)
    fc = FmmConfig(level=cfg.fmm_level, min_sep=cfg.fmm_min_sep)
    phases, work, nf = fmm_phase_ms(rst.x[idx], rst.y[idx], rst.z[idx],
                                    rst.m[idx], box, fc, cfg.eps)
    rest = mean_ms - hydro_ms - grav_ms
    shares = {k: v / mean_ms for k, v in (
        ("hydro_pipeline", hydro_ms), ("p2m_m2m", phases["p2m_m2m"]),
        ("m2l", phases["m2l"]), ("l2l_l2p", phases["l2l_l2p"]),
        ("p2p", phases["p2p"]), ("rest", rest))}
    split = dict(shares=shares, hydro_pipeline=hydro_ms, gravity=grav_ms,
                 p2m_m2m=phases["p2m_m2m"], m2l=phases["m2l"],
                 l2l_l2p=phases["l2l_l2p"], p2p=phases["p2p"],
                 fmm_gravity=phases["fmm_gravity"], rest=rest)

    # bench.py's physics gate: rho against the analytic 1/(2 pi r)
    rho = out["rho"][validint].double()
    r = torch.sqrt(rst.x[validint].double() ** 2
                   + rst.y[validint].double() ** 2
                   + rst.z[validint].double() ** 2)
    sel = (r > 0.05) & (r < 0.9)
    ana = 1.0 / (2.0 * np.pi * r[sel].clamp_min(1e-6))
    l1 = float(((rho[sel] - ana).abs() / ana).mean())
    assert l1 < EVRARD_L1_BOUND, f"Evrard density L1 {l1:.4f}"

    sim_per_wall = sum(d["dt"]) / (sum(step_ms) * 1e-3)
    log(f"  Evrard {side}: {mean_ms:.3f} ms/step (CUDA events, mean of "
        f"{steps}; steps {[round(s, 3) for s in step_ms]}), "
        f"{n / (mean_ms * 1e-3):.4e} particle-updates/s, sim-time per "
        f"wall-second {sim_per_wall:.6e}")
    log(f"  split (ms, each part timed alone on the last state): hydro "
        f"pipeline {hydro_ms:.3f}, gravity {grav_ms:.3f} (FMM phases: P2M "
        f"+ M2M {phases['p2m_m2m']:.3f}, M2L {phases['m2l']:.3f}, L2L + "
        f"L2P {phases['l2l_l2p']:.3f}, P2P {phases['p2p']:.3f}; "
        f"fmm_gravity alone {phases['fmm_gravity']:.3f}), rest "
        f"{rest:.3f}; M2L {work['m2l_flops']:.4e} float32 flops "
        f"({work['m2l_flops'] / (phases['m2l'] * 1e9):.3f} TFLOP/s), P2P "
        f"{work['p2p_candidates']:.4e} gathered candidates")
    log(f"  shares of the mean step: "
        f"{dict((k, round(v, 4)) for k, v in shares.items())}")
    log(f"  |etot - e0|/|e0| = {drift:.3e} (e0 {e0:.7f}); overflow 0; "
        f"nf_truncated {d['nf_truncated']}; rows finite; density L1 vs "
        f"1/(2 pi r) on 0.05 < r < 0.9: {l1:.4f} (bound "
        f"{EVRARD_L1_BOUND}; the TPU package's tiered Evrard 50: "
        f"{TPU_EVRARD50_L1}, another size and engine)")
    log(f"  launches {dict((k, v) for k, v in launches.items() if v)}, "
        f"every other kernel 0; dt {d['dt']}")
    report["evrard_main_path"] = dict(
        side=side, n=n, cap=grid.cap, grid=str(grid), n_slots=grid.n_slots,
        fmm_level=cfg.fmm_level, densest_leaf=occ, gravity_rows=n_rows,
        steps=steps, step_ms=step_ms, mean_step_ms=mean_ms,
        particle_updates_per_s=n / (mean_ms * 1e-3),
        sim_time_per_wall_s=sim_per_wall, e0=e0, energy_drift=drift,
        density_l1=l1, split=split, fmm_work=work, nf_truncated_phases=nf,
        diags=d,
        launches=launches)
    return eng, rst, grid, launches


def evrard_pair_check(report, eng, rst, grid):
    """(l) 5: K3-K7 at cap 768, at the inputs of one more Evrard 100
    step: each against its plain version on sampled cells (the densest
    and random occupied ones), its invalid interior slots at their fill
    values, each timed; K1 on the open box bit-equal to its plain
    version."""
    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv

    with Spy(pv.KERNELS) as spy:
        eng.step(rst)
    torch.cuda.synchronize()
    res = {}
    # the bounds as timing() computes them, from this step's pair counts
    # (K3's recounts left out: its plain version at cap 768 is too slow
    # to run h_iter times here, so its bound is a floor)
    xh_J, _, _, _ = next(a for k, a, _ in spy.calls if k.name == "pair_xh")
    nc_sph = next(o for k, _, o in spy.calls if k.name == "pair_xh")[2] + 1
    cand, inside, _ = pair_counts(xh_J, eng, grid, nc_sph)
    res["pairs"] = dict(candidates=cand, in_support=inside)
    log(f"  cap {grid.cap} pairs: {cand:.4e} valid candidates, "
        f"{inside:.4e} in support")
    for i, (k, args, out) in enumerate(spy.calls):
        if k.name == "ghost_refresh":
            st, g, b, xyz = args
            if not torch.equal(k.plain(st.clone(), g, b, xyz), out):
                raise AssertionError("ghost_refresh at cap 768: not "
                                     "bit-equal")
            continue
        J, I2, g, c = args
        cells = sample_occupied_cells(g, valid_slots(J), eng.intmask,
                                      EVRARD_SAMPLE_CELLS, i)
        ref = pv._run_plain(k.body, J, I2, g, k.fo, cells=cells,
                            **k._body_kw(c))
        slots = torch.zeros(g.n_slots, dtype=torch.bool, device=DEVICE)
        lane = torch.arange(g.cap, device=DEVICE)
        slots[(cells[:, None] * g.cap + lane).reshape(-1)] = True
        err, rel = compare(k.name, ref, out, valid_slots(J) & slots
                           & eng.intmask, per_row=False)
        nfill = check_fill(k, J, out, eng.intmask)
        ms = cuda_ms(lambda: k._launch(J, I2, g, c), 3)
        nbytes = 4 * (J.numel() + (I2.numel() if I2 is not None else 0)
                      + out.numel())
        bound, by = pair_bound(cand * GEO_FLOPS
                               + inside * BODY_FLOPS[k.name], nbytes)
        res[k.name] = dict(max_abs_err=err, max_rel_err=rel, ms=ms,
                           bound_ms=bound, bound_by=by,
                           fill_slots=nfill, cells=int(cells.numel()))
        log(f"  cap {g.cap} {k.name:14s} {ms:9.3f} ms  bound {bound:.4f} ms "
            f"({by}); {cells.numel()} cells against plain: err {err:.3e} "
            f"(rel {rel:.3e}); {nfill} invalid interior slots at their fill "
            f"value")
    n_ghost = sum(1 for k, _, _ in spy.calls if k.name == "ghost_refresh")
    log(f"  ghost_refresh on the open box: {n_ghost} refreshes bit-equal "
        f"to plain")
    report["evrard_cap768"] = res


def evrard_bdt_path(report, grid):
    """(l) 4: BdtVE at Evrard 100, 4 rungs, one warm-up cycle, then one
    timed cycle of 8 substeps (counters zeroed just before, read just
    after); gravity every substep. Rung histogram, ms a cycle, gravity's
    ms a substep (timed alone on the last state)."""
    import torch
    from sphexa_tpu_torch.propagator.ve_bdt import BdtVE
    from sphexa_tpu_torch.propagator.ve_cellmajor import _add_gravity

    nr = 4
    t0 = time.perf_counter()
    state, box, cfg, _ = evrard(EVRARD_SIDE, DEVICE, "fmm", EVRARD_LEVEL)
    e0 = state_energy(state, box, cfg)
    eng = BdtVE(box, grid, cfg, num_rungs=nr, device=DEVICE)
    bst = eng.bind_bdt(state)
    assert int(bst.rv.overflow) == 0, "slot overflow at bind"
    bst, _ = eng.run_cycle(bst)                        # warm-up
    torch.cuda.synchronize()
    log(f"  setup + warm-up cycle {time.perf_counter() - t0:.1f} s; Z "
        f"{eng.pve_gated.zgroup}")
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    bst, diags = eng.run_cycle(bst)
    b.record()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    nsub = 1 << (nr - 1)
    used = {k.name for k in eng.pve_gated.kernels}
    want = {k.name: nsub if k.name in used else 0 for k in kernels}
    want["ghost_refresh"] = 5 * nsub
    want["pair_gate"] = 5 * nsub
    assert launches == want, (launches, want)
    cycle_ms = a.elapsed_time(b)
    d = {k: [np.asarray(getattr(x, k).cpu()).tolist() for x in diags]
         for k in ("dt", "etot", "active_frac", "active_cell_frac",
                   "rung_hist", "overflow")}
    assert max(d["overflow"]) == 0, "slot overflow or FMM truncation"
    for f in ("x", "y", "z", "h", "vx", "vy", "vz", "temp", "alpha"):
        assert torch.isfinite(getattr(bst.rv, f)).all(), f"non-finite {f}"
    drift = abs(d["etot"][-1] - e0) / abs(e0)
    assert drift < 5e-3, f"energy drift {drift:.3e}"
    # the substep, gravity included, takes no host sync: one more,
    # untimed and uncounted, with PyTorch's sync check turned to errors
    # (the resync builds the gravity index)
    b2, _ = eng.resync(bst)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.substep(b2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    rv = bst.rv
    z = torch.zeros_like(rv.x)
    idx = eng.gravity_index(rv.valid)
    grav_ms = cuda_ms(lambda: _add_gravity(
        dict(ax=z, ay=z, az=z), rv.x, rv.y, rv.z, rv.m, idx, box, cfg), 2)
    log(f"  Evrard {EVRARD_SIDE} BdtVE, {nr} rungs: {cycle_ms:.3f} ms/cycle, "
        f"{cycle_ms / nsub:.3f} ms/substep, gravity {grav_ms:.3f} ms a "
        f"substep (alone); rung_hist {d['rung_hist'][-1]}; active_frac "
        f"{[round(x, 4) for x in d['active_frac']]}; |etot - e0|/|e0| = "
        f"{drift:.3e}; overflow and nf_truncated 0; a substep ran with no "
        f"host sync")
    report["evrard_bdt"] = dict(num_rungs=nr, cycle_ms=cycle_ms,
                                substep_ms=cycle_ms / nsub,
                                gravity_ms=grav_ms, e0=e0,
                                energy_drift=drift, diags=d,
                                launches=launches)


def gravity_phase(report):
    """Phase (l): the solvers and the engines card against CPU, the
    Evrard 100 main path, K3-K7 at cap 768, BdtVE at Evrard 100."""
    t0 = time.perf_counter()
    log("(l) gravity solvers on the card against the CPU:")
    gravity_solver_check(report)
    log("(l) engines with gravity on the card against the CPU, Evrard 10:")
    gravity_engine_check(report)
    log(f"(l) Evrard {EVRARD_SIDE} on ResidentVE, FMM level {EVRARD_LEVEL}:")
    eng, rst, grid, _ = evrard_main_path(report)
    log(f"(l) K3-K7 and K1 at the Evrard {EVRARD_SIDE} inputs:")
    evrard_pair_check(report, eng, rst, grid)
    del eng, rst
    log(f"(l) Evrard {EVRARD_SIDE} on BdtVE:")
    evrard_bdt_path(report, grid)
    report["gravity_phase_seconds"] = time.perf_counter() - t0
    log(f"  phase (l): {report['gravity_phase_seconds']:.1f} s")


# ---------------------------------------------------------------------------
# (m) the command line
# ---------------------------------------------------------------------------

CLI_SIDE = 100                  # main([...]) at Sedov 100^3
CLI_DT0 = "3e-5"
CLI_RUNS = (("ve", 2), ("ve-pallas", 5), ("ve-bdt", 1))   # steps (cycles)
CLI_DRIFT_BOUND = 5e-3
GATHER_CAP = 128                # holds the 125-row cells of Sedov 10^3
                                # (and Evrard 10's 69) at grid level 1


def gather_check(report):
    """(m) 1: make_ve_step on the card against the CPU: Sedov 10^3 for 3
    steps and Evrard 10 with the FMM for 2 steps. The first step's cell
    permutation and neighbour counts equal; every row of the states
    after the last step within 1e-5 of its scale (phase (c)'s bound)."""
    import torch
    from sphexa_tpu_torch.config import SphConfig
    from sphexa_tpu_torch.init.evrard import init_evrard
    from sphexa_tpu_torch.init.sedov import init_sedov
    from sphexa_tpu_torch.neighbors import (CellGrid, build_cell_list,
                                            build_neighbor_list,
                                            choose_level)
    from sphexa_tpu_torch.propagator.ve import make_ve_step
    from sphexa_tpu_torch.state import _FIELDS

    keys = ("dt", "etot", "ecin", "eint", "egrav", "max_nc",
            "max_cell_count", "nf_truncated")
    out = {}
    # the CPU reference on one intra-op thread: several have been seen
    # to compute a 32768-element chunk of an op's first use from stale
    # data (tests/test_torch_gather.py's one_torch_thread)
    threads = torch.get_num_threads()
    for case, steps in (("sedov 10", 3), ("evrard 10 fmm", 2)):
        runs = {}
        for dev in (DEVICE, "cpu"):
            torch.set_num_threads(1 if dev == "cpu" else threads)
            if case.startswith("sedov"):
                state, box, cfg = init_sedov(10, SphConfig(), dt0=1e-4,
                                             device=dev)
            else:
                state, box, cfg = init_evrard(10, SphConfig(), device=dev)
                cfg = cfg.replace(gravity_solver="fmm")
            cfg = cfg.replace(cell_cap=GATHER_CAP)
            p = state.p
            grid = CellGrid(choose_level(box, float(p.h[p.alive].max())
                                         * 1.25))
            cl = build_cell_list(grid, box, p.x, p.y, p.z, alive=p.alive)
            ps = p.permute(cl.perm)
            nl = build_neighbor_list(grid, box, cl, ps.x, ps.y, ps.z, ps.h,
                                     cfg, alive=ps.alive)
            step = make_ve_step(box, grid, cfg, device=dev)
            diags = []
            for _ in range(steps):
                state, d = step(state)
                diags.append({k: float(getattr(d, k)) for k in keys})
            runs[dev] = dict(perm=cl.perm.cpu(), nc=nl.nc.cpu(),
                             idx=nl.idx.cpu(), state=state, diags=diags)
        torch.set_num_threads(threads)
        a, b = runs["cpu"], runs[DEVICE]
        assert torch.equal(a["perm"], b["perm"]), f"{case}: permutation"
        assert torch.equal(a["nc"], b["nc"]), f"{case}: neighbour counts"
        for da, db in zip(a["diags"], b["diags"]):
            assert da["max_cell_count"] <= GATHER_CAP
            for k in ("max_nc", "max_cell_count", "nf_truncated"):
                assert da[k] == db[k], (case, k, da[k], db[k])
        sa, sb = a["state"], b["state"]
        assert torch.equal(sa.p.alive, sb.p.alive.cpu())
        err = rows_close(f"gather {case}",
                         [getattr(sb.p, f) for f in _FIELDS[:-1]],
                         [getattr(sa.p, f) for f in _FIELDS[:-1]], 1e-5)
        idx_equal = torch.equal(a["idx"], b["idx"])
        log(f"  {case}: {steps} steps, level {grid.level}; first step's "
            f"permutation and neighbour counts equal (lists "
            f"{'equal' if idx_equal else 'differ'}); rows within "
            f"{err:.3e} of scale; last dt {b['diags'][-1]['dt']:.6e} vs "
            f"{a['diags'][-1]['dt']:.6e}, etot "
            f"{b['diags'][-1]['etot']:.8f} vs {a['diags'][-1]['etot']:.8f}")
        out[case] = dict(level=grid.level, worst_row_err=err,
                         idx_equal=idx_equal, card=b["diags"],
                         cpu=a["diags"])
    report["cli_gather_check"] = out


def once_ms(fn) -> float:
    """One call between CUDA events (the caller has warmed it up)."""
    import torch
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def stage_chunks(parts, K, cfg_chunk):
    """(m) 2: the five gather stages (gather_split's parts), ms and peak
    bytes above what was allocated before them, in run_pair_stage's
    chunks of CHUNK_ELEMS // K rows and in chunks of SphConfig.chunk
    rows (CHUNK_ELEMS set to cfg_chunk * K for that call)."""
    import torch
    from sphexa_tpu_torch.ops import pair

    stages = ("xmass", "gradh", "iad_divv", "av_switches", "momentum")
    default = pair.CHUNK_ELEMS
    out = {}
    for name, elems in (("CHUNK_ELEMS", default),
                        ("cfg.chunk", cfg_chunk * K)):
        pair.CHUNK_ELEMS = elems
        try:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ms = sum(once_ms(parts[k]) for k in stages)
            peak = torch.cuda.max_memory_allocated() - base
        finally:
            pair.CHUNK_ELEMS = default
        out[name] = dict(rows=elems // K, ms=ms, peak_bytes=peak)
    return out


def gather_split(box, cfg, grid, state):
    """(m) 2: one gather step at the run's last state, each part timed
    alone (CUDA events, one call each after the call that built its
    inputs): the cell list, the neighbour list (with the permutation),
    the five stages, EOS and the whole step; rest = step - parts; the
    five stages under both chunk rules (stage_chunks). Device
    activities (kernels, copies) and their busy time in one step from
    torch.profiler (None where it saw none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sphexa_tpu_torch.neighbors import (build_cell_list,
                                            build_neighbor_list)
    from sphexa_tpu_torch.propagator.ve import make_ve_step
    from sphexa_tpu_torch.sph import hydro_ve as hv
    from sphexa_tpu_torch.sph.eos import eos_ve

    p = state.p
    cl = build_cell_list(grid, box, p.x, p.y, p.z, alive=p.alive)

    def neighbours():
        ps = p.permute(cl.perm)
        return ps, build_neighbor_list(grid, box, cl, ps.x, ps.y, ps.z,
                                       ps.h, cfg, alive=ps.alive)

    ps, nl = neighbours()
    ps = ps.replace(h=nl.h)
    pos = (box, ps.x, ps.y, ps.z)
    vel = (ps.vx, ps.vy, ps.vz)
    ix = (nl.idx, nl.nc, cfg)
    xm = hv.compute_xmass(*pos, ps.h, ps.m, *ix)
    kx, gradh = hv.compute_ve_def_gradh(*pos, ps.h, ps.m, xm, *ix)
    rho, _, c, prho = eos_ve(ps.temp, ps.m, kx, xm, gradh, cfg.mui,
                             cfg.gamma)
    iad = hv.compute_iad_divv_curlv(*pos, *vel, ps.h, kx, xm, *ix)
    cij = tuple(iad[:6])
    alpha = hv.compute_av_switches(*pos, *vel, ps.h, c, kx, xm, iad.divv,
                                   cij, ps.alpha, state.dt, *ix)
    step = make_ve_step(box, grid, cfg, device=DEVICE)
    parts = {
        "cell_list": lambda: build_cell_list(grid, box, p.x, p.y, p.z,
                                             alive=p.alive),
        "neighbor_list": neighbours,
        "xmass": lambda: hv.compute_xmass(*pos, ps.h, ps.m, *ix),
        "gradh": lambda: hv.compute_ve_def_gradh(*pos, ps.h, ps.m, xm, *ix),
        "eos": lambda: eos_ve(ps.temp, ps.m, kx, xm, gradh, cfg.mui,
                              cfg.gamma),
        "iad_divv": lambda: hv.compute_iad_divv_curlv(*pos, *vel, ps.h, kx,
                                                      xm, *ix),
        "av_switches": lambda: hv.compute_av_switches(
            *pos, *vel, ps.h, c, kx, xm, iad.divv, cij, ps.alpha, state.dt,
            *ix),
        "momentum": lambda: hv.compute_momentum_energy(
            *pos, *vel, ps.h, ps.m, prho, c, cij, kx, xm, alpha, *ix),
    }
    split = {k: once_ms(fn) for k, fn in parts.items()}
    step_ms = once_ms(lambda: step(state))
    split["rest"] = step_ms - sum(split.values())
    chunks = stage_chunks(parts, cfg.ngpad, cfg.chunk)
    del xm, kx, gradh, rho, c, prho, iad, alpha
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(state)
        torch.cuda.synchronize()
    # the profiler's raw events: prof.events() builds a Python object for
    # each of the step's ~6e5 activities, which takes minutes
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    busy = sum(e.duration_ns() for e in dev) * 1e-6
    return dict(step_ms=step_ms, split_ms=split, stage_chunks=chunks,
                launches=len(dev) or None,
                device_busy_ms=busy if dev else None,
                idx_bytes=nl.idx.numel() * nl.idx.element_size(),
                ngpad=cfg.ngpad, cell_cap=cfg.cell_cap, level=grid.level)


# the main loop's fail-stop lines, one a retried call
FAIL_STOPS = ("# re-gridded with larger caps", "# slot overflow",
              "# tier fold")


def main_in_process(argv, consts, cfg_override=None, energy=None):
    """main(argv + --constants consts) in this process. Each call of the
    step function between CUDA events (a fail-stopped call is retried
    and precedes the first accepted step), the steppers made (box, cfg,
    grid) and their step functions, each call's diagnostics, e0 (the
    initial state's etot: energy(state, box, cfg) when given, else
    ecin + eint), the kernels' launch counts (zeroed just before), peak
    memory, wall time and the printed lines. cfg_override: SphConfig
    fields set on every stepper main makes (the CLI has no flag for the
    gravity solver, as the JAX CLI). Gates: one call a step and a retry
    a fail-stop, every row of the final state finite. A raise from main
    carries `partial`: what ran before it (the lines, the steppers made
    and their step functions, the (box, h_max) of every stepper asked
    for, the stepper each call
    used, the last call's state, the diagnostics, e0 and the launch
    counts)."""
    import contextlib
    import io

    import torch
    from sphexa_tpu_torch import main as cli
    from sphexa_tpu_torch.observables import conserved_quantities
    from sphexa_tpu_torch.state import _FIELDS

    if os.path.exists(consts):
        os.remove(consts)
    calls, made, e0, fns, diags, make_s = [], [], [], [], [], []
    tried, used, last = [], [], []
    make_stepper = cli.make_stepper

    def timed_stepper(args, box, cfg, h_max, *a, **kw):
        if cfg_override:
            cfg = cfg.replace(**cfg_override)
        tried.append((box, float(h_max)))
        t0 = time.perf_counter()
        fn, grid = make_stepper(args, box, cfg, h_max, *a, **kw)
        make_s.append(time.perf_counter() - t0)
        made.append((box, cfg, grid))
        fns.append(fn)
        which = len(made) - 1

        def step(state):
            if not e0:
                e0.append(float(conserved_quantities(state.p, cfg).etot)
                          if energy is None else energy(state, box, cfg))
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(state)
            ev[1].record()
            calls.append(ev)
            diags.append(out[1])
            used.append(which)
            last[:] = [out[0]]
            return out
        return step, grid

    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    cli.make_stepper = timed_stepper
    try:
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
            state = cli.main(list(argv) + ["--constants", consts])
    except Exception as e:
        # what ran before the raise, for a caller that expects it
        torch.cuda.synchronize()
        e.partial = dict(lines=buf.getvalue().splitlines(), made=made,
                         make_s=make_s, tried=tried, used=used, fns=fns,
                         state=last[0] if last else None,
                         call_ms=[a.elapsed_time(b) for a, b in calls],
                         diags=diags, e0=e0,
                         launches={k.name: k.launches for k in kernels
                                   if k.launches})
        for ln in e.partial["lines"]:
            log(f"    {ln}")
        raise
    finally:
        cli.make_stepper = make_stepper
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k.name: k.launches for k in kernels if k.launches}
    lines = buf.getvalue().splitlines()
    for ln in lines:
        log(f"    {ln}")
    steps = int(argv[argv.index("-s") + 1])
    fails = [i for i, ln in enumerate(lines) if ln.startswith(FAIL_STOPS)]
    assert len(calls) == steps + len(fails), (len(calls), steps, fails)
    for f in _FIELDS[:-1]:
        assert torch.isfinite(getattr(state.p, f)).all(), f"{argv}: {f}"
    call_ms = [a.elapsed_time(b) for a, b in calls]
    # each call ends in a `### Check` line or a fail-stop line, in order
    accepted = [ln.startswith("### Check") for ln in lines
                if ln.startswith(("### Check",) + FAIL_STOPS)]
    assert len(accepted) == len(calls), (accepted, len(calls))
    return dict(state=state, made=made, make_s=make_s, fns=fns, tried=tried,
                used=used, diags=[d for d, ok in zip(diags, accepted) if ok],
                e0=e0[0], launches=launches,
                lines=lines, fails=fails, call_ms=call_ms,
                step_ms=[t for t, ok in zip(call_ms, accepted) if ok],
                wall=wall, peak=peak, rows=np.loadtxt(consts, ndmin=2))


# the kernels each slot-frame prop launches (the gather-path props none)
PROP_KERNELS = {
    "ve-pallas": {"ghost_refresh", "pair_xh", "pair_gradh", "pair_iad",
                  "pair_av", "pair_momentum"},
    "ve-bdt": {"ghost_refresh", "pair_gate", "pair_xh_gated",
               "pair_gradh_gated", "pair_iad_gated", "pair_av_gated",
               "pair_momentum_gated"}}
PROP_KERNELS["turbulence-ve-bdt"] = PROP_KERNELS["ve-bdt"]


def cli_run(report, prop, steps):
    """(m) 2: main([...]) at Sedov 100^3, --dt0 3e-5 (main_in_process),
    with |etot - e0|/e0 from the constants file the run wrote."""
    consts = os.path.join(ROOT, "chiprun_out", f"cli_{prop}_constants.txt")
    argv = ["--init", "sedov", "-n", str(CLI_SIDE), "-s", str(steps),
            "--dt0", CLI_DT0, "--prop", prop]
    r = main_in_process(argv, consts)
    state, launches, step_ms = r["state"], r["launches"], r["step_ms"]
    checks = [i for i, ln in enumerate(r["lines"])
              if ln.startswith("### Check")]
    assert not r["fails"] or max(r["fails"]) < checks[0], \
        f"{prop}: a fail-stop after the first accepted step"
    etot = r["rows"][:, 3]
    assert len(etot) == steps
    drift = abs(float(etot[-1]) - r["e0"]) / r["e0"]
    assert drift < CLI_DRIFT_BOUND, f"{prop}: energy drift {drift:.3e}"
    assert set(launches) == PROP_KERNELS.get(prop, set()), (prop, launches)
    box, cfg, grid = r["made"][-1]
    per = "cycle" if prop == "ve-bdt" else "step"
    res = dict(steps=steps, call_ms=r["call_ms"], step_ms=step_ms,
               mean_ms=float(np.mean(step_ms)), fail_stops=len(r["fails"]),
               fail_stop_lines=[r["lines"][i] for i in r["fails"]],
               wall_s=r["wall"], peak_bytes=r["peak"], energy_drift=drift,
               e0=r["e0"], etot=etot.tolist(), launches=launches,
               grid=str(grid), ngpad=cfg.ngpad, cell_cap=cfg.cell_cap)
    log(f"  --prop {prop}: {res['mean_ms']:.3f} ms a {per} (CUDA events, "
        f"mean of {steps}: {[round(s, 3) for s in step_ms]}; all calls "
        f"{[round(s, 3) for s in r['call_ms']]}), {r['wall']:.1f} s of "
        f"main, peak {r['peak'] / 2 ** 30:.3f} GiB, |etot - e0|/e0 = "
        f"{drift:.3e}, fail-stops {len(r['fails'])} (before the first "
        f"step), grid {grid}, launches {launches}")
    if prop == "ve":
        res["split"] = gather_split(box, cfg, grid, state)
        sp = res["split"]
        log(f"  gather step at the last state: {sp['step_ms']:.3f} ms = "
            + ", ".join(f"{k} {v:.3f}" for k, v in sp["split_ms"].items())
            + f"; {sp['launches']} device activities (kernels, copies) in "
              f"{sp['device_busy_ms']} ms busy; idx "
              f"{sp['idx_bytes'] / 2 ** 20:.1f} MiB (ngpad {sp['ngpad']}, "
              f"cell_cap {sp['cell_cap']}, level {sp['level']})")
        log("  the five stages by chunk rule: " + "; ".join(
            f"{k} ({v['rows']} rows a chunk) {v['ms']:.3f} ms, peak "
            f"{v['peak_bytes'] / 2 ** 20:.1f} MiB above their inputs"
            for k, v in sp["stage_chunks"].items()))
    report.setdefault("cli_runs", {})[prop] = res


def cli_subprocess(report):
    """(m) 3: python -m sphexa_tpu_torch.main as a subprocess: Evrard 30
    for 3 steps with an ASCII dump at step 3, then a restart from that
    dump for 1 step (dumped too); both exit 0, the restart's rows
    finite."""
    from sphexa_tpu_torch.io.ascii import AsciiReader

    out = {}
    paths = {k: os.path.join("chiprun_out", f"cli_evrard{k}.txt")
             for k in ("", "_restart", "_constants", "_restart_constants")}
    for p in paths.values():
        if os.path.exists(os.path.join(ROOT, p)):
            os.remove(os.path.join(ROOT, p))
    base = [sys.executable, "-m", "sphexa_tpu_torch.main"]
    runs = (("run", ["--init", "evrard", "-n", "30", "-s", "3", "--ascii",
                     "-w", "3", "-o", paths[""], "--constants",
                     paths["_constants"]]),
            ("restart", ["--init", paths[""], "-s", "1", "--ascii", "-w",
                         "1", "-o", paths["_restart"], "--constants",
                         paths["_restart_constants"]]))
    for name, argv in runs:
        t0 = time.perf_counter()
        r = subprocess.run(base + argv, cwd=ROOT, capture_output=True,
                           text=True, timeout=600)
        secs = time.perf_counter() - t0
        tail = r.stdout.strip().splitlines()[-4:]
        for ln in tail:
            log(f"    {ln}")
        assert r.returncode == 0, f"{name}: rc {r.returncode}: {r.stderr}"
        fails = [ln for ln in r.stderr.splitlines()
                 if ln.startswith("# re-gridded with larger caps")]
        grown = sum(ln.startswith("# box expanded")
                    for ln in r.stdout.splitlines())
        out[name] = dict(seconds=secs, stdout_tail=tail, fail_stops=fails,
                         box_growths=grown)
        log(f"  {name}: rc 0 in {secs:.1f} s; fail-stop re-grids {fails}; "
            f"box growths {grown}")
    fields, attrs = AsciiReader(os.path.join(ROOT, paths["_restart"])) \
        .read_step(-1)
    assert attrs["iteration"] == 5, attrs
    for k, v in fields.items():
        assert np.isfinite(v).all(), f"restart: non-finite {k}"
    out["restart_rows"] = len(fields["x"])
    log(f"  restart dump: {len(fields['x'])} rows, iteration "
        f"{attrs['iteration']}, every row finite")
    report["cli_subprocess"] = out


def cli_phase(report):
    """Phase (m): the command line on the card."""
    import scipy
    from sphexa_tpu_torch.observables.sedov_solution import alpha_constant

    t0 = time.perf_counter()
    # the constants files and dumps of the runs below go there
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    log("(m) the gather step on the card against the CPU:")
    gather_check(report)
    log(f"  {time.perf_counter() - t0:.1f} s into phase (m)")
    for prop, steps in CLI_RUNS:
        log(f"(m) main([... --prop {prop} ...]) at Sedov {CLI_SIDE}^3:")
        cli_run(report, prop, steps)
        log(f"  {time.perf_counter() - t0:.1f} s into phase (m)")
    log("(m) python -m sphexa_tpu_torch.main, Evrard 30, ASCII dump and "
        "restart:")
    cli_subprocess(report)
    log(f"  {time.perf_counter() - t0:.1f} s into phase (m)")
    alpha = alpha_constant(5.0 / 3.0)
    assert round(alpha, 4) == 0.4936, alpha
    log(f"(m) sedov_solution.alpha_constant(5/3) = {alpha:.6f} (scipy "
        f"{scipy.__version__})")
    report["sedov_alpha"] = alpha
    report["cli_phase_seconds"] = time.perf_counter() - t0
    log(f"  phase (m): {report['cli_phase_seconds']:.1f} s")


# ---------------------------------------------------------------------------
# (n) subsonic turbulence, the std formulation and the remaining cases
# ---------------------------------------------------------------------------

TURB_SIDE = 100             # turbulence 100^3 (1,000,000 particles)
TURB_CHECK_SIDE = 10        # card against CPU
TURB_RUNGS = 4              # the CLI's BdtVE default
TURB_SAMPLE_CELLS = 96      # cells of each gated launch held against plain
TURB_CHECK_SEED = 7         # perturbed() of the gated stages' check frame
CASE_SIDE = 50              # the other new cases through main
# (case, prop, n, steps); turbulence-ve-bdt: one warm-up and 2 timed
# cycles
TURB_RUNS = (("turbulence", "turbulence-ve-bdt", TURB_SIDE, 3),
             ("turbulence", "turbulence-ve", TURB_SIDE, 2),
             ("noh", "std", TURB_SIDE, 2))
# (case, prop) -> the JAX planner's refusal (ops/cellmajor.
# choose_cap_and_grid): KH's z of 0.0625 and wind-shock's 4:1:1 box hold
# no slot grid with a legal z-group below cap_max at n = 50
EXPECTED_REFUSALS = {
    (case, "ve-pallas"): "no (cap, grid) with a legal z-group fits these "
                         "positions below cap_max=1024"
    for case in ("kelvin-helmholtz", "wind-shock")}
CASE_RUNS = tuple((case, prop, CASE_SIDE, 2)
                  for case in ("gresho-chan", "isobaric-cube",
                               "kelvin-helmholtz", "wind-shock")
                  for prop in ("ve", "ve-pallas"))


def turb_engine_check(report):
    """(n) 1: the new engines on the card against the CPU at 10^3, with
    the CPU tests' tolerances: TurbBdtVE one cycle of 2 rungs
    (tests/test_torch_turb_bdt.py), TurbVeProp 2 steps on the lattice
    (tests/test_torch_turbulence.py) and make_std_step 2 steps at Noh
    (tests/test_torch_std.py). The CPU references on one thread."""
    import torch
    from sphexa_tpu_torch.config import SphConfig
    from sphexa_tpu_torch.init.factory import make_initializer
    from sphexa_tpu_torch.neighbors import CellGrid, choose_level
    from sphexa_tpu_torch.ops.cellmajor import choose_cm_grid
    from sphexa_tpu_torch.propagator.std import make_std_step
    from sphexa_tpu_torch.propagator.turb_ve import TurbVeProp
    from sphexa_tpu_torch.propagator.ve_bdt import TurbBdtVE

    side = TURB_CHECK_SIDE
    threads = torch.get_num_threads()
    out = {}

    def fresh(case, dev):
        torch.set_num_threads(1 if dev == "cpu" else threads)
        st, box, cfg = make_initializer(case)(side, SphConfig(),
                                              device=dev)
        return st, box, cfg.replace(cell_cap=128)

    # TurbBdtVE, one cycle of 2 rungs
    runs = {}
    for dev in (DEVICE, "cpu"):
        st, box, cfg = fresh("turbulence", dev)
        grid = choose_cm_grid(box, float(st.p.h.max()) * 1.25, side ** 3)
        eng = TurbBdtVE(box, grid, cfg, num_rungs=2, device=dev)
        bst, ds = eng.run_cycle(eng.bind_bdt(st))
        runs[dev] = ([{k: np.asarray(v.cpu()).tolist()
                       for k, v in d._asdict().items()} for d in ds],
                     bst.rung.cpu().numpy(), eng.unbind(bst.rv, side ** 3),
                     eng.turb.phases.copy(), str(grid))
    (a, ra, sa, pa, grid), (b, rb, sb, pb, _) = runs["cpu"], runs[DEVICE]
    for x, y in zip(a, b):
        assert x["overflow"] == y["overflow"] == 0
        np.testing.assert_allclose(y["dt"], x["dt"], rtol=1e-5)
        np.testing.assert_allclose(y["eint"], x["eint"], rtol=1e-6)
        np.testing.assert_allclose(y["ecin"], x["ecin"], rtol=1e-3)
        assert y["ecin"] > 0
        assert y["rung_hist"] == x["rung_hist"], (y, x)
        assert y["active_cell_frac"] == x["active_cell_frac"]
    np.testing.assert_array_equal(rb, ra)
    np.testing.assert_array_equal(pb, pa)
    for fields, tol in ((("x", "y", "z", "vx", "vy", "vz", "temp", "h"),
                         2e-3), (("alpha",), 1e-4)):
        rows_close(f"TurbBdtVE {fields}", [getattr(sb.p, f) for f in fields],
                   [getattr(sa.p, f) for f in fields], tol)
    log(f"  {side}^3 TurbBdtVE {DEVICE} vs cpu, 1 cycle of 2 rungs on "
        f"{grid}: rung_hist {[d['rung_hist'] for d in b]} equal, ecin "
        f"{b[-1]['ecin']:.6e} vs {a[-1]['ecin']:.6e}, OU phases equal")
    out["turb_bdt"] = dict(card=b, cpu=a, grid=grid)

    # TurbVeProp and make_std_step, 2 steps each on the gather path
    for name, case, tol_v in (("turb_ve", "turbulence", 2e-3),
                              ("std", "noh", 1e-4)):
        runs = {}
        for dev in (DEVICE, "cpu"):
            st, box, cfg = fresh(case, dev)
            grid = CellGrid(choose_level(box, float(st.p.h.max()) * 1.25))
            step = (TurbVeProp(box, grid, cfg, device=dev)
                    if name == "turb_ve"
                    else make_std_step(box, grid, cfg, device=dev))
            ds = []
            for _ in range(2):
                st, d = step(st)
                ds.append({k: float(getattr(d, k)) for k in (
                    "dt", "etot", "eint", "ecin", "max_nc",
                    "max_cell_count")})
            runs[dev] = (ds, st)
        (a, sa), (b, sb) = runs["cpu"], runs[DEVICE]
        for x, y in zip(a, b):
            assert y["max_nc"] == x["max_nc"]
            assert y["max_cell_count"] == x["max_cell_count"]
            for k in ("dt", "etot", "eint", "ecin"):
                rtol = 1e-3 if k == "ecin" and name == "turb_ve" else 1e-5
                np.testing.assert_allclose(y[k], x[k], rtol=rtol,
                                           err_msg=f"{name} {k}")
        for fields, tol in ((("x", "y", "z", "temp", "h", "alpha"), 1e-4),
                            (("vx", "vy", "vz"), tol_v)):
            rows_close(f"{name} {fields}", [getattr(sb.p, f) for f in fields],
                       [getattr(sa.p, f) for f in fields], tol)
        log(f"  {side}^3 {name} {DEVICE} vs cpu, 2 steps: dt "
            f"{b[-1]['dt']:.6e} vs {a[-1]['dt']:.6e}, ecin "
            f"{b[-1]['ecin']:.6e} vs {a[-1]['ecin']:.6e}, rows within "
            f"tolerance")
        out[name] = dict(card=b, cpu=a)
    torch.set_num_threads(threads)
    report["turb_engine_10"] = out


def case_run(report, case, prop, n, steps, extra=()):
    """(n) 2: main([...]) in this process (main_in_process) on one case
    and prop. Gates: the slot-frame props launch their kernels and no
    other; turbulence: Mach RMS > 0 and growing over the last two steps
    (cycles); every other case: |etot - e0|/e0 < CLI_DRIFT_BOUND. A
    fail-stop may follow an h or box re-grid (Noh's open box grows), as
    in the JAX CLI. The refusals of EXPECTED_REFUSALS are recorded with
    the planner's message; any other refusal, or a run where one is
    expected, fails the phase."""
    key = " ".join([case, prop, str(n)] + [a for a in extra[:1]])
    consts = os.path.join(ROOT, "chiprun_out", f"turb_{case}_{prop}"
                          f"{'_glass' if extra else ''}_constants.txt")
    argv = ["--init", case, "-n", str(n), "-s", str(steps), "--prop",
            prop] + list(extra)
    refusal = EXPECTED_REFUSALS.get((case, prop))
    try:
        r = main_in_process(argv, consts)
    except ValueError as e:
        if refusal is None or refusal not in str(e):
            raise
        log(f"  {key}: refused, as the JAX CLI refuses it: {e}")
        report.setdefault("turb_cli_runs", {})[key] = dict(refused=str(e))
        return None
    assert refusal is None, f"{key}: ran, where the planner refuses it"
    rows = r["rows"]
    assert rows.shape[0] == steps, rows.shape
    assert set(r["launches"]) == PROP_KERNELS.get(prop, set()), \
        (key, r["launches"])
    etot = rows[:, 3]
    drift = abs(float(etot[-1]) - r["e0"]) / r["e0"]
    res = dict(steps=steps, call_ms=r["call_ms"], step_ms=r["step_ms"],
               fail_stops=len(r["fails"]),
               fail_stop_lines=[r["lines"][i] for i in r["fails"]],
               wall_s=r["wall"], peak_bytes=r["peak"], e0=r["e0"],
               energy_drift=drift, rows=rows.tolist(),
               launches=r["launches"], grid=str(r["made"][-1][2]),
               n_particles=int(r["state"].p.alive.sum()))
    if case == "turbulence":
        mach = rows[:, 9]
        assert mach[-1] > mach[-2] > 0, f"{key}: Mach RMS {mach}"
        res["mach_rms"] = mach.tolist()
        gate = f"Mach RMS {[float('%.6g' % m) for m in mach]}"
    else:
        assert drift < CLI_DRIFT_BOUND, f"{key}: energy drift {drift:.3e}"
        gate = f"|etot - e0|/e0 = {drift:.3e}"
    if prop.endswith("bdt"):
        res["bdt_lines"] = [ln for ln in r["lines"]
                            if ln.startswith("# bdt:")]
    timed = r["step_ms"][1:] if prop.endswith("bdt") else r["step_ms"]
    res["mean_ms"] = float(np.mean(timed))
    log(f"  {key}: {res['mean_ms']:.3f} ms a "
        f"{'cycle' if prop.endswith('bdt') else 'step'} (timed "
        f"{[round(s, 3) for s in timed]}; all calls "
        f"{[round(s, 3) for s in r['call_ms']]}), {r['wall']:.1f} s of "
        f"main, {res['n_particles']} particles, peak "
        f"{r['peak'] / 2 ** 30:.3f} GiB, fail-stops {len(r['fails'])}, "
        f"grid {res['grid']}, {gate}, launches {r['launches']}")
    report.setdefault("turb_cli_runs", {})[key] = res
    return res


def glass_run(report):
    """(n) 2, --glass: a 2^3 template (a jittered lattice, written to
    chiprun_out) makes kelvin-helmholtz at n = 50 take its glass branch
    (its thin z hosts blocks of 2 x 1/50 there); the template is module
    state of init/glass.py, cleared afterwards. Gated as case_run, and
    the glass branch ran (another particle count than the lattice's)."""
    from sphexa_tpu_torch.init.glass import set_glass_template
    from sphexa_tpu_torch.init.lattice import jittered_lattice

    tmpl = os.path.join(ROOT, "chiprun_out", "glass_template_2.npz")
    x, y, z = jittered_lattice(2, jitter=0.3, seed=5)
    np.savez(tmpl, x=x, y=y, z=z)
    log(f"(n) main([... --init kelvin-helmholtz -n {CASE_SIDE} --prop ve "
        f"--glass {os.path.basename(tmpl)} ...]):")
    try:
        res = case_run(report, "kelvin-helmholtz", "ve", CASE_SIDE, 2,
                       ("--glass", tmpl))
    finally:
        set_glass_template(None)
    lattice = report["turb_cli_runs"][f"kelvin-helmholtz ve {CASE_SIDE}"]
    assert res["n_particles"] != lattice["n_particles"], \
        "--glass: the lattice fallback ran"


def turb_engine_path(report, rows):
    """(n) 3: TurbBdtVE at turbulence 100^3 driven directly: one warm-up
    cycle, one timed cycle (events after the resync and each substep;
    counters zeroed just before, read just after); the rung histogram
    and active fractions; a fully active substep split into the five
    gated stages, the six ghost refreshes, the stirring sum and the
    rest, each timed alone at its captured inputs, each gated stage
    beside its ungated cell launch on the same inputs and its bound (all
    added to its kernel row as turb_ms, turb_cell_ms, turb_bound_ms,
    turb_bound_by); one more substep under PyTorch's sync check set to
    errors. Then the check frame: the same lattice perturbed (perturbed(),
    as the Sedov checks), bound to the same grid (cap 128) and fully
    active at the resync's substep; each gated stage there against its
    plain version on sampled cells at the per-row tolerances of the
    perturbed Sedov checks, its invalid slots at their fill. (At rest on
    the lattice the momentum stage's accelerations and the IAD stage's
    velocity gradients are cancelling sums of rounding noise, which no
    tolerance of kernel against plain can hold.)"""
    import torch
    from sphexa_tpu_torch.config import SphConfig
    from sphexa_tpu_torch.init.factory import make_initializer
    from sphexa_tpu_torch.main import _slot_grid
    from sphexa_tpu_torch.ops import pair_ve as pv
    from sphexa_tpu_torch.propagator.ve_bdt import TurbBdtVE

    t0 = time.perf_counter()
    state, box, cfg = make_initializer("turbulence")(TURB_SIDE, SphConfig(),
                                                     device=DEVICE)
    # the CLI's planner grid
    grid = _slot_grid(box, cfg, float(state.p.h.max()), TURB_SIDE ** 3, {},
                      state)
    eng = TurbBdtVE(box, grid, cfg, num_rungs=TURB_RUNGS, device=DEVICE)
    bst = eng.bind_bdt(state)
    assert int(bst.rv.overflow) == 0, "slot overflow at bind"
    bst, _ = eng.run_cycle(bst)                         # warm-up
    torch.cuda.synchronize()
    log(f"  setup + warm-up cycle {time.perf_counter() - t0:.1f} s; grid "
        f"{grid}, Z {eng.pve_gated.zgroup}")

    marks = []
    resync, substep = eng.resync, eng.substep

    def marked(fn, what):
        def call(*a):
            out = fn(*a)
            marks.append((what, torch.cuda.Event(enable_timing=True)))
            marks[-1][1].record()
            return out
        return call
    eng.resync = marked(resync, "resync")
    eng.substep = marked(substep, "substep")
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    bst, diags = eng.run_cycle(bst)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    del eng.resync, eng.substep
    nsub = 1 << (TURB_RUNGS - 1)
    used = {k.name for k in eng.pve_gated.kernels}
    want = {k.name: nsub if k.name in used else 0 for k in kernels}
    want["ghost_refresh"] = 5 * nsub
    want["pair_gate"] = 5 * nsub
    assert launches == want, (launches, want)
    evs = [start] + [e for _, e in marks]
    span = [a.elapsed_time(b) for a, b in zip(evs, evs[1:])]
    d = {k: [np.asarray(getattr(x, k).cpu()).tolist() for x in diags]
         for k in ("dt", "etot", "ecin", "active_frac", "active_cell_frac",
                   "rung_hist", "overflow")}
    assert max(d["overflow"]) == 0, "slot overflow"
    for f in ("x", "y", "z", "h", "vx", "vy", "vz", "temp", "alpha"):
        assert torch.isfinite(getattr(bst.rv, f)).all(), f"non-finite {f}"
    assert d["ecin"][-1] > d["ecin"][0] > 0, d["ecin"]

    # one fully active substep, split
    b1, _ = eng.resync(bst)
    dt_min = float(b1.dt_min)
    eng.turb.update_noise(dt_min)
    (pr, pi), = eng.turb.device_phases([eng.device])
    torch.cuda.synchronize()
    with Spy((pv.ghost_refresh,) + tuple(eng.pve_gated.kernels)) as spy:
        eng.substep(b1, pr, pi)
    torch.cuda.synchronize()
    sub_ms = cuda_ms(lambda: eng.substep(b1, pr, pi), 3)
    idx = eng.gravity_index(b1.rv.valid)
    rv = b1.rv
    stir_ms = cuda_ms(lambda: eng.stir.stir(rv.x[idx], rv.y[idx], rv.z[idx],
                                            pr, pi), 5)
    gated = [(k, a, o) for k, a, o in spy.calls
             if getattr(k, "gated", False)]
    refreshes = [(k, a, o) for k, a, o in spy.calls
                 if k.name == "ghost_refresh"]
    stage_ms = {k.name: cuda_ms(lambda: k._launch(*a), 5)
                for k, a, _ in gated}
    # a refresh rewrites the ghost slots of its stack from the interior:
    # repeated on one copy it redoes the same work
    ghost_ms = sum(cuda_ms(lambda a=a, st=a[0].clone(): k._launch(st, *a[1:]),
                           5) for k, a, _ in refreshes)
    rest = sub_ms - sum(stage_ms.values()) - ghost_ms - stir_ms
    split = dict(substep_ms=sub_ms, gated_stages_ms=stage_ms,
                 gated_total_ms=sum(stage_ms.values()),
                 ghost_refresh_ms=ghost_ms, refreshes=len(refreshes),
                 stirring_ms=stir_ms, stirring_rows=int(idx.numel()),
                 rest_ms=rest)
    # the stirring sum's bound: x, y, z read and three rows written, and
    # per row and mode the angle (3 FMA), cos and sin, and the two
    # products' 6 FMA (12 flops), against the fp32 peak
    rows_n = int(idx.numel())
    stir_ops = rows_n * 112 * (6 + 2 + 12)
    split["stirring_bound_ms"] = max(stir_ops / FP32_PEAK,
                                     24 * rows_n / HBM_BW) * 1e3
    # the substep takes no host sync with its phases on the device
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.substep(b1, pr, pi)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

    # the gated stages at this frame: beside the ungated cell launch on
    # the same inputs, and their bound
    xh_args = next(a for k, a, _ in gated if k.name == "pair_xh_gated")
    J = xh_args[0]
    act = xh_args[4][0]
    on = pv.supercell_active(act, grid, eng.pve_gated.zgroup)
    occupied = (valid_slots(J) & eng.intmask).view(-1, grid.cap).any(1)
    assert bool((on | ~occupied).all()), "an occupied cell inactive"
    nc_sph = pv.pair_xh._launch(J, None, grid, xh_args[3])[2] + 1
    cand, inside, per_slot = pair_counts(J, eng, grid, nc_sph)
    recount, moved, _ = xh_recounts(J, grid, xh_args[3], per_slot)
    n_int = float(eng.intmask.sum())
    by_name = {r["name"]: r for r in rows}
    ungated = {stage_of(kg.name): next(
        x for x in pv.PAIR_KERNELS
        if not x.gated and x.name == stage_of(kg.name)) for kg, _, _ in gated}
    checks = {}
    for kg, args, _ in gated:
        J, I2, g, c = args[:4]
        k = ungated[stage_of(kg.name)]
        cell_ms = cuda_ms(lambda: k._launch(J, I2, g, c), 5)
        ops = cand * GEO_FLOPS + inside * BODY_FLOPS[k.name]
        if k.name == "pair_xh":
            ops += recount * RECOUNT_FLOPS
        fi2 = I2.shape[0] if I2 is not None else 0
        # every interior slot active: J rows read once, I2 and the
        # outputs once, act once
        nbytes = 4 * (J.shape[0] * n_int + fi2 * n_int + g.n_slots
                      + kg.fo * n_int)
        bound, by = pair_bound(ops, nbytes)
        ms = stage_ms[kg.name]
        checks[kg.name] = dict(ms=ms, cell_ms=cell_ms, bound_ms=bound,
                               bound_by=by)
        if kg.name in by_name:
            by_name[kg.name].update(turb_ms=ms, turb_cell_ms=cell_ms,
                                    turb_bound_ms=bound, turb_bound_by=by)
        log(f"  cap {g.cap} {kg.name:20s} {ms:8.3f} ms (cell launch "
            f"{k.name} {cell_ms:.3f} ms, {ms / cell_ms:.3f}x)  bound "
            f"{bound:.4f} ms ({by})")

    # the check frame
    pstate, _, _ = make_initializer("turbulence")(TURB_SIDE, SphConfig(),
                                                  device=DEVICE)
    bj = eng.bind_bdt(perturbed(pstate, TURB_CHECK_SEED))
    assert int(bj.rv.overflow) == 0, "slot overflow at the check frame"
    bj, _ = eng.resync(bj)
    eng.turb.update_noise(float(bj.dt_min))
    (qr, qi), = eng.turb.device_phases([eng.device])
    with Spy(tuple(eng.pve_gated.kernels)) as spy:
        eng.substep(bj, qr, qi)
    torch.cuda.synchronize()
    calls = [(k, a, o) for k, a, o in spy.calls if getattr(k, "gated", False)]
    for i, (kg, args, out) in enumerate(calls):
        J, I2, g, c, (act, _), _ = args
        on = pv.supercell_active(act, g, eng.pve_gated.zgroup)
        occupied = (valid_slots(J) & eng.intmask).view(-1, g.cap).any(1)
        assert bool((on | ~occupied).all()), \
            f"{kg.name}: an occupied cell inactive at the check frame"
        k = ungated[stage_of(kg.name)]
        cells = sample_occupied_cells(g, valid_slots(J), eng.intmask,
                                      TURB_SAMPLE_CELLS, 50 + i)
        ref = pv._run_plain(k.body, J, I2, g, k.fo, cells=cells,
                            **k._body_kw(c))
        slots = torch.zeros(g.n_slots, dtype=torch.bool, device=DEVICE)
        lane = torch.arange(g.cap, device=DEVICE)
        slots[(cells[:, None] * g.cap + lane).reshape(-1)] = True
        mask = valid_slots(J) & slots & eng.intmask
        err, rel = compare(kg.name, ref, out, mask, per_row=True)
        nfill = check_fill(kg, J, out, eng.intmask)
        checks[kg.name].update(max_abs_err=err, max_rel_err=rel,
                               fill_slots=nfill, cells=int(cells.numel()))
        log(f"  check frame {kg.name:20s} {cells.numel()} cells against "
            f"plain: err {err:.3e} (rel {rel:.3e}); {nfill} invalid slots "
            f"at fill")
    assert {kg.name for kg, _, _ in calls} == set(checks), checks
    hist = d["rung_hist"][-1]
    log(f"  {TURB_SIDE}^3 TurbBdtVE: {sum(span):.3f} ms the cycle (resync "
        f"{span[0]:.3f}; substeps {[round(x, 3) for x in span[1:]]}); "
        f"rung_hist {hist}; active_frac {d['active_frac']}; "
        f"active_cell_frac {d['active_cell_frac']}")
    log(f"  substep split: {sub_ms:.3f} ms = gated stages "
        f"{split['gated_total_ms']:.3f} ("
        + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items())
        + f"), {len(refreshes)} ghost refreshes {ghost_ms:.3f}, stirring "
          f"{stir_ms:.3f} over {rows_n} rows (bound "
          f"{split['stirring_bound_ms']:.4f}), rest {rest:.3f}; the "
          f"substep ran with no host sync; candidates {cand:.4e}, "
          f"in-support pairs {inside:.4e}")
    report["turb_engine_path"] = dict(
        grid=str(grid), cycle_ms=sum(span), resync_ms=span[0],
        substeps_ms=span[1:], diags=d, launches=launches, split=split,
        candidates=cand, in_support=inside, xh_recount_candidates=recount,
        xh_h_moved=moved, gated=checks, check_seed=TURB_CHECK_SEED)


def turb_sharded_path(report, D=2):
    """(n) 4: TurbShardedBdtVE at turbulence 100^3, D shards on the one
    card, sized by plan_slab as (k) sizes ShardedBdtVE: one warm-up and
    one timed cycle (counters zeroed just before, read just after);
    overflow 0 and lost 0 (run_cycle raises on either), rows finite, the
    stirring did work."""
    import torch
    from sphexa_tpu_torch.config import SphConfig
    from sphexa_tpu_torch.domain.mesh import SlabMesh
    from sphexa_tpu_torch.init.factory import make_initializer
    from sphexa_tpu_torch.propagator.ve_bdt_sharded import TurbShardedBdtVE
    from sphexa_tpu_torch.propagator.ve_sharded import plan_slab

    state, box, cfg = make_initializer("turbulence")(TURB_SIDE, SphConfig(),
                                                     device=DEVICE)
    host = {c: getattr(state.p, c).cpu().numpy() for c in "xyz"}
    grid, sc = plan_slab(host, box, float(state.p.h.max()), D)
    eng = TurbShardedBdtVE(box, grid, cfg, sc, SlabMesh(D, devices=[DEVICE]),
                           num_rungs=TURB_RUNGS)
    bsts, _ = eng.run_cycle(eng.distribute_bind(state))
    torch.cuda.synchronize()
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    bsts, ds = eng.run_cycle(bsts)
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b)
    launches = {k.name: k.launches for k in kernels if k.launches}
    nsub = 1 << (TURB_RUNGS - 1)
    assert launches["ghost_refresh_xy"] == D * (5 * nsub + 1), launches
    assert launches["pair_gate"] == D * 5 * nsub, launches
    for bst in bsts:
        for f in ("x", "y", "z", "h", "vx", "vy", "vz", "temp", "alpha"):
            assert torch.isfinite(getattr(bst.rv, f)).all(), f
    assert float(ds[-1].ecin) > 0
    out = eng.unbind(bsts, TURB_SIDE ** 3)
    assert bool(out.p.alive.all()), "rows lost"
    hist = ds[-1].rung_hist.tolist()
    log(f"  {TURB_SIDE}^3 TurbShardedBdtVE D={D} ({grid}, {sc}): {ms:.3f} "
        f"ms/cycle; overflow 0, lost 0, rows finite, every particle back "
        f"at unbind; rung_hist {hist}; ecin {float(ds[-1].ecin):.6e}; "
        f"launches {launches}")
    report["turb_sharded_path"] = dict(D=D, grid=str(grid), cycle_ms=ms,
                                       rung_hist=hist, launches=launches,
                                       ecin=float(ds[-1].ecin))


def turb_phase(report, rows):
    """Phase (n): subsonic turbulence, the std formulation and the
    remaining cases on the card."""
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    log("(n) the new engines on the card against the CPU:")
    turb_engine_check(report)
    log(f"  {time.perf_counter() - t0:.1f} s into phase (n)")
    for case, prop, n, steps in TURB_RUNS + CASE_RUNS:
        log(f"(n) main([... --init {case} -n {n} --prop {prop} ...]):")
        case_run(report, case, prop, n, steps)
        log(f"  {time.perf_counter() - t0:.1f} s into phase (n)")
    glass_run(report)
    log(f"  {time.perf_counter() - t0:.1f} s into phase (n)")
    log(f"(n) TurbBdtVE at turbulence {TURB_SIDE}^3, driven directly:")
    turb_engine_path(report, rows)
    log(f"  {time.perf_counter() - t0:.1f} s into phase (n)")
    log(f"(n) TurbShardedBdtVE at turbulence {TURB_SIDE}^3:")
    turb_sharded_path(report)
    report["turb_phase_seconds"] = time.perf_counter() - t0
    log(f"  phase (n): {report['turb_phase_seconds']:.1f} s")


# ---------------------------------------------------------------------------
# (o) the h-tier zoom grids
# ---------------------------------------------------------------------------

TIER_SIDE = 100             # Evrard 100 (523,984 particles), as phase (l)
TIER_CAP_MAX = 128          # the CLI's choose_tiers_auto budget
TIER_DT0 = "3e-5"           # phase (l)'s dt0
# (prop, calls of the step function): one warm-up, then timed ones
TIER_RUNS = (("ve-tiered-resident", 4), ("ve-tiered", 3),
             ("ve-tiered-bdt", 1))
TIER_SEDOV = 100            # Sedov 100^3 under ve-tiered (one tier)
TIER_SEDOV_STEPS = 2
TIER_SAMPLE_CELLS = 48      # cells of each tier launch held against plain
TIER_GATED_SEED = 11        # activity_pattern() of the finest tier
# the FMM of phase (l) on every stepper the CLI makes (no CLI flag)
TIER_FMM = dict(gravity_solver="fmm", fmm_level=EVRARD_LEVEL)
# the uniform resident Evrard 100 step of phase (l) on this card
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 5): the comparison of
# (o) 2
UNIFORM_STEP_MS = 1053.812
UNIFORM_HYDRO_MS = 29.366
# the JAX CLI's own outcome at Evrard 100 (main.py:207-224): its
# tiered props re-plan with choose_tiers_auto after the first step (the
# open box grows around the sphere), where no rung of the ladder may pass
# the band audit (ROADMAP Queue 3); a main run may end so, after an
# accepted step
EXPECTED_TIER_FAULT = "no feasible (slack, theta) tier ladder rung"
_TIER_STAGES = ("pair_xh", "pair_gradh", "pair_iad", "pair_av",
                "pair_momentum")
PROP_KERNELS["ve-tiered"] = set(_TIER_STAGES)
PROP_KERNELS["ve-tiered-resident"] = set(_TIER_STAGES)
PROP_KERNELS["ve-tiered-bdt"] = {"pair_gate"} | {
    s + "_gated" for s in _TIER_STAGES}


def tier_ladder(box, p, tiers):
    """Per tier: its h band, grid, cap, slots, frame and owned rows,
    sub-box, boundaries, cell edge and support bound (host numbers)."""
    from sphexa_tpu_torch.ops.cellmajor import legal_zgroup
    from sphexa_tpu_torch.propagator.ve_tiered import (tier_coords,
                                                       tier_edge,
                                                       tier_support_bound)
    alive = p.alive.cpu().numpy()
    x, y, z, h = (getattr(p, c).cpu().numpy()[alive] for c in "xyzh")
    xr, yr, zr = tier_coords(box, tiers[0].shift, x, y, z)
    out = []
    for ti, t in enumerate(tiers):
        s = t.sub
        inbox = ((xr >= s.xmin) & (xr <= s.xmax) & (yr >= s.ymin)
                 & (yr <= s.ymax) & (zr >= s.zmin) & (zr <= s.zmax))
        owned = (h >= t.h_lo) & ((h < t.h_hi) if ti else True)
        g = t.grid
        zg = legal_zgroup(g.npz, g.cap)
        assert g.cap % 32 == 0 and g.cap <= 1024 and zg > 0, \
            f"tier {ti}: {g} outside PairVE's caps or without a z-group"
        out.append(dict(
            h_lo=float(t.h_lo), h_hi=float(t.h_hi), cutoff=float(t.cutoff),
            grid=str(g), cap=g.cap, n_slots=g.n_slots, zgroup=zg,
            frame_rows=int((inbox & (h >= t.cutoff)).sum()),
            owned_rows=int(owned.sum()),
            sub=[float(v) for v in (s.xmin, s.xmax, s.ymin, s.ymax, s.zmin,
                                    s.zmax)],
            boundaries=[b.name for b in (s.bx, s.by, s.bz)],
            edge=tier_edge(t), support_bound=tier_support_bound(t)))
    return out


def tier_plan(report, tiers, plan_s):
    """(o) 1: the CLI's ladder for Evrard 100 (choose_tiers_auto,
    cap_max 128, planned on the host by the first main run from the
    initial state, in plan_s seconds): each tier's band, grid, slots,
    frame and owned rows, the total slots beside the uniform frame of
    phase (l), and the band audit (C), which must count 0. Returns the
    initial state, box and config of that run."""
    from sphexa_tpu_torch.propagator.ve_tiered import audit_tiers
    state, box, cfg, ugrid = evrard(TIER_SIDE, DEVICE, "fmm", EVRARD_LEVEL)
    p = state.p
    xyzh = [getattr(p, c).cpu().numpy() for c in "xyzh"]
    alive = p.alive.cpu().numpy()
    t0 = time.perf_counter()
    viol = audit_tiers(tiers, box, *xyzh, alive=alive)
    audit_s = time.perf_counter() - t0
    assert viol == 0, f"band audit: {viol} violations"
    ladder = tier_ladder(box, p, tiers)
    for i, t in enumerate(ladder):
        log(f"  tier {i}: h [{t['h_lo']:.5g}, {t['h_hi']:.5g}) cutoff "
            f"{t['cutoff']:.5g}, {t['grid']} (Z {t['zgroup']}), "
            f"{t['n_slots']} slots, frame {t['frame_rows']} rows, owns "
            f"{t['owned_rows']}; sub-box {[round(v, 4) for v in t['sub']]} "
            f"{t['boundaries']}, edge {t['edge']:.5g}, support bound "
            f"{t['support_bound']:.5g}")
    total = sum(t["n_slots"] for t in ladder)
    log(f"  {int(alive.sum())} particles; {len(tiers)} tiers, {total} "
        f"slots in all, beside the uniform frame's {ugrid.n_slots} "
        f"({ugrid}); planned in {plan_s:.1f} s, audit {viol} violations "
        f"in {audit_s:.2f} s")
    report["tier_plan"] = dict(ladder=ladder, total_slots=total,
                               uniform_slots=ugrid.n_slots,
                               uniform_grid=str(ugrid), plan_s=plan_s,
                               audit_violations=viol, audit_s=audit_s)
    return state, box, cfg


def tier_fault_gates(key, prop, part):
    """The gates of a tiered main run that ended in EXPECTED_TIER_FAULT
    (main_in_process's `partial`): every call accepted (no fold: a fold
    that a re-tier cannot clear is a failure, not the JAX CLI's
    outcome), the plan that raised asked for by an h re-grid or a box
    growth after an accepted step, the last state on the card and
    finite, nf_truncated 0, |etot - e0|/|e0| < CLI_DRIFT_BOUND on the
    last call's state, and the prop's kernels launched, each stage once
    per tier per call (BDT: each stage as often as the others, a
    multiple of the tiers)."""
    import torch
    from sphexa_tpu_torch.observables import conserved_quantities
    lines, made, tried = part["lines"], part["made"], part["tried"]
    folds = sum(ln.startswith(FAIL_STOPS) for ln in lines)
    assert folds == 0, f"{key}: {folds} fold(s) before the re-plan fault"
    checks = sum(ln.startswith("### Check") for ln in lines)
    # the step whose re-plan raised is accepted but not yet logged
    assert checks == len(part["call_ms"]) - 1, (key, checks)
    assert len(tried) == len(made) + 1, (key, len(tried), len(made))
    (box_p, h_p), (box_f, h_f) = tried[-2], tried[-1]
    re_plan = ("box growth" if box_f != box_p
               else "h re-grid" if h_f > 1.25 * h_p else None)
    assert re_plan, f"{key}: the fault came from no box growth or h re-grid"
    for d in part["diags"]:
        assert int(getattr(d, "nf_truncated", 0)) == 0, "FMM truncation"
    state = part["state"]
    assert state.p.device.type == torch.device(DEVICE).type, \
        f"{key}: the state left the card"
    for f in ("x", "y", "z", "h", "vx", "vy", "vz", "temp", "alpha"):
        assert torch.isfinite(getattr(state.p, f)).all(), f"{key}: {f}"
    cfg = made[part["used"][-1]][1]
    etot = float(conserved_quantities(
        state.p, cfg, egrav=float(part["diags"][-1].egrav)).etot)
    drift = abs(etot - part["e0"][0]) / abs(part["e0"][0])
    assert drift < CLI_DRIFT_BOUND, f"{key}: energy drift {drift:.3e}"
    launches = part["launches"]
    assert set(launches) == PROP_KERNELS[prop], (key, launches)
    per_call = sum(len(made[i][2]) for i in part["used"])
    stage = {k: v for k, v in launches.items() if k != "pair_gate"}
    if prop.endswith("bdt"):
        assert len(set(stage.values())) == 1, launches
        assert min(stage.values()) % len(made[0][2]) == 0, launches
    else:
        assert stage == {k: per_call for k in stage}, (key, launches)
    return dict(accepted=len(part["call_ms"]), folds=0, re_plan=re_plan,
                plans=len(made), launches=launches, energy_drift=drift,
                e0=part["e0"][0], etot=etot,
                h_max=[h for _, h in tried],
                lines=[ln for ln in lines if ln.startswith(
                    ("### Check", "# tiers", "# box", "# re-gridded",
                     "# tiered-bdt"))])


def tier_cli_run(report, prop, steps, case="evrard", n=None):
    """(o) 3, 5: main([...]) in this process (main_in_process). Evrard
    runs under phase (l)'s FMM (TIER_FMM) with e0 from state_energy.
    Gates: the state on the card, the prop's kernels launched (each
    stage as often as the others) and no other, nf_truncated 0, every
    fold retried (main raises past three re-tiers), |etot - e0|/e0 <
    CLI_DRIFT_BOUND. At Evrard 100 the run may end in the JAX CLI's own
    outcome, EXPECTED_TIER_FAULT, raised by the re-plan that follows an
    accepted step; it is recorded with the calls that ran before it.
    Returns (the run's record, its first plan's tiers, that plan's
    seconds)."""
    import torch
    n = TIER_SIDE if n is None else n
    consts = os.path.join(ROOT, "chiprun_out",
                          f"tiers_{case}_{prop}_constants.txt")
    argv = ["--init", case, "-n", str(n), "-s", str(steps), "--dt0",
            TIER_DT0, "--prop", prop]
    grav = case == "evrard"
    key = f"{case} {n} {prop}"
    try:
        r = main_in_process(argv, consts,
                            cfg_override=TIER_FMM if grav else None,
                            energy=state_energy if grav else None)
    except ValueError as e:
        part = getattr(e, "partial", None)
        # the loop re-plans (box or h re-grid) before it logs the step
        if (not grav or EXPECTED_TIER_FAULT not in str(e) or part is None
                or not part["call_ms"]):
            raise
        res = tier_fault_gates(key, prop, part)
        res.update(expected_fault=str(e), call_ms=part["call_ms"],
                   plan_s=part["make_s"])
        log(f"  {key}: {res['accepted']} accepted call(s) "
            f"{[round(t, 3) for t in part['call_ms']]} ms (folds 0; "
            f"{len(part['made'])} plan(s); launches {res['launches']}; "
            f"|etot - e0|/|e0| = {res['energy_drift']:.3e}), then the "
            f"{res['re_plan']} re-plan meets the JAX CLI's outcome "
            f"(EXPECTED_TIER_FAULT): {e}")
        report.setdefault("tier_cli_runs", {})[key] = res
        return res, part["made"][0][2], part["make_s"][0]
    state = r["state"]
    assert state.p.device.type == torch.device(DEVICE).type, \
        f"{prop}: the state left the card"
    assert set(r["launches"]) == PROP_KERNELS[prop], (prop, r["launches"])
    stage = [v for k, v in r["launches"].items() if k != "pair_gate"]
    assert len(set(stage)) == 1, r["launches"]
    for d in r["diags"]:
        assert int(getattr(d, "nf_truncated", 0)) == 0, "FMM truncation"
    rows = r["rows"]
    assert rows.shape[0] == steps, rows.shape
    drift = abs(float(rows[-1, 3]) - r["e0"]) / abs(r["e0"])
    assert drift < CLI_DRIFT_BOUND, f"{prop}: energy drift {drift:.3e}"
    tiers = r["made"][-1][2]
    per = "cycle" if prop.endswith("bdt") else "step"
    timed = r["step_ms"][1:] if len(r["step_ms"]) > 1 else r["step_ms"]
    res = dict(case=case, n=n, steps=steps, call_ms=r["call_ms"],
               step_ms=r["step_ms"], mean_ms=float(np.mean(timed)),
               fail_stops=len(r["fails"]),
               fail_stop_lines=[r["lines"][i] for i in r["fails"]],
               re_plans=len(r["made"]) - 1, wall_s=r["wall"],
               peak_bytes=r["peak"], e0=r["e0"], energy_drift=drift,
               etot=rows[:, 3].tolist(), launches=r["launches"],
               n_tiers=len(tiers), tiers=tier_ladder(r["made"][-1][0],
                                                     state.p, tiers),
               tier_lines=[ln for ln in r["lines"]
                           if ln.startswith("# tiers:")])
    if prop == "ve-tiered-resident":
        # every stepper main made (a re-tier or a box re-grid makes a new
        # one, which binds anew): the in-step rebuilds of those that ran
        res["rebuilds"] = sum(int(f.carry.rebuilds) for f in r["fns"]
                              if f.carry is not None)
    if prop.endswith("bdt"):
        res["bdt_lines"] = [ln for ln in r["lines"]
                            if ln.startswith("# tiered-bdt:")]
    log(f"  {key}: {res['mean_ms']:.3f} ms a {per} "
        f"(CUDA events, timed {[round(t, 3) for t in timed]}; all calls "
        f"{[round(t, 3) for t in r['call_ms']]}), {r['wall']:.1f} s of "
        f"main, peak {r['peak'] / 2 ** 30:.3f} GiB, {len(tiers)} tier(s) "
        f"({[t['grid'] for t in res['tiers']]}), folds "
        f"{len(r['fails'])}, re-plans {res['re_plans']}, "
        + (f"in-step rebuilds {res['rebuilds']}, "
           if "rebuilds" in res else "")
        + (f"{res['bdt_lines']}, " if "bdt_lines" in res else "")
        + f"nf_truncated 0, |etot - e0|/|e0| = {drift:.3e}, launches "
          f"{r['launches']}")
    res["plan_s"] = r["make_s"]
    report.setdefault("tier_cli_runs", {})[key] = res
    return res, r["made"][0][2], r["make_s"][0]


def tier_steps(step, carry, n, diag_of):
    """n calls of step(carry) -> (carry, diag), a CUDA event after each.
    Returns (carry, diags, ms of each call)."""
    import torch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    diags = []
    ev[0].record()
    for i in range(n):
        carry, d = step(carry)
        ev[i + 1].record()
        diags.append(diag_of(d))
    torch.cuda.synchronize()
    return carry, diags, [ev[i].elapsed_time(ev[i + 1]) for i in range(n)]


def tier_replan(report, box, cfg, st, d, h_max0):
    """(o) 2: the re-plan the CLI's main loop makes after the first step,
    on the engine's state: the open box grows around the sphere
    (_grow_box), and a grown box or h_max past 1.25 h_max0 re-plans the
    tiers. The CLI's choose_tiers_auto (JAX main.py:207-224) meets
    EXPECTED_TIER_FAULT there, as the main runs below show; recorded
    here is choose_tiers_robust on the same state (the JAX bench's
    planner, bench.py:427-431: it clips the h tail where no rung
    fits)."""
    from sphexa_tpu_torch import main as cli
    from sphexa_tpu_torch.propagator.ve_tiered import choose_tiers_robust
    p = st.p
    xyzh = [getattr(p, c).cpu().numpy() for c in "xyzh"]
    alive = p.alive.cpu().numpy()
    h_max = float(xyzh[3][alive].max())
    grown = cli._grow_box(box, d.bounds, h_max0)
    out = dict(h_max0=h_max0, h_max=h_max,
               grown=None if grown is None else [
                   float(v) for v in (grown.xmin, grown.xmax)],
               h_regrid=h_max > 1.25 * h_max0)
    pbox = grown or box
    t0 = time.perf_counter()
    tiers, clip = choose_tiers_robust(pbox, *xyzh, alive=alive,
                                      cap_max=TIER_CAP_MAX)
    out["robust"] = None if tiers is None else [str(t.grid) for t in tiers]
    out["robust_clip"] = clip
    out["robust_clipped_rows"] = (None if clip is None else
                                  int((xyzh[3][alive] > clip).sum()))
    out["robust_s"] = time.perf_counter() - t0
    log(f"  the CLI's re-plan after step 1: box grown to {out['grown']}, "
        f"h_max {h_max0:.5g} -> {h_max:.5g}; choose_tiers_robust "
        f"({out['robust_s']:.1f} s): {out['robust']}, h clip {clip} "
        f"({out['robust_clipped_rows']} rows above it)")
    report["tier_replan"] = out


def tier_engine_runs(report, state, box, cfg, tiers, replan):
    """(o) 2-3 on the engines directly, on the initial plan from the
    initial Evrard 100 state (FMM level 6): make_ve_step_tiered_resident
    one warm-up and 3 timed steps (rebuilds, folds, nf_truncated 0,
    |etot - e0|/|e0| < CLI_DRIFT_BOUND, peak memory; the CLI's re-plan
    on the state after the warm-up step, tier_replan), its parts on the
    last state (tier_split); make_ve_step_tiered one warm-up and 2 timed
    steps; TieredBdtVE (4 rungs) one timed cycle (active fraction, rung
    histogram, fold). Counters zeroed just before each timed run and
    read just after: every tier's five stages each call. replan: the
    re-plan check (`--tiers` only: it plans twice more, ~20-40 s)."""
    import torch
    from sphexa_tpu_torch.propagator.ve_tiered import (
        make_ve_step_tiered, make_ve_step_tiered_resident)
    from sphexa_tpu_torch.propagator.ve_tiered_bdt import TieredBdtVE

    nt = len(tiers)
    e0 = state_energy(state, box, cfg)
    h_max0 = float(state.p.h[state.p.alive].max())
    kernels = all_kernels()

    def zero():
        for k in kernels:
            k.launches = 0

    def launched():
        return {k.name: k.launches for k in kernels if k.launches}

    def gates(d, what):
        assert int(d["nf_truncated"]) == 0, f"{what}: FMM truncation"
        assert np.isfinite(d["dt"]), f"{what}: dt {d['dt']}"

    def step_diag(d):
        return {k: float(getattr(d, k)) for k in (
            "dt", "etot", "ecin", "eint", "egrav", "max_cell_count",
            "nf_truncated", "h_max")}

    out = {}
    # resident
    torch.cuda.reset_peak_memory_stats()
    bind, rstep = make_ve_step_tiered_resident(box, tiers, cfg,
                                               device=DEVICE)
    c = bind(state)
    c, d0, w_ms = tier_steps(rstep, c, 1, lambda d: d)
    if replan:
        tier_replan(report, box, cfg, c.state, d0[0], h_max0)
    zero()
    c, diags, ms = tier_steps(rstep, c, 3, step_diag)
    launches = launched()
    assert launches == {k: 3 * nt for k in _TIER_STAGES}, launches
    for d in diags:
        gates(d, "resident")
    drift = abs(diags[-1]["etot"] - e0) / abs(e0)
    assert drift < CLI_DRIFT_BOUND, f"resident: energy drift {drift:.3e}"
    for f in ("x", "y", "z", "h", "vx", "vy", "vz", "temp", "alpha"):
        assert torch.isfinite(getattr(c.state.p, f)).all(), f"non-finite {f}"
    res = dict(warmup_ms=w_ms[0], step_ms=ms, mean_ms=float(np.mean(ms)),
               rebuilds=int(c.rebuilds), diags=diags, e0=e0,
               energy_drift=drift,
               peak_bytes=torch.cuda.max_memory_allocated(),
               launches=launches,
               folds=[int(d["max_cell_count"]) for d in diags])
    log(f"  resident: {res['mean_ms']:.3f} ms a step (CUDA events, "
        f"{[round(t, 3) for t in ms]} after a {w_ms[0]:.3f} ms warm-up), "
        f"in-step rebuilds {res['rebuilds']}, folds {res['folds']}, "
        f"nf_truncated 0, |etot - e0|/|e0| = {drift:.3e}, peak "
        f"{res['peak_bytes'] / 2 ** 30:.3f} GiB, launches {launches}")
    out["resident"] = res
    r = dict(made=[(box, cfg, tiers)], state=c.state)
    engines, layouts = tier_split(report, r, res)
    del bind, rstep

    # the particle-frame step
    step = make_ve_step_tiered(box, tiers, cfg, device=DEVICE)
    st, _, w_ms = tier_steps(step, state, 1, lambda d: d)
    zero()
    st, diags, ms = tier_steps(step, st, 2, step_diag)
    launches = launched()
    assert launches == {k: 2 * nt for k in _TIER_STAGES}, launches
    for d in diags:
        gates(d, "ve-tiered")
    out["particle"] = dict(warmup_ms=w_ms[0], step_ms=ms,
                           mean_ms=float(np.mean(ms)), diags=diags,
                           folds=[int(d["max_cell_count"]) for d in diags],
                           launches=launches)
    log(f"  particle-frame step: {out['particle']['mean_ms']:.3f} ms a "
        f"step ({[round(t, 3) for t in ms]} after {w_ms[0]:.3f}), folds "
        f"{out['particle']['folds']}, launches {launches}")
    del st, step

    # block time-steps
    teng = TieredBdtVE(box, tiers, cfg, num_rungs=4, device=DEVICE)
    bst = teng.bind(state)
    zero()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    bst, bd = teng.run_cycle(bst, check=False)
    b.record()
    torch.cuda.synchronize()
    launches = launched()
    nsub = len(bd)
    want = {k + "_gated": nsub * nt for k in _TIER_STAGES}
    want["pair_gate"] = 5 * nsub * nt
    assert launches == want, (launches, want)
    cyc = a.elapsed_time(b)
    for x in bd:
        assert int(x.nf_truncated) == 0, "BDT: FMM truncation"
    for f in ("x", "y", "z", "h", "vx", "vy", "vz", "temp", "alpha"):
        assert torch.isfinite(getattr(bst.p, f)).all(), f"non-finite {f}"
    drift = abs(float(bd[-1].etot) - e0) / abs(e0)
    assert drift < CLI_DRIFT_BOUND, f"BDT: energy drift {drift:.3e}"
    out["bdt"] = dict(
        cycle_ms=cyc, substep_ms=cyc / nsub, energy_drift=drift,
        active_frac=[float(x.active_frac) for x in bd],
        rung_hist=[x.rung_hist.tolist() for x in bd],
        fold=[int(x.fold) for x in bd],
        fold_parts=[x.fold_parts.tolist() for x in bd], launches=launches)
    log(f"  TieredBdtVE, 4 rungs: {cyc:.3f} ms a cycle ({cyc / nsub:.3f} "
        f"ms a substep), active fraction "
        f"{[round(v, 4) for v in out['bdt']['active_frac']]}, rungs "
        f"{out['bdt']['rung_hist'][-1]}, fold {out['bdt']['fold']} (parts "
        f"of the last {out['bdt']['fold_parts'][-1]}), |etot - e0|/|e0| = "
        f"{drift:.3e}")
    del teng, bst
    report["tier_engines"] = out
    return r, engines, layouts


def tier_split(report, r, res):
    """(o) 2: the parts of a tiered step, each timed alone on the run's
    last state: the tiered SPH forces (every tier's five stages and the
    merges), gravity (the FMM on the alive rows) and the rest; beside
    phase (l)'s uniform resident step."""
    import torch
    from sphexa_tpu_torch.propagator.ve_cellmajor import _add_gravity
    from sphexa_tpu_torch.propagator.ve_tiered import (_build_layouts,
                                                       _tier_engines,
                                                       _tiered_forces)
    box, cfg, tiers = r["made"][-1]
    st = r["state"]
    ps = st.p
    engines = _tier_engines(tiers, cfg, DEVICE)
    layouts = _build_layouts(engines, box, ps)
    idx = torch.nonzero(ps.alive).reshape(-1)
    z = torch.zeros_like(ps.x)
    forces_ms = cuda_ms(lambda: _tiered_forces(ps, st.dt, layouts, engines,
                                               box, cfg), 2)
    layout_ms = cuda_ms(lambda: _build_layouts(engines, box, ps), 2)
    grav_ms = cuda_ms(lambda: _add_gravity(dict(ax=z, ay=z, az=z), ps.x,
                                           ps.y, ps.z, ps.m, idx, box, cfg),
                      2)
    rest = res["mean_ms"] - forces_ms - grav_ms
    split = dict(tiered_forces_ms=forces_ms, layouts_ms=layout_ms,
                 gravity_ms=grav_ms, rest_ms=rest,
                 uniform_step_ms=UNIFORM_STEP_MS,
                 uniform_hydro_ms=UNIFORM_HYDRO_MS)
    log(f"  split (each part alone on the last state): tiered SPH forces "
        f"{forces_ms:.3f} ms (every tier, merges included; the tier "
        f"layouts alone {layout_ms:.3f}), gravity {grav_ms:.3f}, rest "
        f"{rest:.3f}; phase (l)'s uniform resident step on this card "
        f"{UNIFORM_STEP_MS} ms, its hydro pipeline {UNIFORM_HYDRO_MS} ms")
    res["split"] = split
    return engines, layouts


def tier_pair_check(report, rows, r, engines, layouts):
    """(o) 4: K3-K7 on every tier frame at the inputs of one more tiered
    force pass on the resident run's last state: each launch against its
    plain version on sampled occupied cells (as evrard_pair_check), its
    invalid interior slots at their fill value, timed beside its bound
    from that tier's in-support pairs; then K2g (gate pass and the five
    gated stages) on the finest tier under a seeded activity pattern
    against its gated plain version (inactive supercells bit-equal to
    prev). Each tier's times go into the kernel rows (`tiers`,
    `tier_gated`)."""
    import types

    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv
    from sphexa_tpu_torch.propagator.ve_tiered import _tiered_forces

    box, cfg, tiers = r["made"][-1]
    st = r["state"]
    with Spy(pv.KERNELS) as spy:
        _tiered_forces(st.p, st.dt, layouts, engines, box, cfg)
    torch.cuda.synchronize()
    nt = len(engines)
    calls = [c for c in spy.calls if c[0].name != "ghost_refresh"]
    assert [c[0].name for c in calls] == [s for s in _TIER_STAGES
                                          for _ in range(nt)], \
        [c[0].name for c in calls]
    by_name = {x["name"]: x for x in rows}
    res = {}
    counts = {}
    for i, (k, args, out) in enumerate(calls):
        ti = i % nt
        J, I2, g, c = args
        e = engines[ti]
        assert g == e.spec.grid, (g, e.spec.grid)
        if k.name == "pair_xh":
            counts[ti] = pair_counts(
                J, types.SimpleNamespace(intmask=e.intmask), g, out[2] + 1)
        cand, inside, _ = counts[ti]
        cells = sample_occupied_cells(g, valid_slots(J), e.intmask,
                                      TIER_SAMPLE_CELLS, 100 + i)
        ref = pv._run_plain(k.body, J, I2, g, k.fo, cells=cells,
                            **k._body_kw(c))
        slots = torch.zeros(g.n_slots, dtype=torch.bool, device=DEVICE)
        lane = torch.arange(g.cap, device=DEVICE)
        slots[(cells[:, None] * g.cap + lane).reshape(-1)] = True
        err, rel = compare(k.name, ref, out, valid_slots(J) & slots
                           & e.intmask, per_row=False)
        nfill = check_fill(k, J, out, e.intmask)
        ms = cuda_ms(lambda: k._launch(J, I2, g, c), 3)
        nbytes = 4 * (J.numel() + (I2.numel() if I2 is not None else 0)
                      + out.numel())
        bound, by = pair_bound(cand * GEO_FLOPS + inside * BODY_FLOPS[k.name],
                               nbytes)
        row = dict(tier=ti, grid=str(g), cap=g.cap, ms=ms, bound_ms=bound,
                   bound_by=by, max_abs_err=err, max_rel_err=rel,
                   candidates=cand, in_support=inside, fill_slots=nfill,
                   cells=int(cells.numel()))
        res.setdefault(k.name, []).append(row)
        if k.name in by_name:
            by_name[k.name].setdefault("tiers", []).append(
                {q: row[q] for q in ("tier", "cap", "ms", "bound_ms",
                                     "bound_by", "max_abs_err")})
        log(f"  tier {ti} cap {g.cap} {k.name:14s} {ms:8.3f} ms  bound "
            f"{bound:.4f} ms ({by}); {cells.numel()} cells against plain: "
            f"err {err:.3e} (rel {rel:.3e}); {nfill} invalid interior "
            f"slots at fill; {inside:.4e} in-support pairs of {cand:.4e}")

    # K2g on the finest tier, under a seeded activity pattern
    ti = nt - 1
    e = engines[ti]
    g = e.spec.grid
    fine = [c for i, c in enumerate(calls) if i % nt == ti]
    act, kinds = activity_pattern(g, valid_slots(fine[0][1][0]),
                                  TIER_GATED_SEED)
    assert kinds["active"] > 0 and kinds["inactive"] > 0, kinds
    gate = pv.pair_gate
    n_gate = gate.launches
    rng = np.random.default_rng(TIER_GATED_SEED)
    gres = {}
    for k, (J, I2, _, c), out in fine:
        kg = next(x for x in pv.GATED_KERNELS if stage_of(x.name) == k.name)
        prev = torch.from_numpy(rng.normal(0, 1, (kg.fo, g.n_slots)).astype(
            np.float32)).to(DEVICE)
        args = (J, I2, g, c, (act, prev), 0)
        gout = kg._launch(*args)
        err, rel = gated_compare(kg, args, gout, e.intmask, per_row=False)
        ms = cuda_ms(lambda: kg._launch(*args), 3)
        cell_ms = cuda_ms(lambda: k._launch(J, I2, g, c), 3)
        gres[kg.name] = dict(ms=ms, cell_ms=cell_ms, max_abs_err=err,
                             max_rel_err=rel)
        if kg.name in by_name:
            by_name[kg.name]["tier_gated"] = dict(tier=ti, cap=g.cap, ms=ms,
                                                  cell_ms=cell_ms,
                                                  max_abs_err=err)
        log(f"  tier {ti} cap {g.cap} {kg.name:20s} {ms:8.3f} ms (the "
            f"ungated launch {cell_ms:.3f}); inactive supercells bit-equal "
            f"to prev, active err {err:.3e} (rel {rel:.3e})")
    assert gate.launches > n_gate, "the gate pass did not run"
    log(f"  tier {ti} activity (Z {pv.resolve_zgroup(g)}): {kinds}")
    report["tier_kernels"] = dict(stages=res, gated=gres, kinds=kinds)


def tier_phase(report, rows, replan=False):
    """Phase (o): the h-tier zoom grids on the card. replan: run the
    re-plan check of tier_engine_runs (`--tiers`)."""
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)

    def at():
        log(f"  {time.perf_counter() - t0:.1f} s into phase (o)")

    prop, steps = TIER_RUNS[0]
    log(f"(o) main([... --init evrard -n {TIER_SIDE} --prop {prop} ...]), "
        f"the FMM at level {EVRARD_LEVEL}:")
    _, tiers, plan_s = tier_cli_run(report, prop, steps)
    at()
    log(f"(o) its tier ladder for Evrard {TIER_SIDE} (choose_tiers_auto, "
        f"cap_max {TIER_CAP_MAX}):")
    state, box, cfg = tier_plan(report, tiers, plan_s)
    at()
    log(f"(o) the tiered engines at Evrard {TIER_SIDE} on that ladder, the "
        f"FMM at level {EVRARD_LEVEL}:")
    r, engines, layouts = tier_engine_runs(report, state, box, cfg, tiers,
                                           replan)
    at()
    log(f"(o) K3-K7 and K2g on the tier frames of Evrard {TIER_SIDE}:")
    tier_pair_check(report, rows, r, engines, layouts)
    del state, r, engines, layouts
    at()
    for prop, steps in TIER_RUNS[1:]:
        log(f"(o) main([... --init evrard -n {TIER_SIDE} --prop {prop} "
            f"...]), the FMM at level {EVRARD_LEVEL}:")
        tier_cli_run(report, prop, steps)
        at()
    log(f"(o) main([... --init sedov -n {TIER_SEDOV} --prop ve-tiered "
        f"...]):")
    tier_cli_run(report, "ve-tiered", TIER_SEDOV_STEPS, case="sedov",
                 n=TIER_SEDOV)
    report["tier_phase_seconds"] = time.perf_counter() - t0
    log(f"  phase (o): {report['tier_phase_seconds']:.1f} s")


# ---------------------------------------------------------------------------
# (q) multi-device through the command line: the Hilbert domain, sharded
# self-gravity and MultiChipAdapter, every shard a thread on the one card
# ---------------------------------------------------------------------------

MULTI_D = 2
MULTI_CHECK_SIDE = 10
# card against CPU through main at D = 2: (prop, case, steps or cycles)
MULTI_CHECK = (("ve-hilbert", "evrard", 2), ("ve-pallas-sharded", "sedov", 2),
               ("ve-bdt-sharded", "evrard", 1),
               ("turbulence-ve-bdt-sharded", "turbulence", 1),
               ("ve-tiered-sharded", "evrard", 2))
# the full-size runs through main at D = 2: (prop, case, n, steps)
# (ve-bdt-sharded: the second cycle runs on the plan of the h re-grid)
MULTI_RUNS = (("ve-bdt-sharded", "evrard", 100, 2),
              ("ve-hilbert", "evrard", 100, 2),
              ("ve-tiered-sharded", "evrard", 100, 2),
              ("ve-pallas-sharded", "sedov", 100, 2),
              ("turbulence-ve-bdt-sharded", "turbulence", 100, 1))
MULTI_D4 = ("ve-hilbert", "evrard", 50, 2)      # once at D = 4
MULTI_DT0 = "3e-5"
MULTI_FMM = dict(gravity_solver="fmm", fmm_level=EVRARD_LEVEL)
MULTI_SAMPLE_CELLS = 48
# the single-device (and earlier sharded) times these runs stand beside
# (PERF.md; NVIDIA H100 80GB HBM3, 700 W)
MULTI_BESIDE = {"ve-bdt-sharded": "BdtVE Evrard 100 8297.222 ms a cycle",
                "ve-tiered-sharded": "resident tiered step Evrard 100 "
                                     "1035.080-1042.685 ms",
                "ve-pallas-sharded": "sharded step Sedov 100^3 D = 2 "
                                     "54.129 ms",
                "turbulence-ve-bdt-sharded": "TurbShardedBdtVE 100^3 D = 2 "
                                             "509.739 ms a cycle",
                "ve-hilbert": "resident step Evrard 100 1053.812 ms"}
_GATED = {"pair_gate", "pair_xh_gated", "pair_gradh_gated",
          "pair_iad_gated", "pair_av_gated", "pair_momentum_gated"}
PROP_KERNELS["ve-pallas-sharded"] = (PROP_KERNELS["ve-pallas"]
                                     - {"ghost_refresh"}) | {"ghost_refresh_xy"}
PROP_KERNELS["ve-bdt-sharded"] = _GATED | {"ghost_refresh_xy"}
PROP_KERNELS["turbulence-ve-bdt-sharded"] = PROP_KERNELS["ve-bdt-sharded"]
PROP_KERNELS["ve-tiered-sharded"] = _GATED
PROP_KERNELS["ve-hilbert"] = set()


class _Env:
    """Environment variables set for a block, restored after."""

    def __init__(self, **kw):
        self.kw, self.old = kw, {}

    def __enter__(self):
        for k, v in self.kw.items():
            self.old[k] = os.environ.get(k)
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cpu_ref_main() -> int:
    """--cpu-ref PROP CASE N STEPS OUT: one CPU reference run of phase (q)
    1 in a process of its own (SPHEXA_PLATFORM=cpu, SPHEXA_NUM_DEVICES
    from the parent, one torch thread: the CPU references of phase (m)
    run on one thread), its final frame's alive rows and its constants
    rows saved to OUT (.npz)."""
    import contextlib
    import io

    import torch
    sys.path.insert(0, ROOT)
    from sphexa_tpu_torch import main as cli

    prop, case, n, steps, out = sys.argv[2:7]
    torch.set_num_threads(1)
    consts = out + ".txt"
    argv = ["--init", case, "-n", n, "-s", steps,
            "--prop", prop, "--constants", consts]
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        state = cli.main(argv)
    a = state.p.alive
    np.savez(out, rows=np.loadtxt(consts, ndmin=2),
             **{f: getattr(state.p, f)[a].numpy() for f in
                ("x", "y", "z", "vx", "h")})
    return 0


def cpu_refs_start():
    """The CPU references of phase (q) 1, one process a prop, started
    together (the card's runs go on meanwhile). Returns [(prop, process,
    path)]."""
    procs = []
    env = dict(os.environ, SPHEXA_PLATFORM="cpu",
               SPHEXA_NUM_DEVICES=str(MULTI_D), OMP_NUM_THREADS="1")
    for prop, case, steps in MULTI_CHECK:
        out = os.path.join(ROOT, "chiprun_out", f"multi_check_{prop}_cpu")
        for p in (out + ".npz", out + ".txt"):
            if os.path.exists(p):
                os.remove(p)
        procs.append((prop, subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--cpu-ref", prop, case, str(MULTI_CHECK_SIDE), str(steps),
             out], cwd=ROOT, env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True),
            out + ".npz"))
    return procs


def cpu_refs_stop(procs):
    """Kill whatever reference process still runs."""
    for _, p, _ in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def matched_rows(pa, b, fields):
    """The CPU reference's alive rows (a dict of numpy rows) and the
    card's concatenated shard frames matched by position (the shards
    migrate, so their order may differ): {field: max error over the
    field's scale}, and the largest position distance."""
    from scipy.spatial import cKDTree
    pa = {f: np.asarray(pa[f], np.float64) for f in ("x", "y", "z") + fields}
    pb = {f: getattr(b.p, f)[b.p.alive].cpu().double().numpy()
          for f in ("x", "y", "z") + fields}
    assert len(pa["x"]) == len(pb["x"]), (len(pa["x"]), len(pb["x"]))
    dist, j = cKDTree(np.c_[pa["x"], pa["y"], pa["z"]]).query(
        np.c_[pb["x"], pb["y"], pb["z"]])
    assert len(np.unique(j)) == len(j), "rows matched twice"
    return {f: float(np.abs(pb[f] - pa[f][j]).max()
                     / max(np.abs(pa[f]).max(), 1e-30)) for f in fields}, \
        float(dist.max())


def multi_check_card():
    """(q) 1, the card's side: each prop of MULTI_CHECK through main at
    MULTI_D shards here (main_in_process). Returns {prop: its record}."""
    gpu = {}
    with _Env(SPHEXA_NUM_DEVICES=MULTI_D):
        for prop, case, steps in MULTI_CHECK:
            argv = ["--init", case, "-n", str(MULTI_CHECK_SIDE), "-s",
                    str(steps), "--prop", prop]
            gpu[prop] = main_in_process(argv, os.path.join(
                ROOT, "chiprun_out", f"multi_check_{prop}_card.txt"))
    return gpu


def multi_check(report, procs, gpu):
    """(q) 1: each prop through main at MULTI_D shards, on the card
    (multi_check_card) and on the CPU (the kernels' plain versions) in
    the processes of cpu_refs_start, at Evrard, Sedov and turbulence
    10: the constants
    file's time and dt at rtol 1e-5, etot, eint and egrav at 1e-5, ecin
    at 1e-3; the final rows matched by position within 1e-5 of the box,
    vx and h within 2e-3 of scale (two steps of float32 rounding through
    migration, as phase (k) holds the sharded step against one card)."""
    out = {}
    for (prop, case, steps), (_, proc, path) in zip(MULTI_CHECK, procs):
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{prop} CPU reference: {err[-2000:]}"
        ref = np.load(path)
        crows, grows = ref["rows"], gpu[prop]["rows"]
        assert grows.shape == crows.shape, (grows.shape, crows.shape)
        for col, name, rtol in ((1, "time", 1e-5), (2, "dt", 1e-5),
                                (3, "etot", 1e-5), (5, "eint", 1e-5),
                                (6, "egrav", 1e-5)):
            np.testing.assert_allclose(grows[:, col], crows[:, col],
                                       rtol=rtol, atol=1e-12,
                                       err_msg=f"{prop} {name}")
        np.testing.assert_allclose(grows[:, 4], crows[:, 4], rtol=1e-3,
                                   atol=1e-12, err_msg=f"{prop} ecin")
        errs, dmax = matched_rows(ref, gpu[prop]["state"], ("vx", "h"))
        assert dmax < 1e-5, (prop, dmax)
        assert max(errs.values()) < 2e-3, (prop, errs)
        launches = gpu[prop]["launches"]
        assert set(launches) == PROP_KERNELS[prop], (prop, launches)
        out[prop] = dict(case=case, steps=steps, pos_err=dmax, errs=errs,
                         etot_card=grows[:, 3].tolist(),
                         etot_cpu=crows[:, 3].tolist(), launches=launches)
        log(f"  {prop} {case} {MULTI_CHECK_SIDE}: card vs CPU, {steps} "
            f"{'cycle' if 'bdt' in prop else 'step'}(s): etot "
            f"{grows[-1, 3]:.9g} vs {crows[-1, 3]:.9g}, rows matched "
            f"within {dmax:.2e}, vx/h err {errs}")
    report["multi_check"] = out


def evrard_l1(state, box, cfg):
    """bench.py's Evrard gate on a state: rho of one resident hydro pass
    against 1/(2 pi r), mean relative error over 0.05 < r < 0.9. The
    grid is choose_grid_with_hcap's (the coarsest whose cells fit the
    kernels' cap) with h clipped to the h_cap it supports: after the
    outer shell's h has grown, no grid with cells of 2 h_max fits the
    core's rows in one cap (the bench's Evrard path, the same clip)."""
    import torch
    from sphexa_tpu_torch.ops.cellmajor import choose_grid_with_hcap
    from sphexa_tpu_torch.ops.pair_ve import MAX_CAP
    from sphexa_tpu_torch.propagator.ve_cellmajor import (ResidentVE,
                                                          _run_pipeline)
    p = state.p
    a = p.alive
    _, grid, h_cap = choose_grid_with_hcap(
        box, int(a.sum()), *(getattr(p, c)[a].cpu().numpy() for c in "xyz"),
        cap_max=MAX_CAP)
    cfg = cfg.replace(gravG=0.0, h_cap=float(h_cap))
    state = state.replace(p=p.replace(h=torch.clamp_max(p.h, h_cap)))
    eng = ResidentVE(box, grid, cfg, device=DEVICE)
    rst = eng.bind(state)
    validint = rst.valid & eng.intmask
    out = _run_pipeline(eng.pve, eng.rf, [rst.x, rst.y, rst.z, rst.h,
                                          rst.gid], rst.m, rst.vx, rst.vy,
                        rst.vz, rst.temp, rst.alpha, rst.dt, validint)
    rho = out["rho"][validint].double()
    r = torch.sqrt(rst.x[validint].double() ** 2
                   + rst.y[validint].double() ** 2
                   + rst.z[validint].double() ** 2)
    sel = (r > 0.05) & (r < 0.9)
    ana = 1.0 / (2.0 * np.pi * r[sel].clamp_min(1e-6))
    return float(((rho[sel] - ana).abs() / ana).mean())


def gated_sample_check(kg, args, out, intmask, seed):
    """A K2g launch against its plain version on sampled cells of its
    active supercells (the plain body on those cells), its inactive
    supercells' interior slots bit-equal to prev, nothing outside the
    interior. Returns (max abs err, active and inactive supercells)."""
    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv

    J, I2, g, c, (act, prev), zg = args
    Z = pv.resolve_zgroup(g, zg)
    on = pv.supercell_active(act, g, Z).repeat_interleave(g.cap)
    keep = intmask & ~on
    if not torch.equal(out[:, keep], prev[:, keep]):
        raise AssertionError(f"{kg.name}: inactive supercells != prev")
    if out[:, ~intmask].any():
        raise AssertionError(f"{kg.name}: slots outside the interior != 0")
    cells = sample_occupied_cells(g, valid_slots(J) & on, intmask,
                                  MULTI_SAMPLE_CELLS, seed)
    ref = pv._run_plain(kg.body, J, I2, g, kg.fo, cells=cells,
                        **kg._body_kw(c))
    slots = torch.zeros(g.n_slots, dtype=torch.bool, device=J.device)
    lane = torch.arange(g.cap, device=J.device)
    slots[(cells[:, None] * g.cap + lane).reshape(-1)] = True
    err, _ = compare(kg.name, ref, out, valid_slots(J) & slots & intmask
                     & on, per_row=False)
    sc_on = int(pv.supercell_active(act, g, Z).sum()) // Z
    return err, sc_on


def multi_gated_calls(report, key, calls, intmasks):
    """Every recorded K2g launch held by gated_sample_check; the gate
    pass ran before each. Returns {stage: max abs err}."""
    errs, active = {}, []
    stages = [c for c in calls if c[0].name != "pair_gate"
              and c[0].name.endswith("_gated")]
    assert stages, f"{key}: no gated launch recorded"
    for i, (k, args, out) in enumerate(stages):
        err, on = gated_sample_check(k, args, out, intmasks[args[2]],
                                     300 + i)
        errs[k.name] = max(errs.get(k.name, 0.0), err)
        active.append(on)
    log(f"  {key}: {len(stages)} gated launches against plain on sampled "
        f"active cells, inactive supercells bit-equal to prev; max abs err "
        f"{errs}; active supercells a launch {min(active)}-{max(active)}")
    return errs


def multi_run(report, rows, prop, case, n, steps, D=MULTI_D):
    """(q) 2: main([...]) in this process at full size with D shards
    (main_in_process): the gates (the adapter's own fail-stops on lost,
    overflow and n_owned; no fail-stop after the first accepted step;
    the prop's kernels; rows finite; energy drift < CLI_DRIFT_BOUND but
    under stirring; Evrard: density L1 < EVRARD_L1_BOUND), ms a call
    beside the single-device runs, then the pair launches of one more
    call held against their plain versions."""
    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv
    from sphexa_tpu_torch.ops.cellmajor import interior_mask

    grav = case == "evrard"
    key = f"{prop} {case} {n} D={D}"
    consts = os.path.join(ROOT, "chiprun_out",
                          f"multi_{prop}_{case}{n}_D{D}.txt")
    argv = ["--init", case, "-n", str(n), "-s", str(steps), "--dt0",
            MULTI_DT0, "--prop", prop]
    t0 = time.perf_counter()
    with _Env(SPHEXA_NUM_DEVICES=D):
        r = main_in_process(argv, consts,
                            cfg_override=MULTI_FMM if grav else None,
                            energy=state_energy if grav else None)
    state, launches = r["state"], r["launches"]
    plans = [(g.n, g.cap, g.nzi) for _, _, g in r["made"]
             if hasattr(g, "cap")]
    if prop == "ve-bdt-sharded" and n == MULTI_RUNS[0][2]:
        # Evrard 100: the h re-grid after the first cycle plans anew,
        # and the second cycle runs on that plan, past cap 1024
        assert len(r["step_ms"]) == steps and len(plans) >= 2, \
            (key, r["step_ms"], plans)
        assert r["used"][-1] == len(plans) - 1 and plans[-1][1] > 1024, \
            (key, r["used"], plans)
    checks = [i for i, ln in enumerate(r["lines"])
              if ln.startswith("### Check")]
    assert not r["fails"] or not checks or max(r["fails"]) < checks[0], \
        f"{key}: a fail-stop after the first accepted step"
    assert set(launches) == PROP_KERNELS[prop], (key, launches)
    assert state.p.device.type == torch.device(DEVICE).type, \
        f"{key}: the state left the card"
    for f in ("x", "y", "z", "h", "vx", "vy", "vz", "temp", "alpha"):
        assert torch.isfinite(getattr(state.p, f)).all(), f"{key}: {f}"
    adapter = r["fns"][-1]
    box, cfg, grid = r["made"][-1]
    for d in r["diags"]:
        raw = d.raw
        for k in ("lost", "overflow", "fold"):
            assert int(getattr(raw, k, 0)) == 0, (key, k)
        if hasattr(raw, "n_owned"):
            # the tile diag's n_owned is the largest shard's, n_total
            # the sum
            assert int(getattr(raw, "n_total", raw.n_owned)) \
                == adapter.n_global, key
            assert bool(getattr(raw, "span_ok", True)), (key, "span_ok")
    etot = r["rows"][:, 3]
    drift = abs(float(etot[-1]) - r["e0"]) / abs(r["e0"])
    if case != "turbulence":
        assert drift < CLI_DRIFT_BOUND, f"{key}: energy drift {drift:.3e}"
    else:
        assert float(r["rows"][-1, 4]) > 0, f"{key}: no kinetic energy"
    res = dict(n=int(state.p.alive.sum()), steps=steps, D=adapter.D,
               call_ms=r["call_ms"], step_ms=r["step_ms"],
               mean_ms=float(np.mean(r["step_ms"])),
               fail_stops=len(r["fails"]),
               fail_stop_lines=[r["lines"][i] for i in r["fails"]],
               wall_s=r["wall"], peak_bytes=r["peak"], e0=r["e0"],
               etot=etot.tolist(), energy_drift=drift, launches=launches,
               grid=str(grid), beside=MULTI_BESIDE.get(prop),
               lines=[ln for ln in r["lines"] if ln.startswith(
                   ("# multichip", "# gravity band_cap", "# tiers",
                    "# bdt", "# multichip: shrunk"))],
               plans=plans, h_max=[h for _, h in r["tried"]])
    if hasattr(adapter, "hc"):
        res["hc"] = dataclasses.asdict(adapter.hc)
        res["imbalance"] = [float(d.raw.imbalance) for d in r["diags"]]
    if hasattr(adapter, "sc"):
        res["sc"] = dataclasses.asdict(adapter.sc)
    res["gravity_band_cap"] = adapter.cfg.gravity_band_cap
    if grav:
        res["density_l1"] = evrard_l1(state, box, cfg)
        assert res["density_l1"] < EVRARD_L1_BOUND, (key, res["density_l1"])

    # the pair launches of one more call, held against plain
    by_name = {x["name"]: x for x in rows}
    errs = {}
    if prop == "ve-pallas-sharded":
        with Spy(pv.KERNELS[1:]) as spy:
            adapter(state)
        torch.cuda.synchronize()
        errs = sharded_pair_check(adapter.grid, spy.calls)
    elif prop in ("ve-bdt-sharded", "turbulence-ve-bdt-sharded"):
        # substep 1 of a cycle: the rungs > 0 sit out (substep 0 is all
        # active at a cycle start)
        bdt = adapter.bdt
        ph, bsts = None, adapter.bst
        if bdt.turb is not None:
            # the lattice at rest makes every stage's output a cancelling
            # sum of rounding noise, so the check frame is the run's
            # state perturbed as phase (n)'s (TURB_CHECK_SEED), on the
            # run's engine and grid, stirred with the OU state's current
            # phases as run_cycle hands them to a substep
            bsts, lost = bdt.resync(bdt.distribute_bind(
                perturbed(state, TURB_CHECK_SEED)))
            assert int(lost) == 0, f"{key}: the check frame lost rows"
            ph = bdt.turb.device_phases([e.device for e in bdt.shards])
        bsts, d0 = bdt.substep(bsts, ph)
        with Spy(pv.GATED_KERNELS) as spy:
            _, d1 = bdt.substep(bsts, ph)
        torch.cuda.synchronize()
        assert int(d0.overflow) == int(d1.overflow) == 0, key
        g = bdt.grid
        errs = multi_gated_calls(report, key, spy.calls,
                                 {g: interior_mask(g, DEVICE)})
    elif prop == "ve-tiered-sharded":
        with Spy(pv.GATED_KERNELS) as spy:
            adapter(state)
        torch.cuda.synchronize()
        masks = {t.grid: interior_mask(t.grid, DEVICE) for t in adapter.grid}
        errs = multi_gated_calls(report, key, spy.calls, masks)
    for k, e in errs.items():
        res.setdefault("pair_errs", {})[k] = e
        if k in by_name:
            by_name[k].setdefault("multi", {})[prop] = e
    per = "cycle" if "bdt" in prop else "step"
    log(f"  {key}: {res['mean_ms']:.3f} ms a {per} (CUDA events; all calls "
        f"{[round(t, 3) for t in r['call_ms']]}), beside {res['beside']}; "
        f"{r['wall']:.1f} s of main, peak {r['peak'] / 2 ** 30:.3f} GiB, "
        f"fail-stops {len(r['fails'])} (before the first step), "
        f"|etot - e0|/|e0| = {drift:.3e}"
        + (f", density L1 {res['density_l1']:.4f}" if grav else "")
        + f", grid {grid}, band_cap {res['gravity_band_cap']}, launches "
          f"{launches}; {time.perf_counter() - t0:.1f} s in all")
    if plans:
        log(f"    plans (n, cap, nzi) {plans} at h_max "
            f"{[round(h, 5) for h in res['h_max']]}")
    for ln in res["lines"]:
        log(f"    {ln}")
    report.setdefault("multi_runs", {})[key] = res
    return r, res


def multi_bdt_rungs(report, r):
    """(q) 3: the first cycle's rung histograms of the ve-bdt-sharded run
    against BdtVE's on the same initial state and the same global grid
    (n x n x D nz; the JAX dry run's leg 3 asserts the same), substep by
    substep."""
    import torch
    from sphexa_tpu_torch.ops.cellmajor import CMGrid
    from sphexa_tpu_torch.init.evrard import init_evrard
    from sphexa_tpu_torch.propagator.ve_bdt import BdtVE

    adapter = r["fns"][0]
    box, cfg, g = r["made"][0]
    diags = r["diags"][0].diags
    state, _, _ = init_evrard(MULTI_RUNS[0][2], cfg, dt0=float(MULTI_DT0),
                              device=DEVICE)
    grid = CMGrid(n=g.n, cap=g.cap, nzi=adapter.D * g.nz)
    eng = BdtVE(box, grid, cfg, num_rungs=adapter.bdt.num_rungs,
                device=DEVICE)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    bst = eng.bind_bdt(state)
    a.record()
    _, ones = eng.run_cycle(bst)
    b.record()
    torch.cuda.synchronize()
    h1 = [x.rung_hist.cpu().tolist() for x in ones]
    hN = [x.rung_hist.cpu().tolist() for x in diags]
    assert h1 == hN, f"rung histograms: one card {h1} vs shards {hN}"
    log(f"  ve-bdt-sharded first cycle rung histograms equal BdtVE's on "
        f"{grid}: {hN[0]} ... {hN[-1]}; BdtVE {a.elapsed_time(b):.3f} ms "
        f"a cycle there")
    report["multi_bdt_rungs"] = dict(grid=str(grid), hist=hN,
                                     bdt_cycle_ms=a.elapsed_time(b))


def multi_phase(report, rows):
    """Phase (q): multi-device through the command line on the card."""
    from sphexa_tpu_torch.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    # the CPU references run in processes of their own beside the card
    procs = cpu_refs_start()
    try:
        log(f"(q) the multi-device props through main on the card, D = "
            f"{MULTI_D} (held against the CPU after the full-size runs):")
        gpu = multi_check_card()
        log(f"  {time.perf_counter() - t0:.1f} s into phase (q)")
        for prop, case, n, steps in MULTI_RUNS:
            log(f"(q) main([... --prop {prop} ...]) at {case} {n}, "
                f"D = {MULTI_D}:")
            r, _ = multi_run(report, rows, prop, case, n, steps)
            if prop == "ve-bdt-sharded":
                multi_bdt_rungs(report, r)
            del r
            log(f"  {time.perf_counter() - t0:.1f} s into phase (q)")
        log(f"(q) the card against the CPU at {MULTI_CHECK_SIDE}:")
        multi_check(report, procs, gpu)
    finally:
        cpu_refs_stop(procs)
    log(f"  {time.perf_counter() - t0:.1f} s into phase (q)")
    prop, case, n, steps = MULTI_D4
    log(f"(q) main([... --prop {prop} ...]) at {case} {n}, D = 4:")
    multi_run(report, rows, prop, case, n, steps, D=4)
    log("(q) dryrun_multichip(4) on the card:")
    report["multi_dryrun"] = dryrun_multichip(4, device=DEVICE)
    report["multi_phase_seconds"] = time.perf_counter() - t0
    log(f"  phase (q): {report['multi_phase_seconds']:.1f} s")


# ---------------------------------------------------------------------------
# (r) the last multi-device engines: 2-D tiles, column ranges and the slab
#     gather engine
# ---------------------------------------------------------------------------

DOM_CHECK_SIDE = 10         # card against CPU
DOM_CHECK_STEPS = 2
DOM_SIDE = 100              # the full-width runs
DOM_STEPS = 2               # the slab gather engine: 1 (~23 s a step)
DOM_TILES_D = 4             # 2 x 2 tiles (x and z windowed)
DOM_ENGINE_D = 2            # the column and slab gather engines
# main([... --prop ve-pallas-tiles ...]) at D = 4: (case, n, steps)
DOM_TILE_RUNS = (("evrard", 100, 2), ("sedov", 100, 2))
DOM_SAMPLE_CELLS = 48
# the runs these stand beside (PERF.md; NVIDIA H100 80GB HBM3, 700 W)
DOM_BESIDE = {"evrard": "ve-hilbert Evrard 100 D = 2 11826.537 ms a step; "
                        "resident step 1053.812",
              "sedov": "ve-pallas-sharded Sedov 100^3 D = 4 136.199 ms",
              "column": "ve-pallas-sharded Sedov 100^3 D = 2 54.129 ms; "
                        "resident step 17.785",
              "slab": "main --prop ve Sedov 100^3 (one card) 4841.296 ms"}
PROP_KERNELS["ve-pallas-tiles"] = PROP_KERNELS["ve-pallas"] - {
    "ghost_refresh"}
FAIL_STOPS += ("# tile windows outgrown",)


def dom_engine(engine, side, device):
    """One of the three engines at Sedov side^3 on the shards of
    `device`: 'tiles' (make_ve_step_pallas_tiles on DOM_TILES_D shards,
    sized by plan_tile_domain as the command line's adapter sizes it),
    'column' (make_ve_step_pallas_hilbert) or 'slab'
    (make_ve_step_sharded, the gather path), both on DOM_ENGINE_D. The
    column engine's slot grid is choose_cap_and_grid's at 1.05 h_max
    (the window and band caps from the measured counts); the gather
    grid is choose_level's at 1.4 h_max with cell_cap from the measured
    densest cell. Returns (step, states, host state, box, cfg, info)."""
    import torch
    from sphexa_tpu_torch.config import SphConfig
    from sphexa_tpu_torch.domain.mesh import SlabMesh
    from sphexa_tpu_torch.init.sedov import init_sedov
    from sphexa_tpu_torch.ops.cellmajor import CMGrid, choose_cap_and_grid
    from sphexa_tpu_torch.propagator import ve_pallas_hilbert as vc
    from sphexa_tpu_torch.propagator import ve_pallas_tiles as vt
    from sphexa_tpu_torch.propagator.ve_sharded import round_up
    from sphexa_tpu_torch.state import _FIELDS, SimState

    D = DOM_TILES_D if engine == "tiles" else DOM_ENGINE_D
    state, box, cfg = init_sedov(side, SphConfig(), dt0=3e-5, device="cpu")
    host = {f: getattr(state.p, f).numpy() for f in _FIELDS[:-1]}
    n = side ** 3
    n_per = n / D
    h_max = float(host["h"].max())
    mesh = SlabMesh(D, devices=[device])
    info = dict(engine=engine, side=side, D=D)
    if engine == "tiles":
        grid, td = vt.plan_tile_domain(box, host, h_max, n, D)
        info["grid"] = str(grid)
        step = vt.make_ve_step_pallas_tiles(box, td, grid.cap, cfg, mesh)
        parts = vt.distribute_tiles(host, box, td, mesh)
        info["domain"] = dataclasses.asdict(td)
        info["local"] = str(CMGrid(n=grid.n, cap=grid.cap, nxi=td.rows_cap,
                                   nzi=td.zcols_cap))
    elif engine == "column":
        _, grid = choose_cap_and_grid(box, h_max * 1.05, n, host["x"],
                                      host["y"], host["z"], headroom=16)
        info["grid"] = str(grid)
        band = int(n * (grid.n + 1) / grid.n ** 2)
        cd = vc.ColDomain(
            n_ranks=D, n=grid.n, cap=round_up(int(n_per * 1.5) + 256, 8),
            halo_cap=round_up(int(band * 1.5) + 256, 8),
            mig_cap=round_up(max(int(n_per * 0.25), 128), 8))
        step = vc.make_ve_step_pallas_hilbert(box, cd, grid.cap, cfg, mesh)
        parts = vc.distribute_columns(host, box, cd, mesh)
        info["domain"] = dataclasses.asdict(cd)
        info["local"] = str(CMGrid(n=grid.n, cap=grid.cap, nxi=cd.rows))
    else:
        from sphexa_tpu_torch.neighbors import CellGrid, choose_level
        from sphexa_tpu_torch.propagator.ve_sharded import (
            distribute, make_ve_step_sharded, plan_slab)
        level = choose_level(box, h_max * 1.4)
        nn = 1 << level
        g = [np.clip(((host[c] - lo) / ln * nn).astype(np.int64), 0, nn - 1)
             for c, lo, ln in (("x", box.xmin, box.lx),
                               ("y", box.ymin, box.ly),
                               ("z", box.zmin, box.lz))]
        occ = int(np.bincount((g[0] * nn + g[1]) * nn + g[2]).max())
        cfg = cfg.replace(cell_cap=round_up(int(occ * 1.3) + 8, 32),
                          ngpad=max(cfg.ngpad, 256))
        _, sc = plan_slab(host, box, h_max, D)
        step = make_ve_step_sharded(box, CellGrid(level), cfg, sc, mesh)
        parts = distribute(host, box, sc, mesh)
        info.update(level=level, cell_cap=cfg.cell_cap, ngpad=cfg.ngpad,
                    domain=dataclasses.asdict(sc))
    states = [SimState(p=p, ttot=torch.zeros((), device=p.device),
                       dt=state.dt.to(p.device),
                       dt_m1=state.dt_m1.to(p.device),
                       iteration=state.iteration.to(p.device))
              for p in parts]
    return step, states, state, box, cfg, info


def dom_gates(key, engine, d, n, cfg):
    """A call's diagnostics: lost and overflow 0, the windows held
    (span_ok / row_span_ok), every particle owned; the gather step's
    densest cell and neighbour count within its caps."""
    assert int(d.lost) == 0, (key, "lost", int(d.lost))
    assert int(getattr(d, "overflow", 0)) == 0, (key, "overflow")
    assert bool(getattr(d, "span_ok", True)), (key, "span_ok")
    assert bool(getattr(d, "row_span_ok", True)), (key, "row_span_ok")
    assert int(getattr(d, "n_total", d.n_owned)) == n, (key, "n_total")
    if engine == "slab":
        assert int(d.max_cell_count) <= cfg.cell_cap, (key, "cell_cap")
        assert int(d.max_nc) <= cfg.ngpad, (key, "ngpad")
        assert float(d.halo_frac) < 1.0, (key, "halo_frac")


def dom_engine_run(engine, side, steps, device, spy_last=False):
    """`steps` calls of dom_engine's step (each between CUDA events on
    the card, the kernels' launch counts zeroed just before the first
    and read after the last), gated by dom_gates; with spy_last, one
    more call with every pair launch recorded. Returns its record."""
    import torch
    from sphexa_tpu_torch.observables import conserved_quantities
    from sphexa_tpu_torch.ops import pair_ve as pv

    step, states, state0, box, cfg, info = dom_engine(engine, side, device)
    n = side ** 3
    e0 = float(conserved_quantities(state0.p, cfg).etot)
    cuda = torch.device(device).type == "cuda"
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    call_ms, diags = [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        else:
            h0 = time.perf_counter()
        states, d = step(states)
        if cuda:
            ev[1].record()
            torch.cuda.synchronize()
            call_ms.append(ev[0].elapsed_time(ev[1]))
        else:
            call_ms.append((time.perf_counter() - h0) * 1e3)
        dom_gates(f"{engine} {side}", engine, d, n, cfg)
        diags.append({k: float(v) for k, v in d._asdict().items()})
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels if k.launches}
    rows = {f: torch.cat([getattr(s.p, f)[s.p.alive] for s in states])
            .cpu().numpy() for f in ("x", "y", "z", "vx", "h", "temp")}
    for f, v in rows.items():
        assert np.isfinite(v).all(), (engine, side, f)
    rec = dict(info=info, call_ms=call_ms, diags=diags, e0=e0, rows=rows,
               launches=launches, wall=wall,
               peak=torch.cuda.max_memory_allocated() if cuda else 0)
    if spy_last:
        with Spy(pv.KERNELS[1:]) as spy:
            states, d = step(states)
        torch.cuda.synchronize()
        rec["calls"] = spy.calls
    return rec


def dom_cpu_ref_main() -> int:
    """--cpu-ref-dom ENGINE STEPS OUT: phase (r) 1's CPU reference of one
    engine at Sedov DOM_CHECK_SIDE^3, in a process of its own (two torch
    threads): its final alive rows and its diagnostics to OUT (.npz)."""
    import torch
    sys.path.insert(0, ROOT)
    engine, steps, out = sys.argv[2:5]
    torch.set_num_threads(2)
    rec = dom_engine_run(engine, DOM_CHECK_SIDE, int(steps), "cpu")
    np.savez(out, **rec["rows"], **{
        k: np.array([d[k] for d in rec["diags"]]) for k in rec["diags"][0]})
    return 0


def dom_refs_start():
    """The CPU references of phase (r) 1, one process an engine, started
    together (the card's runs go on meanwhile). Returns [(engine,
    process, path)]."""
    procs = []
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    env = dict(os.environ, SPHEXA_PLATFORM="cpu", OMP_NUM_THREADS="2")
    for engine in ("tiles", "column", "slab"):
        out = os.path.join(ROOT, "chiprun_out", f"dom_check_{engine}_cpu")
        if os.path.exists(out + ".npz"):
            os.remove(out + ".npz")
        procs.append((engine, subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--cpu-ref-dom", engine, str(DOM_CHECK_STEPS), out], cwd=ROOT,
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True), out + ".npz"))
    return procs


def dom_check(report, procs, card):
    """(r) 1: each engine at Sedov DOM_CHECK_SIDE^3 on the card
    (dom_engine_run) against the CPU (the kernels' plain versions) in
    the processes of dom_refs_start: dt and ttot at rtol 1e-5, etot and
    eint at 1e-5, ecin at 1e-3, the integer diagnostics equal; the final
    rows matched by position within 1e-5 of the box, vx, h and temp
    within 2e-3 of their scale (as phase (q) holds the CLI's sharded
    props)."""
    from scipy.spatial import cKDTree
    out = {}
    for engine, proc, path in procs:
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, f"{engine} CPU reference: {err[-2000:]}"
        ref = np.load(path)
        g = card[engine]
        for k in ("dt", "ttot", "etot", "eint"):
            np.testing.assert_allclose([d[k] for d in g["diags"]], ref[k],
                                       rtol=1e-5, err_msg=f"{engine} {k}")
        np.testing.assert_allclose([d["ecin"] for d in g["diags"]],
                                   ref["ecin"], rtol=1e-3,
                                   err_msg=f"{engine} ecin")
        for k in ("lost", "n_owned", "overflow"):
            if k in ref:
                assert [d[k] for d in g["diags"]] == ref[k].tolist(), \
                    (engine, k)
        a, b = ref, g["rows"]
        assert len(a["x"]) == len(b["x"]), engine
        dist, j = cKDTree(np.c_[a["x"], a["y"], a["z"]]).query(
            np.c_[b["x"], b["y"], b["z"]])
        assert len(np.unique(j)) == len(j), f"{engine}: rows matched twice"
        errs = {f: float(np.abs(b[f] - a[f][j]).max()
                         / max(np.abs(a[f]).max(), 1e-30))
                for f in ("vx", "h", "temp")}
        assert dist.max() < 1e-5 and max(errs.values()) < 2e-3, \
            (engine, float(dist.max()), errs)
        out[engine] = dict(info=g["info"], pos_err=float(dist.max()),
                           errs=errs, launches=g["launches"],
                           etot_card=[d["etot"] for d in g["diags"]],
                           etot_cpu=ref["etot"].tolist())
        log(f"  {engine} Sedov {DOM_CHECK_SIDE}^3 D = {g['info']['D']}: "
            f"card vs CPU, {DOM_CHECK_STEPS} steps: etot "
            f"{g['diags'][-1]['etot']:.9g} vs {ref['etot'][-1]:.9g}, rows "
            f"matched within {dist.max():.2e}, {errs}; launches "
            f"{g['launches']}")
    report["dom_check"] = out


def dom_pair_check(report, rows, key, frame, calls, intmasks):
    """(r) 3: every K3-K7 launch of one more tile or column call against
    its plain version on sampled occupied cells, its invalid interior
    slots at their fill value, timed (CUDA events) beside its bound from
    that shard's in-support pairs; into the kernel rows under `frame`
    ('tiles' or 'columns'). Returns {stage: max abs err}."""
    import types

    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv

    by_name = {x["name"]: x for x in rows}
    stages = [c for c in calls if c[0].name in PROP_KERNELS["ve-pallas"]]
    assert stages, f"{key}: no pair launch recorded"
    errs, counts, timed = {}, {}, {}
    for i, (k, args, out) in enumerate(stages):
        J, I2, g, c = args
        im = intmasks[g]
        shard = sum(1 for x in stages[:i] if x[0].name == k.name)
        if k.name == "pair_xh":
            counts[shard] = pair_counts(J, types.SimpleNamespace(intmask=im),
                                        g, out[2] + 1)
        cand, inside, _ = counts[shard]
        cells = sample_occupied_cells(g, valid_slots(J), im,
                                      DOM_SAMPLE_CELLS, 500 + i)
        ref = pv._run_plain(k.body, J, I2, g, k.fo, cells=cells,
                            **k._body_kw(c))
        slots = torch.zeros(g.n_slots, dtype=torch.bool, device=DEVICE)
        lane = torch.arange(g.cap, device=DEVICE)
        slots[(cells[:, None] * g.cap + lane).reshape(-1)] = True
        err, rel = compare(k.name, ref, out, valid_slots(J) & slots & im,
                           per_row=False)
        check_fill(k, J, out, im)
        errs[k.name] = max(errs.get(k.name, 0.0), err)
        ms = cuda_ms(lambda: k._launch(J, I2, g, c), 3)
        nbytes = 4 * (J.numel() + (I2.numel() if I2 is not None else 0)
                      + out.numel())
        bound, by = pair_bound(cand * GEO_FLOPS + inside * BODY_FLOPS[k.name],
                               nbytes)
        t = timed.setdefault(k.name, dict(ms=0.0, bound_ms=0.0,
                                          max_abs_err=0.0, launches=0))
        t["ms"] += ms
        t["bound_ms"] += bound
        t["max_abs_err"] = max(t["max_abs_err"], err)
        t["launches"] += 1
        log(f"  {key} shard {shard} {g} {k.name:14s} {ms:8.3f} ms  bound "
            f"{bound:.4f} ms ({by}); {cells.numel()} cells against plain: "
            f"err {err:.3e} (rel {rel:.3e}); {inside:.4e} in-support pairs "
            f"of {cand:.4e}")
    for name, t in timed.items():
        if name in by_name:
            by_name[name].setdefault(frame, []).append(dict(
                run=key, shards=t["launches"], ms=t["ms"],
                bound_ms=t["bound_ms"], max_abs_err=t["max_abs_err"]))
    report.setdefault("dom_kernels", {})[key] = timed
    return errs


def dom_tile_run(report, rows, case, n, steps):
    """(r) 2: main([... --prop ve-pallas-tiles ...]) at full size on
    DOM_TILES_D shards (main_in_process): multi_run's gates (the
    adapter's fail-stops on lost, overflow and n_total, and on span_ok
    as a re-plan; no fail-stop after the first accepted step; the
    prop's kernels; finite rows; the energy drift; Evrard's density
    L1), ms a call, the tiles' imbalance and peak memory; then every
    K3-K7 launch of one more call against plain and timed."""
    import torch
    from sphexa_tpu_torch.ops.cellmajor import interior_mask
    from sphexa_tpu_torch.ops import pair_ve as pv

    r, res = multi_run(report, rows, "ve-pallas-tiles", case, n, steps,
                       D=DOM_TILES_D)
    adapter = r["fns"][-1]
    key = f"ve-pallas-tiles {case} {n} D={DOM_TILES_D}"
    res["td"] = dataclasses.asdict(adapter.td)
    res["imbalance"] = [float(d.raw.imbalance) for d in r["diags"]]
    res["beside"] = DOM_BESIDE[case]
    log(f"  {key}: tiles {adapter.td}, imbalance {res['imbalance']}, "
        f"beside {res['beside']}")
    with Spy(pv.KERNELS[1:]) as spy:
        _, d = adapter(r["state"])
    torch.cuda.synchronize()
    assert bool(d.raw.span_ok) and int(d.raw.lost) == 0, key
    g = spy.calls[0][1][2]
    res["pair_errs"] = dom_pair_check(report, rows, key, "tiles", spy.calls,
                                      {g: interior_mask(g, DEVICE)})
    return res


def dom_phase(report, rows, procs):
    """Phase (r): the 2-D tile domain through main, the column-range and
    the slab gather engines, on the card; procs: dom_refs_start's CPU
    references (the whole script starts them before phase (l))."""
    import torch
    from sphexa_tpu_torch.ops.cellmajor import interior_mask

    t0 = time.perf_counter()
    try:
        log(f"(r) the three engines at Sedov {DOM_CHECK_SIDE}^3 on the card "
            f"(held against the CPU after the full-width runs):")
        card = {e: dom_engine_run(e, DOM_CHECK_SIDE, DOM_CHECK_STEPS, DEVICE)
                for e in ("tiles", "column", "slab")}
        for case, n, steps in DOM_TILE_RUNS:
            log(f"(r) main([... --prop ve-pallas-tiles ...]) at {case} {n}, "
                f"D = {DOM_TILES_D}:")
            dom_tile_run(report, rows, case, n, steps)
            log(f"  {time.perf_counter() - t0:.1f} s into phase (r)")
        for engine in ("column", "slab"):
            log(f"(r) the {engine} engine at Sedov {DOM_SIDE}^3, D = "
                f"{DOM_ENGINE_D}:")
            rec = dom_engine_run(engine, DOM_SIDE,
                                 DOM_STEPS if engine == "column" else 1,
                                 DEVICE, spy_last=engine == "column")
            key = f"{engine} Sedov {DOM_SIDE} D={DOM_ENGINE_D}"
            etot = [d["etot"] for d in rec["diags"]]
            drift = abs(etot[-1] - rec["e0"]) / abs(rec["e0"])
            assert drift < CLI_DRIFT_BOUND, f"{key}: energy drift {drift}"
            if engine == "column":
                assert set(rec["launches"]) == PROP_KERNELS[
                    "ve-pallas-tiles"], (key, rec["launches"])
            else:
                assert not rec["launches"], (key, rec["launches"])
            res = dict(info=rec["info"], call_ms=rec["call_ms"],
                       mean_ms=float(np.mean(rec["call_ms"])),
                       energy_drift=drift, peak_bytes=rec["peak"],
                       launches=rec["launches"], wall_s=rec["wall"],
                       imbalance=[d.get("imbalance") for d in rec["diags"]],
                       halo_frac=[d.get("halo_frac") for d in rec["diags"]],
                       beside=DOM_BESIDE[engine])
            if engine == "column":
                g = rec["calls"][0][1][2]
                res["pair_errs"] = dom_pair_check(
                    report, rows, key, "columns", rec["calls"],
                    {g: interior_mask(g, DEVICE)})
            report.setdefault("dom_runs", {})[key] = res
            log(f"  {key}: {rec['info']}; {res['mean_ms']:.3f} ms a step "
                f"(CUDA events; all calls "
                f"{[round(t, 3) for t in rec['call_ms']]}), beside "
                f"{res['beside']}; peak {rec['peak'] / 2 ** 30:.3f} GiB, "
                f"|etot - e0|/|e0| = {drift:.3e}, imbalance "
                f"{res['imbalance']}, launches {rec['launches']}")
            del rec
            torch.cuda.empty_cache()
            log(f"  {time.perf_counter() - t0:.1f} s into phase (r)")
        log(f"(r) the card against the CPU at Sedov {DOM_CHECK_SIDE}^3:")
        dom_check(report, procs, card)
    finally:
        cpu_refs_stop(procs)
    report["dom_phase_seconds"] = time.perf_counter() - t0
    log(f"  phase (r): {report['dom_phase_seconds']:.1f} s")


# ---------------------------------------------------------------------------
# (p) radiative cooling, the split restart, --profile and --viz-every
# ---------------------------------------------------------------------------

COOL_CHECK_SIDE = 10        # card against CPU (tests/test_torch_std_cooling.py)
COOL_SIDE = 100             # main --init evrard-cooling: 523,984 particles
COOL_STEPS = 2
# the FMM at level 7: the CLI grows the open box to +-1.29 after the
# first step (as the JAX CLI does), and at level 6 the densest leaf then
# holds more than leaf_cap 128 (nf_truncated 288 on the second step)
COOL_FMM = dict(gravity_solver="fmm", fmm_level=EVRARD_LEVEL + 1)
COOL_RISE_BOUND = 5e-3      # etot may fall (cooling), not rise past this
SPLIT_SIDE = 50             # Sedov 50^3 split S = 8: 1,000,000 particles
SPLIT_S = 8
SPLIT_STEPS = 2
PROFILE_SIDE = 100          # --profile --viz-every 1 at Sedov 100^3
PROFILE_STEPS = 2
# each ve-pallas kernel's row of the --profile table: a part of its
# demangled name as util/xprofile.short_name prints it
PROFILE_NAMES = {"ghost_refresh": "ghost_refresh_kernel",
                 "pair_xh": "cell_xh<false, false>",
                 "pair_gradh": "GradhStage, false, false>",
                 "pair_iad": "IadStage, false, false>",
                 "pair_av": "AvStage, false, false>",
                 "pair_momentum": "MomStage<false>, false, false>"}


def cool_check(report):
    """(p1) make_std_cooling_step on the card against the CPU at
    Evrard-cooling n = 10, 2 steps, without and with chemistry, under the
    direct sum and the FMM (level 4), set up as
    tests/test_torch_std_cooling.py sets it (chunk 512, cell_cap 256,
    ngpad 256, dt0 1e-4, grid level from 1.3 h_max): max_nc,
    max_cell_count and nf_truncated equal; dt, etot, eint, ecin, egrav
    at rtol 1e-5; rows and chemistry within 1e-4 of their scale. The CPU
    reference on one thread."""
    import torch
    from sphexa_tpu_torch.config import SphConfig
    from sphexa_tpu_torch.init.evrard_cooling import init_evrard_cooling
    from sphexa_tpu_torch.neighbors import CellGrid, choose_level
    from sphexa_tpu_torch.physics.chemistry import FIELDS as CHEM
    from sphexa_tpu_torch.propagator.std_cooling import make_std_cooling_step
    from sphexa_tpu_torch.state import _FIELDS

    keys = ("dt", "etot", "eint", "ecin", "egrav", "max_nc",
            "max_cell_count", "nf_truncated")
    threads = torch.get_num_threads()
    out = {}
    for solver in ("direct", "fmm"):
        for chem in (False, True):
            runs = {}
            for dev in (DEVICE, "cpu"):
                torch.set_num_threads(1 if dev == "cpu" else threads)
                cfg = SphConfig(chunk=512, cell_cap=256, ngpad=256,
                                gravity_solver=solver)
                st, box, cfg, ex = init_evrard_cooling(
                    COOL_CHECK_SIDE, cfg, dt0=1e-4, device=dev)
                grid = CellGrid(choose_level(box, float(st.p.h.max()) * 1.3))
                step = make_std_cooling_step(
                    box, grid, cfg, params=ex["cooling_params"],
                    with_chemistry=chem, device=dev)
                c = ex["chem"]
                ds = []
                for _ in range(2):
                    if chem:
                        st, d, c = step(st, c)
                    else:
                        st, d = step(st)
                    ds.append({k: float(getattr(d, k)) for k in keys})
                runs[dev] = (ds, st, c)
            torch.set_num_threads(threads)
            (a, sa, ca), (b, sb, cb) = runs["cpu"], runs[DEVICE]
            for x, y in zip(a, b):
                for k in ("max_nc", "max_cell_count", "nf_truncated"):
                    assert y[k] == x[k], (solver, chem, k, y[k], x[k])
                for k in ("dt", "etot", "eint", "ecin", "egrav"):
                    np.testing.assert_allclose(y[k], x[k], rtol=1e-5,
                                               err_msg=f"{solver} {k}")
                assert y["egrav"] < 0
            err = rows_close(f"std-cooling {solver}",
                             [getattr(sb.p, f) for f in _FIELDS[:-1]],
                             [getattr(sa.p, f) for f in _FIELDS[:-1]], 1e-4)
            if chem:
                err = max(err, rows_close(
                    f"chemistry {solver}", [getattr(cb, f) for f in CHEM],
                    [getattr(ca, f) for f in CHEM], 1e-4))
            key = f"{solver}{' chem' if chem else ''}"
            log(f"  Evrard-cooling {COOL_CHECK_SIDE} {key}: {DEVICE} vs "
                f"cpu, 2 steps on level {grid.level}: dt {b[-1]['dt']:.6e} "
                f"vs {a[-1]['dt']:.6e}, egrav {b[-1]['egrav']:.6f} vs "
                f"{a[-1]['egrav']:.6f}, rows{' and chemistry' if chem else ''}"
                f" within {err:.3e} of scale")
            out[key] = dict(card=b, cpu=a, worst_row_err=err)
    report["cool_check_10"] = out


def chem_gates(chem, alive):
    """Every species fraction in [0, 1] on the alive rows, each
    element's fractions summing to 1 within 1e-6. Returns the largest
    distance of a sum from 1."""
    import torch
    fr = {f: getattr(chem, f)[alive].double()
          for f in ("x_HI", "x_HII", "x_HeI", "x_HeII", "x_HeIII")}
    for f, v in fr.items():
        assert bool(((v >= 0) & (v <= 1)).all()), f"chemistry {f} out of [0, 1]"
    off = max(float((fr["x_HI"] + fr["x_HII"] - 1).abs().max()),
              float((fr["x_HeI"] + fr["x_HeII"] + fr["x_HeIII"] - 1)
                    .abs().max()))
    assert off <= 1e-6, f"chemistry fractions sum off 1 by {off:.3e}"
    assert bool(torch.isfinite(chem.x_e[alive]).all())
    return off


def cool_cli_run(report):
    """(p2) main([...]) at --init evrard-cooling -n 100 (523,984
    particles; the FMM at level 7 set on the steppers it makes, see
    COOL_FMM), 2 accepted steps and an ASCII dump (checked, then
    removed: ~66 MB). Records ms a call,
    which of the hydro dt and dt_cool binds each step (the step's
    cooling_timestep, recorded), the temperature range, the fail-stops
    and re-grids. Gates: rows finite, the chemistry's fractions in
    [0, 1] summing to 1, temp >= t_floor / temp_to_k, egrav < 0,
    nf_truncated 0, no fail-stop after the first accepted step, etot not
    rising past 5e-3 of |e0| (e0 with the FMM's egrav). The energy drift
    gate of the other phases does not hold under cooling."""
    import torch
    from sphexa_tpu_torch import main as cli
    from sphexa_tpu_torch.propagator import std_cooling

    consts = os.path.join(ROOT, "chiprun_out", "cool_evrard_constants.txt")
    dump = os.path.join(ROOT, "chiprun_out", "cool_evrard.txt")
    if os.path.exists(dump):
        os.remove(dump)
    argv = ["--init", "evrard-cooling", "-n", str(COOL_SIDE), "-s",
            str(COOL_STEPS), "--ascii", "-w", str(COOL_STEPS), "-o", dump]
    real_build, real_dt = cli.build_sim, std_cooling.cooling_timestep
    seen, dt_cool = {}, []

    def build_sim(args, device):
        out = real_build(args, device)
        seen["extras"] = out[3]
        return out

    def cooling_timestep(*a, **kw):
        dt_cool.append(real_dt(*a, **kw))
        return dt_cool[-1]

    cli.build_sim, std_cooling.cooling_timestep = build_sim, cooling_timestep
    try:
        r = main_in_process(argv, consts, cfg_override=COOL_FMM,
                            energy=state_energy)
    finally:
        cli.build_sim, std_cooling.cooling_timestep = real_build, real_dt
    state, ex = r["state"], seen["extras"]
    params = ex["cooling_params"]
    alive = state.p.alive
    checks = [i for i, ln in enumerate(r["lines"])
              if ln.startswith("### Check")]
    assert not r["fails"] or max(r["fails"]) < checks[0], \
        "evrard-cooling: a fail-stop after the first accepted step"
    assert r["made"][-1][1].gravity_solver == "fmm"
    binds = []
    for d, dc in zip(r["diags"], dt_cool[-COOL_STEPS:]):
        assert float(d.egrav) < 0, float(d.egrav)
        assert int(d.nf_truncated) == 0, int(d.nf_truncated)
        binds.append("cooling" if float(dc) <= float(d.dt) else "hydro")
    temp = state.p.temp[alive].double()
    floor = params.t_floor / params.temp_to_k
    assert float(temp.min()) >= floor * (1 - 1e-6), (float(temp.min()),
                                                     floor)
    off = chem_gates(ex["chem"], alive)
    etot = r["rows"][:, 3]
    assert len(etot) == COOL_STEPS
    rise = (float(etot.max()) - r["e0"]) / abs(r["e0"])
    assert rise <= COOL_RISE_BOUND, f"etot rose by {rise:.3e} of |e0|"
    regrids = [ln for ln in r["lines"] if ln.startswith(
        ("# re-gridded", "# box expanded"))]
    p, box = state.p, r["made"][-1][0]
    leaves = {lvl: int(leaf_counts(p.x[alive], p.y[alive], p.z[alive], box,
                                   lvl).max()) for lvl in (EVRARD_LEVEL,
                                                           EVRARD_LEVEL + 1)}
    # the dump (~66 MB of text) is checked and removed, so that
    # chiprun_out stays small
    dump_bytes = os.path.getsize(dump)
    with open(dump) as f:
        head = [next(f) for _ in range(3)]
    os.remove(dump)
    assert dump_bytes > 0 and all(head), head
    res = dict(call_ms=r["call_ms"], step_ms=r["step_ms"],
               mean_ms=float(np.mean(r["step_ms"])),
               fail_stops=len(r["fails"]),
               fail_stop_lines=[r["lines"][i] for i in r["fails"]],
               regrids=regrids, wall_s=r["wall"], peak_bytes=r["peak"],
               e0=r["e0"], etot=etot.tolist(), etot_rise=rise,
               dt=[float(d.dt) for d in r["diags"]],
               dt_cool=[float(v) for v in dt_cool], binds=binds,
               temp_code=[float(temp.min()), float(temp.max())],
               temp_k=[float(temp.min()) * params.temp_to_k,
                       float(temp.max()) * params.temp_to_k],
               egrav=[float(d.egrav) for d in r["diags"]],
               chem_sum_off=off, launches=r["launches"],
               densest_leaf=leaves, box=[box.xmin, box.xmax],
               n_particles=int(alive.sum()), grid=str(r["made"][-1][2]),
               cfg=dict(cell_cap=r["made"][-1][1].cell_cap,
                        ngpad=r["made"][-1][1].ngpad),
               dump_bytes=dump_bytes)
    log(f"  evrard-cooling {COOL_SIDE}: {res['mean_ms']:.3f} ms a step "
        f"(CUDA events, {[round(s, 3) for s in r['step_ms']]}; all calls "
        f"{[round(s, 3) for s in r['call_ms']]}), {r['wall']:.1f} s of "
        f"main, {res['n_particles']} particles, peak "
        f"{r['peak'] / 2 ** 30:.3f} GiB; dt {res['dt']} bound by {binds} "
        f"(dt_cool of every call {[float('%.4g' % v) for v in res['dt_cool']]}"
        f"); temp {res['temp_k'][0]:.1f}-{res['temp_k'][1]:.1f} K; etot "
        f"{[float('%.8g' % e) for e in etot]} (e0 {r['e0']:.8g}, rise "
        f"{rise:.3e}); egrav {res['egrav']}; chemistry sums within "
        f"{off:.2e} of 1; densest FMM leaf on the last box "
        f"[{box.xmin:.4g}, {box.xmax:.4g}] by level {leaves}; fail-stops "
        f"{len(r['fails'])} {res['fail_stop_lines']}"
        f"; re-grids {regrids}; cell_cap {res['cfg']['cell_cap']}, ngpad "
        f"{res['cfg']['ngpad']}; ASCII dump {dump_bytes} bytes (removed); "
        f"launches {r['launches'] or 'none (plain PyTorch)'}")
    report["cool_cli_run"] = res


def split_run(report):
    """(p3) Sedov 50^3 built on the card, put through io/hdf5.split_state
    with S = 8 (1,000,000 particles), then 2 steps of the CLI's ve-pallas
    stepper (cli.make_stepper: make_ve_step_cellmajor on the planner's
    grid), each between CUDA events, the counters zeroed just before and
    read just after (K1 and K3-K7). Gates: m sums to the dump's total
    (rtol 1e-6), overflow 0, rows finite, |etot - e0|/e0 < 5e-3 (e0 the
    split state's ecin + eint)."""
    import torch
    from sphexa_tpu_torch import main as cli
    from sphexa_tpu_torch.config import SphConfig
    from sphexa_tpu_torch.init.sedov import init_sedov
    from sphexa_tpu_torch.io.hdf5 import split_state
    from sphexa_tpu_torch.propagator.common import compute_energies
    from sphexa_tpu_torch.state import _FIELDS

    state, box, cfg = init_sedov(SPLIT_SIDE, SphConfig(), dt0=3e-5,
                                 device=DEVICE)
    t0 = time.perf_counter()
    st = split_state(state, box, SPLIT_S)
    torch.cuda.synchronize()
    split_s = time.perf_counter() - t0
    n = int(st.p.alive.sum())
    assert n == SPLIT_S * SPLIT_SIDE ** 3 and st.p.device == state.p.device
    m0, m1 = float(state.p.m.double().sum()), float(st.p.m.double().sum())
    assert abs(m1 - m0) <= 1e-6 * m0, (m1, m0)
    e0 = float(sum(compute_energies(st.p, cfg)))
    args = cli.parse_args(["--init", "sedov", "--prop", "ve-pallas",
                           "--quiet"])
    h_max = float(st.p.h[st.p.alive].max())
    t0 = time.perf_counter()
    step, grid = cli.make_stepper(args, box, cfg, h_max, n, {}, state=st,
                                  device=DEVICE)
    plan_s = time.perf_counter() - t0
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    ms, diags = [], []
    for _ in range(SPLIT_STEPS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        st, d = step(st)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
        diags.append(d)
    launches = {k.name: k.launches for k in kernels if k.launches}
    assert set(launches) == PROP_KERNELS["ve-pallas"], launches
    for d in diags:
        assert int(d.max_cell_count) == 0, f"overflow {int(d.max_cell_count)}"
    for f in _FIELDS[:-1]:
        assert torch.isfinite(getattr(st.p, f)).all(), f
    etot = float(diags[-1].etot)
    drift = abs(etot - e0) / e0
    assert drift < CLI_DRIFT_BOUND, f"split: energy drift {drift:.3e}"
    res = dict(n_particles=n, split_s=split_s, plan_s=plan_s, grid=str(grid),
               step_ms=ms, launches=launches, e0=e0, etot=etot,
               energy_drift=drift, m_dump=m0, m_split=m1,
               dt=[float(d.dt) for d in diags])
    log(f"  Sedov {SPLIT_SIDE}^3 split S = {SPLIT_S}: {n} particles "
        f"(split_state {split_s:.2f} s on the host, plan {plan_s:.2f} s, "
        f"{grid}), m {m1:.9f} vs {m0:.9f}; ve-pallas {[round(t, 3) for t in ms]}"
        f" ms a step (CUDA events), overflow 0, |etot - e0|/e0 = "
        f"{drift:.3e}, dt {res['dt']}, launches {launches}")
    report["split_run"] = res


def profile_table(lines):
    """The --profile table's rows, name -> (ms a step, calls), from the
    lines main printed (util/xprofile.print_table's format)."""
    at = lines.index("# profile trace written to ./sphexa-trace")
    rows = {}
    for ln in lines[at + 2:]:
        if not ln.startswith("# ") or ln.startswith("# done"):
            break
        name, rest = ln[2:58].rstrip(), ln[58:].split()
        if len(rest) == 2:
            rows[name] = (float(rest[0]), int(rest[1]))
    return rows


def profile_run(report):
    """(p4) main([... --prop ve-pallas --profile --viz-every 1 ...]) at
    Sedov 100^3 for 2 steps, in chiprun_out/profile (./sphexa-trace and
    the PNGs go there). Gates: the trace written; the table lists the
    five stage kernels (K3-K7) and K1, each with as many calls as its
    wrapper counted launches in the run (the table divides its ms by
    the state's iteration, steps + 1 on a fresh run, as the JAX table
    does); the PNG of each step, unless matplotlib is missing (said on
    its own line, and not counted as a pass)."""
    import importlib.util

    here = os.getcwd()
    work = os.path.join(ROOT, "chiprun_out", "profile")
    os.makedirs(work, exist_ok=True)
    for f in os.listdir(work):
        if f.endswith(".png"):
            os.remove(os.path.join(work, f))
    consts = os.path.join(work, "constants.txt")
    argv = ["--init", "sedov", "-n", str(PROFILE_SIDE), "-s",
            str(PROFILE_STEPS), "--dt0", CLI_DT0, "--prop", "ve-pallas",
            "--profile", "--viz-every", "1"]
    os.chdir(work)
    try:
        r = main_in_process(argv, consts)
    finally:
        os.chdir(here)
    trace = os.path.join(work, "sphexa-trace", "trace.json")
    assert os.path.getsize(trace) > 0
    table = profile_table(r["lines"])
    iters = int(r["state"].iteration)
    kern = {}
    for k, part in PROFILE_NAMES.items():
        hits = {n: v for n, v in table.items() if part in n}
        assert hits, (f"--profile table: no row for {k} ({part}) among "
                      f"{sorted(table)}")
        calls = sum(c for _, c in hits.values())
        assert calls == r["launches"][k], (k, calls, r["launches"][k])
        kern[k] = dict(rows=sorted(hits), calls=calls,
                       calls_per_step=calls / PROFILE_STEPS,
                       ms_per_step=sum(m for m, _ in hits.values()) * iters
                       / PROFILE_STEPS)
    total = [ln for ln in r["lines"] if ln.startswith("# TOTAL device")]
    assert len(total) == 1, total
    pngs = sorted(f for f in os.listdir(work) if f.endswith(".png"))
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    if has_mpl:
        assert len(pngs) == PROFILE_STEPS, pngs
    res = dict(step_ms=r["step_ms"], call_ms=r["call_ms"], wall_s=r["wall"],
               table_rows=len(table), kernels=kern,
               total_device_ms_per_step=float(total[0].split()[-1]) * iters
               / PROFILE_STEPS, trace_bytes=os.path.getsize(trace),
               pngs=pngs, matplotlib=has_mpl, launches=r["launches"])
    log(f"  --profile --viz-every 1, ve-pallas at Sedov {PROFILE_SIDE}^3: "
        f"{[round(s, 3) for s in r['step_ms']]} ms a step (CUDA events), "
        f"{r['wall']:.1f} s of main; trace {res['trace_bytes']} bytes; "
        f"table of {len(table)} rows, device total "
        f"{res['total_device_ms_per_step']:.3f} ms a step; "
        + "; ".join(f"{k} {v['calls_per_step']:g} calls and "
                    f"{v['ms_per_step']:.3f} ms a step ({v['rows']})"
                    for k, v in kern.items()))
    if has_mpl:
        log(f"  --viz-every 1 wrote {pngs}")
    else:
        log("  matplotlib is not installed: --viz-every 1 wrote no PNG "
            "(not counted as a pass)")
    report["profile_run"] = res


def cool_phase(report):
    """Phase (p): radiative cooling, the split restart, --profile and
    --viz-every on the card."""
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)

    def at():
        log(f"  {time.perf_counter() - t0:.1f} s into phase (p)")
    log("(p1) the std-cooling step on the card against the CPU:")
    cool_check(report)
    at()
    log(f"(p2) main([... --init evrard-cooling -n {COOL_SIDE} ...]):")
    cool_cli_run(report)
    at()
    log(f"(p3) Sedov {SPLIT_SIDE}^3 split S = {SPLIT_S} through ve-pallas:")
    split_run(report)
    at()
    log(f"(p4) main([... --prop ve-pallas --profile --viz-every 1 ...]) at "
        f"Sedov {PROFILE_SIDE}^3:")
    profile_run(report)
    report["cool_phase_seconds"] = time.perf_counter() - t0
    log(f"  phase (p): {report['cool_phase_seconds']:.1f} s")


# ---------------------------------------------------------------------------
# (s) every pair kernel past cap 1024
# ---------------------------------------------------------------------------

# cap -> (lattice side, clump radius) of the clump frame (bigcap_state):
# its densest cell holds 1120, 2003 and 4035 rows, past 1024 and past
# half the cap (tests/test_torch_bigcap_stages.py holds the stages at
# cap 1152 on the same construction against the JAX package)
BIGCAP_FRAMES = {1152: (16, 0.80), 2048: (20, 0.89), 4096: (25, 0.84)}
# interior cells of each launch held against plain: the 8 of n = 2;
# at 4096 4 of them, the densest first (sample_occupied_cells): a plain
# stage evaluates 27 cap^2 = 4.5e8 candidates a cell there
BIGCAP_CELLS = {1152: 8, 2048: 8, 4096: 4}
BIGCAP_REPS = 5
BIGCAP_SEED = 7


def bigcap_state(cap, device):
    """(state, box, cfg, grid) of the clump frame at `cap`: on the open
    cube [-1, 1]^3 and CMGrid(n=2, cap), a clump with Evrard's 1/r
    profile (the side^3 lattice on [-1, 1)^3 cut to the unit sphere,
    radii r -> radius sqrt(r) r) centred at (0.3, 0.3, 0.3), jittered
    by 3% of the lattice spacing (seeded); h the mean of the distances
    to the 100th and 101st neighbours over 2 (relaxed: K3 moves no h,
    no pair on the support's edge), at most 0.45; velocities sigma 0.3,
    alpha in [0.05, 0.5] and temperatures giving sound speeds near 1
    (seeded), equal masses."""
    from scipy.spatial import cKDTree
    from sphexa_tpu_torch.config import SphConfig
    from sphexa_tpu_torch.ops.cellmajor import CMGrid
    from sphexa_tpu_torch.sfc.box import Box, Boundary
    from sphexa_tpu_torch.sph.eos import ideal_gas_cv
    from sphexa_tpu_torch.state import make_particles, make_state

    side, radius = BIGCAP_FRAMES[cap]
    r = np.random.default_rng(BIGCAP_SEED)
    g = (np.arange(side) + 0.5) / side * 2.0 - 1.0
    p = np.stack([a.ravel() for a in np.meshgrid(g, g, g, indexing="ij")],
                 axis=1)
    rad = np.sqrt((p ** 2).sum(1))
    p, rad = p[rad <= 1.0], rad[rad <= 1.0]
    p = p * (radius * np.sqrt(rad))[:, None] + 0.3
    p = (p + r.normal(0.0, 0.03 * 2.0 / side * radius, p.shape)).clip(
        -0.999, 0.999)
    d = cKDTree(p).query(p, 102)[0]
    h = np.minimum(0.25 * (d[:, -2] + d[:, -1]), 0.45)
    n = len(h)
    cfg = SphConfig()
    r = np.random.default_rng(BIGCAP_SEED + 1)
    ps = make_particles(
        n, n, device=device, x=p[:, 0], y=p[:, 1], z=p[:, 2], h=h,
        m=np.full(n, 1.0 / n), vx=r.normal(0, 0.3, n),
        vy=r.normal(0, 0.3, n), vz=r.normal(0, 0.3, n),
        alpha=r.uniform(0.05, 0.5, n),
        temp=r.uniform(0.5, 1.5, n) / ideal_gas_cv(cfg.mui, cfg.gamma))
    return (make_state(ps, dt0=1e-5), Box.cube(-1.0, 1.0, Boundary.open),
            cfg, CMGrid(n=2, cap=cap))


def bigcap_calls(cap):
    """The pair launches of one resident step on the clump frame at
    `cap` under the direct, mm and avClean configurations ({name: (k,
    args, out)}, the first launch of each stage), K10-bf16 launched on
    the mm momentum inputs, and the engine's interior mask."""
    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv
    from sphexa_tpu_torch.propagator.ve_cellmajor import ResidentVE

    calls = {}
    for cname in (None, "mm", "avclean"):
        state, box, cfg, grid = bigcap_state(cap, DEVICE)
        eng = ResidentVE(box, grid, cfg.replace(**CONFIGS.get(cname, {})),
                         device=DEVICE)
        with Spy(pv.PAIR_KERNELS) as spy:
            eng.step(eng.bind(state))
        torch.cuda.synchronize()
        for k, args, out in spy.calls:
            calls.setdefault(k.name, (k, args, out))
    k, (J, I2, g, c), _ = calls["pair_momentum_mm"]
    bf = (J, I2, g, c.replace(mxu_bf16=True))
    calls["pair_momentum_mm_bf16"] = (k, bf, k._launch(*bf))
    torch.cuda.synchronize()
    return calls, eng.intmask


def bigcap_gate(act, grid, Z):
    """K2g's gate pass on the card against its plain version: the count,
    the listed cells as a set (the card's list is in no fixed order) and
    the supercells' flags. Returns the count."""
    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv
    ws = pv.pair_gate._launch(act, grid, Z)
    ref = pv.pair_gate.plain(act, grid, Z)
    cnt, f0 = int(ref[0]), pv.gate_flags(grid)
    got = ws[pv.GATE_HDR:pv.GATE_HDR + cnt].sort().values
    if not (int(ws[0]) == cnt
            and torch.equal(got, ref[pv.GATE_HDR:pv.GATE_HDR + cnt])
            and torch.equal(ws[f0:], ref[f0:])):
        raise AssertionError(f"gate pass at cap {grid.cap}: list or flags "
                             f"differ from plain")
    return cnt


def bigcap_one(report, rows, cap):
    """(s) at one cap: every form on the clump frame held against its
    plain version on sampled cells, timed beside its bound and its
    shared memory. Returns {row name: record}."""
    import torch
    from sphexa_tpu_torch.ops import _cuda
    from sphexa_tpu_torch.ops import pair_ve as pv

    calls, intmask = bigcap_calls(cap)
    k, (J, I2, grid, cfg), xh_out = calls["pair_xh"]
    valid = valid_slots(J)
    occ = (valid & intmask).view(-1, cap).sum(1)
    densest = int(occ.max())
    assert 1024 < densest <= cap and 2 * densest > cap, (cap, densest)
    # relaxed h: K3 moves none, so one distance pass is all its counting
    assert torch.equal(xh_out[1][valid & intmask], J[pv.RH][valid & intmask])
    nc_sph = xh_out[2] + 1
    cand, inside, per_slot = pair_counts(J, types.SimpleNamespace(
        intmask=intmask), grid, nc_sph)
    cells = sample_occupied_cells(grid, valid, intmask, BIGCAP_CELLS[cap],
                                  cap)
    lane = torch.arange(cap, device=DEVICE)
    sampled = torch.zeros(grid.n_slots, dtype=torch.bool, device=DEVICE)
    sampled[(cells[:, None] * cap + lane).reshape(-1)] = True
    act, kinds = activity_pattern(grid, valid, seed=3)
    Z = pv.resolve_zgroup(grid)
    on = pv.supercell_active(act, grid, Z).repeat_interleave(cap)
    assert kinds["active"] and kinds["inactive"], kinds
    assert bool(on[sampled & valid].any()), "no sampled cell is active"
    n_listed = bigcap_gate(act, grid, Z)
    rng = np.random.default_rng(4)
    by_name = {x["name"]: x for x in rows}
    res = dict(densest=densest, occupied=occ[occ > 0].tolist(),
               candidates=cand, in_support=inside, cells=int(cells.numel()),
               supercells=kinds, listed=n_listed)
    log(f"  cap {cap}: {int(valid.sum())} rows, cell counts "
        f"{sorted(occ[occ > 0].tolist())}; {cand:.4e} candidates, "
        f"{inside:.4e} in support; {cells.numel()} cells against plain; "
        f"activity {kinds}, {n_listed} cells listed by the gate pass "
        f"(equal to plain)")

    k9 = {}

    def held(k, ref, out, mask):
        """compare() at the kernel checks' tolerances; K9's slots at its
        noise floor (k9_noise_floor) within 8 times their noise of the
        float64 alpha, as tests/test_torch_cuda.py holds K9 past cap
        128 (ROADMAP Queue 3)."""
        if body_of(k.name) != "pair_av_mm":
            return compare(k.name, ref, out, mask, per_row=True)
        if not k9:
            J9, I9, g9, c9 = calls["pair_av_mm"][1]
            k9.update(zip(("ref", "noise", "named"), k9_noise_floor(
                J9, I9, g9, c9, cells=cells)))
            res["k9_noise_floor_slots"] = int((valid & sampled & intmask
                                               & k9["named"]).sum())
        at = mask & k9["named"]
        err64 = (out[0, at].double() - k9["ref"][at]).abs()
        if not bool((err64 <= 8.0 * k9["noise"][at]
                     * k9["ref"][at].abs()).all()):
            raise AssertionError(f"{k.name} at cap {cap}: slots at K9's "
                                 f"noise floor beyond 8x their noise")
        return compare(k.name, ref, out, mask & ~k9["named"], per_row=True)

    def record(row, ms, err, rel, ops, nbytes, smem, mm=(0.0, 0.0),
               bf16=False, extra=""):
        bound, by = pair_bound(ops, nbytes, mm, bf16)
        rec = dict(ms=ms, bound_ms=bound, bound_by=by, smem_bytes=smem,
                   max_abs_err=err, max_rel_err=rel)
        res[row] = rec
        if row in by_name:
            by_name[row].setdefault("cap_past_1024", {})[cap] = rec
        log(f"  cap {cap} {row:30s} {ms:9.3f} ms  bound {bound:.4f} ms "
            f"({by}); smem {smem} B; err {err:.3e} (rel {rel:.3e}){extra}")

    for name, (k, args, out) in calls.items():
        J, I2, g, c = args
        body = body_of(k.name)
        mask = valid & sampled & intmask
        if name.endswith("_bf16"):
            err, rel = bf16_compare(k, args, out, mask, cells=cells)
            ref = None
        else:
            ref = pv._run_plain(k.body, J, I2, g, k.fo, cells=cells,
                                **k._body_kw(c))
            err, rel = held(k, ref, out, mask)
        check_fill(k, J, out, intmask)
        nbytes = 4 * (J.numel() + (I2.numel() if I2 is not None else 0)
                      + out.numel())
        mm = mm_extra_flops(body, J, g, c, valid & intmask,
                            int((occ > 0).sum()))
        ops = cand * GEO_FLOPS + inside * BODY_FLOPS[body]
        smem = _cuda.pair_smem(k.stage, cap, c.mxu_bf16)
        ms = cuda_ms(lambda: k._launch(J, I2, g, c), BIGCAP_REPS)
        floor = (f"; {res['k9_noise_floor_slots']} slots at K9's noise "
                 f"floor within 8x their noise" if body == "pair_av_mm"
                 else "")
        record(name, ms, err, rel, ops, nbytes, smem, mm, c.mxu_bf16, floor)

        # K11: bit-equal to the cell launch on the interior, 0 elsewhere
        kc = next(x for x in pv.COLUMN_KERNELS
                  if x.name == k.name + "_column")
        oc = kc._launch(*args)
        if not (torch.equal(oc[:, intmask], out[:, intmask])
                and not oc[:, ~intmask].any()):
            raise AssertionError(f"{kc.name} at cap {cap}: not bit-equal "
                                 f"to the cell launch")
        ms = cuda_ms(lambda: kc._launch(*args), BIGCAP_REPS)
        record(column_row_name(kc, c), ms, err, rel, ops, nbytes, smem, mm,
               c.mxu_bf16, "; bit-equal to the cell launch")

        # K2g with its gate pass: prev on the inactive supercells, the
        # ungated results (held above) on the active ones
        kg = next((x for x in pv.GATED_KERNELS
                   if x.name == k.name + "_gated"), None)
        if kg is None or c.mxu_bf16:
            continue
        prev = torch.from_numpy(rng.normal(0, 1, (kg.fo, g.n_slots)).astype(
            np.float32)).to(DEVICE)
        gargs = (J, I2, g, c, (act, prev), 0)
        og = kg._launch(*gargs)
        keep = intmask & ~on
        if not (torch.equal(og[:, keep], prev[:, keep])
                and not og[:, ~intmask].any()
                and torch.equal(og[:, intmask & on], out[:, intmask & on])):
            raise AssertionError(f"{kg.name} at cap {cap}: not prev on the "
                                 f"inactive supercells or not the cell "
                                 f"launch's output on the active ones")
        gerr, grel = held(k, ref, og, mask & on)
        ms = cuda_ms(lambda: kg._launch(*gargs), BIGCAP_REPS)
        a_ops = float(per_slot[on].sum()) * GEO_FLOPS + float(
            torch.where(valid & intmask & on, nc_sph, 0.0).double().sum()
        ) * BODY_FLOPS[body]
        gbytes = nbytes + 4 * (act.numel() + prev.numel())
        record(kg.name, ms, gerr, grel, a_ops, gbytes, smem,
               extra="; prev bit-equal on the inactive supercells")
    return res


def bigcap_phase(report, rows):
    """Phase (s): every pair kernel form past cap 1024 (BIGCAP_FRAMES)."""
    import torch
    t0 = time.perf_counter()
    log("(s) every pair kernel past cap 1024, on the clump frame:")
    out = {}
    for cap in BIGCAP_FRAMES:
        out[cap] = bigcap_one(report, rows, cap)
        torch.cuda.empty_cache()
        log(f"  {time.perf_counter() - t0:.1f} s into phase (s)")
    report["cap_past_1024"] = out
    report["bigcap_phase_seconds"] = time.perf_counter() - t0
    log(f"  phase (s): {report['bigcap_phase_seconds']:.1f} s")


def compare_mm():
    """--compare's moment-matmul part: K8, K9 and K10 (float32, bf16) at
    the inputs of a Sedov 100^3 step under mxu_moments + mxu_momentum, 3 x 5
    launches each, K10's blocks (zero counts from a kernel without the
    counter), then 3 timed steps of that configuration."""
    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv
    from sphexa_tpu_torch.propagator.ve_cellmajor import ResidentVE

    out = {}
    state, box, cfg, grid = sedov(MAIN_SIDE, DEVICE, flags=MM)
    eng = ResidentVE(box, grid, cfg, device=DEVICE)
    rst = eng.bind(state)
    for _ in range(2):
        rst, _ = eng.step(rst)
    with Spy((pv.pair_iad_mm, pv.pair_av_mm, pv.pair_momentum_mm)) as spy:
        eng.step(rst)
    torch.cuda.synchronize()
    for k, (J, I2, g, c), _ in spy.calls:
        for bf in ((False, True) if k is pv.pair_momentum_mm else (False,)):
            args = (J, I2, g, c.replace(mxu_bf16=bf))
            name = k.name + ("_bf16" if bf else "")
            out[f"{name}_ms"] = [cuda_ms(lambda: k._launch(*args), 5)
                                 for _ in range(3)]
            log(f"  {name} {grid}: {out[f'{name}_ms']} ms (events, 3 x 5 "
                f"launches)")
            if k is pv.pair_momentum_mm:
                st = torch.zeros(3, dtype=torch.int64, device=DEVICE)
                k._launch(*args, stats=st)
                torch.cuda.synchronize()
                out[f"{name}_blocks"] = st.tolist()[:2]
                log(f"  {name} mma blocks issued, staged: "
                    f"{out[f'{name}_blocks']}")
    del spy
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    for i in range(3):
        rst, _ = eng.step(rst)
        ev[i + 1].record()
    torch.cuda.synchronize()
    out["mm_step_ms"] = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
    log(f"  mm resident step {out['mm_step_ms']} ms")
    return out


def compare_main(tag: str) -> int:
    """--compare [tag]: K1, K1z and the redesigned pair kernels (K3-K10)
    alone, so that two checkouts can be compared in one call. K1
    over the five refreshes of one Sedov 100^3 resident step, and K3-K7
    at that step's inputs (events time; K3's walks counted on the card
    where the checkout has the counter; K4-K7's in-support pairs and
    lane efficiency; registers), then 3 timed resident steps and 2
    timed BdtVE cycles (4 rungs), then the five gated stages at the
    inputs of substep 1 of a cycle and with no active supercell; K8, K9
    and K10 (float32 and mxu_bf16) at
    the inputs of a Sedov 100^3 step under mxu_moments + mxu_momentum
    (after two warm-up steps; K10's mma blocks counted on the card
    where the checkout has the counter), then 3 timed steps of that
    configuration; K3-K7 at the inputs of a 100^3 sharded step at D = 2
    (cap 256, both shards' launches); K1z over the 6 * D launches of a
    100^3 sharded step (stacks of ZX_ROWS' row counts, on the plan_slab
    local grids, z open); K1 and K1z split by ghost_split. Writes
    chiprun_out/compare<tag>.json."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from sphexa_tpu_torch.domain.mesh import SlabMesh
    from sphexa_tpu_torch.ops import pair_ve as pv
    from sphexa_tpu_torch.propagator.ve_cellmajor import ResidentVE
    from sphexa_tpu_torch.propagator.ve_pallas_sharded import (
        make_ve_step_pallas_sharded)
    from sphexa_tpu_torch.sfc.box import Boundary

    smi = smi_line()
    log(smi)
    redone = (pv.pair_xh, pv.pair_gradh, pv.pair_iad, pv.pair_av,
              pv.pair_momentum)
    state, box, cfg, grid = sedov(MAIN_SIDE, DEVICE)
    eng = ResidentVE(box, grid, cfg, device=DEVICE)
    rst = eng.bind(state)
    with Spy((pv.ghost_refresh,) + redone) as spy:
        eng.step(rst)
    torch.cuda.synchronize()
    ghost = [c[:2] for c in spy.calls if c[0] is pv.ghost_refresh]
    calls = {c[0].name: c for c in spy.calls if c[0] in redone}
    src = torch.tensor(pv._ghost_maps(grid, box)["src"], device=DEVICE)
    out = {"smi": smi, "K1": ghost_split(ghost, src),
           "K3_walks": xh_walks(*calls["pair_xh"][:2]),
           "ptxas": routine_ptxas()}
    for name, (k, args, _) in calls.items():
        out[f"{name}_ms"] = [cuda_ms(lambda: k._launch(*args), 5)
                             for _ in range(3)]
        log(f"  {name} {grid}: {out[f'{name}_ms']} ms (events, 3 x 5 "
            f"launches)")
    for name, lc in stage_lanes(calls.values(), grid, eng.intmask).items():
        out[f"{name}_lanes"] = lc
        log_lanes(name, lc)
    log(f"  K3 walks: {out['K3_walks']}")
    log(f"  ptxas: "
        f"{dict((k, v) for k, v in out['ptxas'].items() if k != 'raw')}")
    del calls, spy
    step_ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    step_ev[0].record()
    for i in range(3):
        rst, _ = eng.step(rst)
        step_ev[i + 1].record()
    state_b, beng = bdt_setup(MAIN_SIDE, DEVICE, 4)
    bst, _ = beng.run_cycle(beng.bind_bdt(state_b))      # warm-up
    cyc = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    cyc[0].record()
    for i in range(2):
        bst, _ = beng.run_cycle(bst)
        cyc[i + 1].record()
    torch.cuda.synchronize()
    out["step_ms"] = [a.elapsed_time(b) for a, b in zip(step_ev, step_ev[1:])]
    out["bdt_cycle_ms"] = [a.elapsed_time(b) for a, b in zip(cyc, cyc[1:])]
    # the five gated stages at the inputs of substep 1 of a cycle, and
    # with no active supercell
    bst, _ = beng.resync(bst)
    bst, _ = beng.substep(bst)
    with Spy(beng.pve_gated.kernels) as spy:
        beng.substep(bst)
    torch.cuda.synchronize()
    for kg, args, _ in spy.calls:
        J, I2, g, c, (act, prev), zgroup = args
        idle = (J, I2, g, c, (torch.zeros_like(act), prev), zgroup)
        for key, a in ((f"{kg.name}_ms", args), (f"{kg.name}_idle_ms", idle)):
            out[key] = [cuda_ms(lambda: kg._launch(*a), 5) for _ in range(3)]
            out[key.replace("_ms", "_split")] = split_ms(
                lambda: kg._launch(*a))
        log(f"  {kg.name} substep 1: {out[f'{kg.name}_ms']} ms, none active "
            f"{out[f'{kg.name}_idle_ms']} ms (events, 3 x 5 launches); "
            f"device (CUDA graph) {out[f'{kg.name}_split']['device_ms']:.4f}"
            f", none active {out[f'{kg.name}_idle_split']['device_ms']:.4f} "
            f"ms; host dispatch "
            f"{out[f'{kg.name}_split']['host_ms']:.4f} ms")
    del beng, bst, state_b, spy
    log_split(f"K1 {grid}, {len(ghost)} refreshes", out["K1"])
    log(f"  resident step {out['step_ms']} ms, BdtVE cycle "
        f"{out['bdt_cycle_ms']} ms (4 rungs, after a warm-up cycle)")
    del eng, rst
    out.update(compare_mm())
    sstate, sbox, scfg, sgrid, sc = sharded_setup(2)
    mesh = SlabMesh(2, devices=[DEVICE])
    sstep = make_ve_step_pallas_sharded(sbox, sgrid, scfg, sc, mesh)
    states, _ = sstep(shard_states(sstate, sbox, sc, mesh))
    with Spy(redone) as spy:
        sstep(states)
    torch.cuda.synchronize()
    for k, args, _ in spy.calls:
        key = f"{k.name}_D2_ms"
        out[key] = out.get(key, 0.0) + cuda_ms(lambda: k._launch(*args), 3)
    log(f"  D = 2 step, cap {sgrid.cap}, both shards: "
        f"{dict((k, round(v, 3)) for k, v in out.items() if 'D2' in k)} ms")
    del states, spy, sstep, mesh
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    for D in SHARD_D:
        _, gbox, _, lgrid, _ = sharded_setup(D)
        lbox = dataclasses.replace(gbox, bz=Boundary.open)
        src = torch.tensor(pv._ghost_maps(lgrid, lbox, False)["src"],
                           device=DEVICE)
        calls = [(pv.ghost_refresh_xy, (torch.randn(
            (r, lgrid.n_slots), device=DEVICE, generator=gen), lgrid, lbox,
            None)) for _ in range(D) for r, _ in ZX_ROWS]
        out[f"K1z_D{D}"] = ghost_split(calls, src)
        log_split(f"K1z D={D} {lgrid}, {len(calls)} launches",
                  out[f"K1z_D{D}"])
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"compare{tag}.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    return 0


def gravity_main() -> int:
    """--gravity: the build and phase (l) alone (no result lines);
    details to chiprun_out/chip_smoke_gravity.json."""
    import torch
    sys.path.insert(0, ROOT)
    from sphexa_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"smi": smi_line()}
    log(report["smi"])
    _cuda.build()
    gravity_phase(report)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_gravity.json"),
              "w") as f:
        json.dump(report, f, indent=1, default=str)
    return 0


def cli_main() -> int:
    """--cli: the build and phase (m) alone (no result lines); details to
    chiprun_out/chip_smoke_cli.json."""
    import torch
    sys.path.insert(0, ROOT)
    from sphexa_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"smi": smi_line()}
    log(report["smi"])
    _cuda.build()
    cli_phase(report)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_cli.json"),
              "w") as f:
        json.dump(report, f, indent=1, default=str)
    return 0


def turb_main() -> int:
    """--turb: the build and phase (n) alone (no result lines); details
    to chiprun_out/chip_smoke_turb.json."""
    import torch
    sys.path.insert(0, ROOT)
    from sphexa_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"smi": smi_line()}
    log(report["smi"])
    _cuda.build()
    turb_phase(report, [])
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_turb.json"),
              "w") as f:
        json.dump(report, f, indent=1, default=str)
    return 0


def tiers_main() -> int:
    """--tiers: the build and phase (o) alone (no result lines); details
    to chiprun_out/chip_smoke_tiers.json."""
    import torch
    sys.path.insert(0, ROOT)
    from sphexa_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"smi": smi_line()}
    log(report["smi"])
    _cuda.build()
    tier_phase(report, [], replan=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_tiers.json"),
              "w") as f:
        json.dump(report, f, indent=1, default=str)
    return 0


def cool_main() -> int:
    """--cool: the build and phase (p) alone (no result lines); details
    to chiprun_out/chip_smoke_cool.json."""
    import torch
    sys.path.insert(0, ROOT)
    from sphexa_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"smi": smi_line()}
    log(report["smi"])
    _cuda.build()
    cool_phase(report)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_cool.json"),
              "w") as f:
        json.dump(report, f, indent=1, default=str)
    return 0


def multi_main() -> int:
    """--multi: the build and phase (q) alone (no result lines); details
    to chiprun_out/chip_smoke_multi.json."""
    import torch
    sys.path.insert(0, ROOT)
    from sphexa_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"smi": smi_line()}
    log(report["smi"])
    _cuda.build()
    multi_phase(report, [])
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_multi.json"),
              "w") as f:
        json.dump(report, f, indent=1, default=str)
    return 0


def bigcap_main() -> int:
    """--bigcap: the build and phase (s) alone (no result lines);
    details to chiprun_out/chip_smoke_bigcap.json."""
    import torch
    sys.path.insert(0, ROOT)
    from sphexa_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"smi": smi_line()}
    log(report["smi"])
    t0 = time.perf_counter()
    _cuda.build()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for src, info in _cuda.build_info.items():
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")
    rows = [{"name": k.name} for k in all_kernels()]
    bigcap_phase(report, rows)
    report["rows"] = rows
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_bigcap.json"),
              "w") as f:
        json.dump(report, f, indent=1, default=str)
    return 0


def probes_main() -> int:
    """--probes: the build of probes.cu and phase (j) alone (no result
    lines); details to chiprun_out/chip_smoke_probes.json."""
    import torch
    sys.path.insert(0, ROOT)
    from sphexa_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"smi": smi_line()}
    log(report["smi"])
    t0 = time.perf_counter()
    _cuda.build(["probes.cu", *_cuda.VARIANTS])
    log(f"build: {time.perf_counter() - t0:.1f} s")
    report["ptxas"] = {s: i["ptxas"] for s, i in _cuda.build_info.items()}
    report["rows"] = probes_phase(report)
    log(f"phase (j): {time.perf_counter() - t0:.1f} s with the build")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_probes.json"),
              "w") as f:
        json.dump(report, f, indent=1, default=str)
    return 0


def dom_main() -> int:
    """--domains: the build and phase (r) alone (no result lines);
    details to chiprun_out/chip_smoke_domains.json."""
    import torch
    sys.path.insert(0, ROOT)
    from sphexa_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"smi": smi_line()}
    log(report["smi"])
    t0 = time.perf_counter()
    _cuda.build()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    rows = [{"name": k.name} for k in all_kernels()]
    dom_phase(report, rows, dom_refs_start())
    report["rows"] = rows
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_domains.json"),
              "w") as f:
        json.dump(report, f, indent=1, default=str)
    return 0


def main() -> int:
    import torch
    if sys.argv[1:2] == ["--compare"]:
        return compare_main(sys.argv[2] if len(sys.argv) > 2 else "")
    if sys.argv[1:2] == ["--cpu-ref"]:      # a CPU reference of phase (q)
        return cpu_ref_main()
    if sys.argv[1:2] == ["--cpu-ref-dom"]:  # a CPU reference of phase (r)
        return dom_cpu_ref_main()
    if sys.argv[1:2] == ["--cpu-ref-bdt"]:  # bdt_engine_check's CPU side
        return bdt_cpu_ref_main()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--gravity"]:
        return gravity_main()
    if sys.argv[1:2] == ["--cli"]:
        return cli_main()
    if sys.argv[1:2] == ["--turb"]:
        return turb_main()
    if sys.argv[1:2] == ["--tiers"]:
        return tiers_main()
    if sys.argv[1:2] == ["--cool"]:
        return cool_main()
    if sys.argv[1:2] == ["--multi"]:
        return multi_main()
    if sys.argv[1:2] == ["--domains"]:
        return dom_main()
    if sys.argv[1:2] == ["--bigcap"]:
        return bigcap_main()
    if sys.argv[1:2] == ["--probes"]:
        return probes_main()
    sys.path.insert(0, ROOT)
    from sphexa_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    smi = smi_line()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _cuda.build(_cuda.SOURCES + tuple(_cuda.VARIANTS))
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f} s")
    for src, info in _cuda.build_info.items():
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")
    report["build_seconds"] = build_s
    report["ptxas"] = {s: i["ptxas"] for s, i in _cuda.build_info.items()}

    def since():
        log(f"  {time.perf_counter() - t0:.1f} s since the build began")

    bdt_ref = bdt_ref_start()
    atexit.register(lambda: bdt_ref[0].poll() is None and bdt_ref[0].kill())
    log("kernel check:")
    calls, eng30 = kernel_check(report)
    gated_check(report, calls, eng30)
    del calls, eng30
    engine_check(report)
    since()
    log("main path:")
    eng, rst, grid, launches = main_path(report)
    log("timing:")
    rows = timing(report, eng, rst, grid, launches)
    del eng, rst
    log("block time-steps:")
    beng, bst, blaunches = bdt_main_path(report)
    log("block time-steps timing:")
    rows += bdt_timing(report, beng, bst, blaunches)
    del beng, bst

    since()
    log("(e) moment-matmul and avClean kernels against their plain "
        "versions:")
    mm_kernel_check(report)
    log("(f) card against CPU under the three configurations:")
    for cname in CONFIGS:
        engine_check(report, cname)
    log("(g) main path under mxu_moments + mxu_momentum:")
    eng, rst, grid, l_mm = main_path(report, "mm")
    log("(g) + mxu_bf16:")
    l_bf16 = main_path(report, "mm_bf16", steps=3, rebin_at=1)[3]
    log("(g) av_clean:")
    eng_av, rst_av, _, l_av = main_path(report, "avclean", steps=3,
                                        rebin_at=1)
    log("(h) timing of K8-K10 and K7c:")
    rows += mm_timing(report, eng, rst, grid, l_mm, l_bf16)
    rows += mm_timing(report, eng_av, rst_av, grid, l_av)
    del eng, rst, eng_av, rst_av
    log("(g) block time-steps under mxu_moments + mxu_momentum:")
    beng, bst, blaunches = bdt_main_path(report, "mm", cycles=1)
    log("(h) timing of the gated K8-K10:")
    rows += bdt_timing(report, beng, bst, blaunches, "mm")
    del beng, bst

    since()
    log("(i) the column launch K11 against its plain version and the cell "
        "launch at 30^3:")
    column_check(report)
    for cname in COLUMN_STAGES:
        log(f"(i) 100^3 column-mode resident step, "
            f"{'direct' if cname is None else cname}:")
        eng, rst, launches = column_main_path(report, cname)
        rows += column_timing(report, cname, eng, rst, launches)
        del eng, rst
    since()
    log("(j) hardware probes P1-P5:")
    rows += probes_phase(report)
    since()

    log("(k) the slab-sharded engines, all shards on the one card:")
    grids = {f"100^3 D={D}": sharded_setup(D)[3] for D in SHARD_D}
    grids[f"{CHECK_SIDE}^3"] = sedov(CHECK_SIDE, DEVICE)[3]
    k1z_check(report, grids)
    sharded_engine_check(report)
    k1z_rows = [sharded_main_path(report, D) for D in SHARD_D]
    rows.append(k1z_rows[0])
    sharded_bdt_main_path(report)
    # its CPU side has run in a child process since the build
    bdt_engine_check(report, bdt_ref)
    since()

    # phase (r)'s CPU references run beside phases (l)-(q)
    dom_procs = dom_refs_start()
    atexit.register(cpu_refs_stop, dom_procs)
    gravity_phase(report)
    cli_phase(report)
    turb_phase(report, rows)
    tier_phase(report, rows)
    cool_phase(report)
    multi_phase(report, rows)
    dom_phase(report, rows, dom_procs)
    bigcap_phase(report, rows)

    report["smi"] = smi
    report["device"] = torch.cuda.get_device_name(0)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    log(json.dumps({"kernels": rows}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
