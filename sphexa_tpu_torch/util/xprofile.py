"""Per-kernel times from a torch.profiler trace (--profile).

Counterpart of sphexa_tpu/util/xprofile.py, which sums the TPU device
plane of a jax.profiler trace (the analog of the reference's per-substage
Timer table, main/src/util/timer.hpp:30). Here torch.profiler records
the run: `start_trace` before the loop, `stop_trace` after it writes a
chrome trace under ./sphexa-trace, and `print_table` prints the same
ms-a-step table with its `calls` column.

On the card the table sums the device activities (kernels, copies,
sets) by name; on the CPU, where there are none, it sums the top-level
CPU ops (those not inside another op of the same thread, so nested ops
are not counted twice). The events are read raw from
`prof.profiler.kineto_results.events()`: `prof.events()` builds a
Python object for each activity, which takes minutes on a run of ~6e5.
"""

from __future__ import annotations

import collections
import os

import torch

TRACE_DIR = "sphexa-trace"


def start_trace(device) -> "torch.profiler.profile":
    """A started profiler: CPU ops, and the device's activities when
    `device` is a CUDA device."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def stop_trace(prof) -> str:
    """Stop the profiler and write its chrome trace into ./sphexa-trace;
    returns the trace file's path."""
    prof.stop()
    os.makedirs(TRACE_DIR, exist_ok=True)
    path = os.path.join(TRACE_DIR, "trace.json")
    prof.export_chrome_trace(path)
    return path


def short_name(name: str) -> str:
    """A kernel's demangled name without its return type, its argument
    list and `(anonymous namespace)::`: `tile::cell_tile<GradhStage,
    false, false>` for K4."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i].rstrip() or name
                break
    return name


def _top_level(events):
    """The events not nested inside another event of the same thread."""
    out = []
    by_thread = collections.defaultdict(list)
    for e in events:
        by_thread[e.start_thread_id()].append(e)
    for evs in by_thread.values():
        end = -1
        for e in sorted(evs, key=lambda e: (e.start_ns(), -e.duration_ns())):
            if e.start_ns() >= end:
                out.append(e)
                end = e.start_ns() + e.duration_ns()
    return out


def device_op_times(prof):
    """(totals_ms, counts, plane) by short_name: the device activities
    (plane "device") when the profile holds any, else the top-level CPU
    ops (plane "cpu")."""
    events = prof.profiler.kineto_results.events()
    dev = [e for e in events
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    plane = "device"
    if not dev:
        plane = "cpu"
        dev = _top_level([e for e in events
                          if e.device_type() == torch.autograd.DeviceType.CPU
                          and e.name().startswith("aten::")])
    totals = collections.defaultdict(float)
    counts = collections.defaultdict(int)
    for e in dev:
        name = short_name(e.name())
        totals[name] += e.duration_ns() * 1e-6
        counts[name] += 1
    return totals, counts, plane


def print_table(prof, steps: int = 1, min_ms: float = 0.01, out=print):
    """Print a per-kernel (per-op on the CPU) ms/step table sorted by
    cost, with each name's calls over the whole trace. Names under
    min_ms a step are summed on one line: the JAX table's 0.5 ms would
    hide the ghost refresh K1 (~0.04 ms a step at Sedov 100^3 on the
    H100)."""
    totals, counts, plane = device_op_times(prof)
    if not totals:
        out("# no device activity or CPU op in the profile")
        return
    rows = sorted(totals.items(), key=lambda kv: -kv[1])
    out(f"# {plane + ' op':56s} {'ms/step':>9s} {'calls':>6s}")
    other = 0.0
    total = 0.0
    for name, ms in rows:
        total += ms / steps
        if ms / steps < min_ms:
            other += ms / steps
            continue
        out(f"# {name[:56]:56s} {ms / steps:9.2f} {counts[name]:6d}")
    out(f"# {'(ops below threshold)':56s} {other:9.2f}")
    label = ("TOTAL device" if plane == "device"
             else "TOTAL cpu (top-level ops)")
    out(f"# {label:56s} {total:9.2f}")
