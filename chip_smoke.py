#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sphexa_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from sphexa_tpu_torch/csrc (nvcc, in parallel);
  3. kernel check at Sedov 30^3: every kernel against its plain PyTorch
     version on identical, perturbed inputs, with the CPU tests'
     tolerances; then the resident engine on the card against the same
     engine on the CPU (plain versions) for 3 steps at Sedov 10^3;
  4. the main path: ResidentVE on the card at Sedov 100^3 (1M particles),
     one warm-up step, then 10 timed steps with a forced rebin; launch
     counters are zeroed just before and read just after;
  5. each kernel timed at the main path's own inputs, beside its plain
     version, its bound and (K1) a library gather;
  6. the kernel table as one JSON line, then the device line.
Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
CHECK_SIDE = 30       # kernel check (perturbed Sedov)
MAIN_SIDE = 100       # main path: 1M particles, bench.py's Sedov size

# published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, and device-memory bandwidth
FP32_PEAK = 67e12
HBM_BW = 3.35e12

# float operations per pair (FMA = 2, divide/sqrt/exp/log = 1), counted
# from csrc/cell_pair.cu: GEO for every candidate's distance test, BODY
# for each candidate inside the support, RECOUNT for each further
# neighbour count of K3 (d2 held: a multiply by 1/h^2 and a compare)
GEO_FLOPS = 9
RECOUNT_FLOPS = 2
BODY_FLOPS = {"pair_xh": 18, "pair_gradh": 40, "pair_iad": 62,
              "pair_av": 55, "pair_momentum": 170}
REPLACES = {
    "ghost_refresh": "sphexa_tpu/ops/pallas_ve.py:349",
    "pair_xh": "sphexa_tpu/ops/pallas_ve.py:537",
    "pair_gradh": "sphexa_tpu/ops/pallas_ve.py:622",
    "pair_iad": "sphexa_tpu/ops/pallas_ve.py:704",
    "pair_av": "sphexa_tpu/ops/pallas_ve.py:900",
    "pair_momentum": "sphexa_tpu/ops/pallas_ve.py:1022",
}

# output rows compared as one group (a matrix or vector is compared at
# its own scale: near-zero components such as curlv of a radial flow or
# the off-diagonal IAD terms of a lattice carry only sum-order noise)
GROUPS = {"pair_xh": [[0], [1]], "pair_gradh": [[0], [1]],
          "pair_iad": [list(range(6)), list(range(6, 14))],
          "pair_av": [[0]], "pair_momentum": [[0, 1, 2], [3], [4]]}
EXACT = {"pair_xh": [2, 3]}                       # nc, nonconv
RELATIVE = {"pair_xh": [0, 1], "pair_gradh": [0, 1], "pair_av": [0],
            "pair_momentum": [4]}                 # rtol 1e-5


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()                                      # warm-up
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def compare(name, ref, out, mask, per_row: bool):
    """(max abs error, max error relative to its row's scale) on interior
    valid slots; raises past tolerance. per_row: each cancelling row at
    its own scale (perturbed inputs, as the CPU tests); else each group
    at the group's scale."""
    import torch
    ref, out = ref[:, mask].double(), out[:, mask].double()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (ref - out).abs()
    rel = float((err.amax(1) / ref.abs().amax(1).clamp_min(1e-30)).max())
    for r in EXACT.get(name, []):
        if err[r].max() != 0:
            raise AssertionError(f"{name}: row {r} not exact "
                                 f"({int((err[r] > 0).sum())} slots)")
    rel_rows = RELATIVE.get(name, [])
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


class Spy:
    """Records every launch of the port's kernels (inputs and output)."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.calls = []

    def __enter__(self):
        for k in self.kernels:
            orig = type(k)._launch

            def launch(*args, k=k, orig=orig):
                if k.name == "ghost_refresh":
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


def sedov(side, device, perturb_seed=None):
    import torch
    from sphexa_tpu_torch.config import SphConfig
    from sphexa_tpu_torch.init.sedov import init_sedov
    from sphexa_tpu_torch.ops.cellmajor import choose_cap_and_grid

    state, box, cfg = init_sedov(side, SphConfig(), dt0=3e-5, device=device)
    n = side ** 3
    if perturb_seed is not None:
        r = np.random.default_rng(perturb_seed)
        h0 = float(state.p.h[0])
        p = state.p
        upd = {c: getattr(p, c) + torch.from_numpy(
            r.normal(0, 0.03 * h0, n).astype(np.float32)).to(device)
            for c in "xyz"}
        upd.update({c: torch.from_numpy(r.normal(0, 0.3, n).astype(
            np.float32)).to(device) for c in ("vx", "vy", "vz")})
        upd["alpha"] = torch.from_numpy(r.uniform(0.05, 0.5, n).astype(
            np.float32)).to(device)
        state = state.replace(p=p.replace(**upd))
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
        errs[k.name] = dict(max_abs_err=err, max_rel_err=rel)
        log(f"  {CHECK_SIDE}^3 {k.name:14s} max abs err {err:.3e}, "
            f"max rel err (to row scale) {rel:.3e}")
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


def engine_check(report):
    """Phase 3b: the whole resident step on the card against the same
    engine on the CPU (plain versions), Sedov 10^3, 3 steps, forced
    rebin; bounds of tests/test_torch_resident.py."""
    from sphexa_tpu_torch.propagator.ve_cellmajor import ResidentVE

    diags = {}
    for dev in (DEVICE, "cpu"):
        state, box, cfg, grid = sedov(10, dev)
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
    log(f"  10^3 engine {DEVICE} vs cpu, 3 steps: dt {b['dt']:.6e} vs "
        f"{a['dt']:.6e}, eint {b['eint']:.9f} vs {a['eint']:.9f}")
    report["engine_10"] = diags


def main_path(report):
    """Phase 4: Sedov 100^3 on the resident engine, 10 timed steps."""
    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv
    from sphexa_tpu_torch.propagator.common import compute_energies
    from sphexa_tpu_torch.propagator.ve_cellmajor import ResidentVE

    side, steps, rebin_at = MAIN_SIDE, 10, 5
    t0 = time.perf_counter()
    state, box, cfg, grid = sedov(side, DEVICE)
    e0 = float(sum(compute_energies(state.p, cfg)))
    eng = ResidentVE(box, grid, cfg, device=DEVICE)
    rst = eng.bind(state)
    assert int(rst.overflow) == 0, "slot overflow at bind"
    rst, _ = eng.step(rst)                   # warm-up
    torch.cuda.synchronize()
    log(f"  setup + warm-up {time.perf_counter() - t0:.1f} s; cap "
        f"{grid.cap}, grid {grid}, n_slots {grid.n_slots}")

    for k in pv.KERNELS:
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
    launches = {k.name: k.launches for k in pv.KERNELS}

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
    for name, want in (("ghost_refresh", 5 * steps),) + tuple(
            (k.name, steps) for k in pv.KERNELS[1:]):
        assert launches[name] == want, (name, launches[name], want)
    mean_ms = float(np.mean(step_ms))
    log(f"  {side}^3: {mean_ms:.3f} ms/step (CUDA events, mean of {steps}; "
        f"steps {[round(s, 3) for s in step_ms]}), "
        f"{n / (mean_ms * 1e-3):.4e} particle-updates/s")
    log(f"  |etot - e0|/e0 = {drift:.3e}; h_nonconv {d['h_nonconv']}; "
        f"launches {launches}")
    report["main_path"] = dict(
        side=side, n=n, cap=grid.cap, grid=str(grid), n_slots=grid.n_slots,
        steps=steps, rebin_at=rebin_at, step_ms=step_ms, mean_step_ms=mean_ms,
        particle_updates_per_s=n / (mean_ms * 1e-3), e0=e0,
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


def xh_recounts(J, out, grid, cfg, per_slot):
    """Candidates K3 must count again on these inputs: d2 is computed
    once, and a slot needs one more count over its candidates for each
    controller round that changed its h (read off the plain version run
    with 1..h_iter-1 rounds; round h_iter gives the kernel's own h)."""
    import dataclasses
    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv

    hs = [J[pv.RH]]
    for t in range(1, cfg.h_iter):
        hs.append(pv.pair_xh.plain(J, None, grid,
                                   dataclasses.replace(cfg, h_iter=t))[1])
    hs.append(out[1])
    rounds = sum((a != b).double() for a, b in zip(hs, hs[1:]))
    return float((rounds * per_slot).sum()), int((rounds > 0)[
        per_slot > 0].sum())


def timing(report, eng, rst, grid, launches):
    """Phase 5: each kernel at the main path's inputs of one step."""
    import torch
    from sphexa_tpu_torch.ops import pair_ve as pv

    with Spy(pv.KERNELS) as spy:
        eng.step(rst)
    torch.cuda.synchronize()
    rows = []
    ghost_calls = [c for c in spy.calls if c[0].name == "ghost_refresh"]
    pair_calls = [c for c in spy.calls if c[0].name != "ghost_refresh"]
    xh_out = next(out for k, _, out in pair_calls if k.name == "pair_xh")
    nc_sph = xh_out[2] + 1
    xh_J, _, _, xh_cfg = next(a for k, a, _ in pair_calls
                              if k.name == "pair_xh")
    cand, inside, per_slot = pair_counts(xh_J, eng, grid, nc_sph)
    recount, moved = xh_recounts(xh_J, xh_out, grid, xh_cfg, per_slot)
    report["pairs"] = dict(candidates=cand, in_support=inside,
                           xh_recount_candidates=recount, xh_h_moved=moved)
    log(f"  pairs: {cand:.4e} valid candidates, {inside:.4e} in support; "
        f"xmass: h moved on {moved} slots, {recount:.4e} candidates "
        f"counted again")

    for k, (J, I2, g, c), out in pair_calls:
        ref = k.plain(J, I2, g, c)
        err, rel = compare(k.name, ref, out, valid_slots(J) & eng.intmask,
                           per_row=False)
        ms = cuda_ms(lambda: k._launch(J, I2, g, c), 5)
        plain_ms = cuda_ms(lambda: k.plain(J, I2, g, c), 1)
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
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
    _cuda.build()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f} s")
    for src, info in _cuda.build_info.items():
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")
    report["build_seconds"] = build_s
    report["ptxas"] = {s: i["ptxas"] for s, i in _cuda.build_info.items()}

    log("kernel check:")
    kernel_check(report)
    engine_check(report)
    log("main path:")
    eng, rst, grid, launches = main_path(report)
    log("timing:")
    rows = timing(report, eng, rst, grid, launches)

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
