"""A dry run of the multi-device paths: the port's counterpart of
dryrun_multichip in the JAX package's __graft_entry__.py (:43-215).

    python -m sphexa_tpu_torch.dryrun 4            # on the GPU
    python -m sphexa_tpu_torch.dryrun 2 --cpu      # on the CPU

Three legs, each at the JAX dry run's sizes, on n_devices shards
(domain/mesh.SlabMesh; on one card every shard is a thread on cuda:0):

  1. the slab-sharded cell-major step (K1z, K3-K7) on Sedov 16^3:
     migration, the per-stage z-plane exchanges, pmin and psum;
  2. the Hilbert-quantile domain (psum'd key histogram splits,
     all_to_all migration, coarse-grid halo discovery) on the clustered
     Evrard 20 sphere, with self-gravity through the generic sharded
     FMM (level 3);
  3. one ShardedBdtVE rung cycle (2 rungs) on Sedov 10^3, its rung
     histogram at every substep equal to the single-device BdtVE's on
     the same state.

Each leg asserts its fail-stops (no lost row, no slot overflow, every
particle owned once) and finite energies, and prints one line. The slab
leg's global grid has n = max(D, 4) cells a side where the JAX leg has
n = D: at D = 2 the JAX leg's 8 cells would hold 512 rows each, past
its cap of 128 (ROADMAP Queue 3).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _leg_slab(D: int, mesh, device) -> dict:
    from sphexa_tpu_torch.config import SphConfig
    from sphexa_tpu_torch.domain.slab import SlabConfig
    from sphexa_tpu_torch.init.sedov import init_sedov
    from sphexa_tpu_torch.ops.cellmajor import CMGrid
    from sphexa_tpu_torch.propagator.multichip import _host_fields
    from sphexa_tpu_torch.propagator.ve_pallas_sharded import \
        make_ve_step_pallas_sharded
    from sphexa_tpu_torch.propagator.ve_sharded import distribute
    from sphexa_tpu_torch.state import SimState

    side = 16
    cfg = SphConfig(chunk=512, cell_cap=96, ngpad=160)
    state, box, cfg = init_sedov(side, cfg, dt0=1e-5, device=device)
    n = side ** 3
    ng = max(D, 4)
    grid = CMGrid(n=ng, cap=128, nzi=max(ng // D, 1))
    sc = SlabConfig(n_slabs=D, cap=int(n / D * 2) + 64, halo_cap=64,
                    mig_cap=128)
    parts = distribute(_host_fields(state.p), box, sc, mesh)
    states = [SimState(p=p, ttot=state.ttot.to(p.device),
                       dt=state.dt.to(p.device),
                       dt_m1=state.dt_m1.to(p.device),
                       iteration=state.iteration.to(p.device))
              for p in parts]
    step = make_ve_step_pallas_sharded(box, grid, cfg, sc, mesh)
    states, d = step(states)
    assert int(d.lost) == 0, f"migration lost {int(d.lost)} particles"
    assert int(d.overflow) == 0, "cm slot overflow"
    assert int(d.n_owned) == n, (int(d.n_owned), n)
    assert np.isfinite(float(d.etot))
    return dict(n=n, etot=float(d.etot), dt=float(d.dt))


def _leg_hilbert(D: int, mesh, device) -> dict:
    from sphexa_tpu_torch.config import SphConfig
    from sphexa_tpu_torch.domain.hilbert import HilbertConfig
    from sphexa_tpu_torch.init.evrard import init_evrard
    from sphexa_tpu_torch.neighbors import CellGrid, choose_level
    from sphexa_tpu_torch.propagator.multichip import _host_fields
    from sphexa_tpu_torch.propagator.ve_hilbert import (distribute_hilbert,
                                                        make_ve_step_hilbert)
    from sphexa_tpu_torch.state import SimState

    cfg = SphConfig(chunk=512, cell_cap=768, ngpad=256, gravG=1.0,
                    gravity_solver="fmm", fmm_level=3, eps=0.05)
    state, box, cfg = init_evrard(20, cfg, dt0=1e-4, device=device)
    host = _host_fields(state.p)
    n = len(host["x"])
    grid = CellGrid(choose_level(box, float(host["h"].max()) * 1.3))
    # the gather capacity from the realized occupancy (+33%)
    nd = grid.cells_per_dim
    ii = [np.clip(((host[c] - lo) / ln * nd).astype(int), 0, nd - 1)
          for c, lo, ln in (("x", box.xmin, box.lx), ("y", box.ymin, box.ly),
                            ("z", box.zmin, box.lz))]
    occ = np.bincount((ii[0] * nd + ii[1]) * nd + ii[2],
                      minlength=nd ** 3)
    cfg = cfg.replace(cell_cap=int(np.ceil(occ.max() * 1.33 / 32) * 32))
    hc = HilbertConfig(n_ranks=D, cap=int(n / D * 3) + 128,
                       halo_cap=int(n / D * 2.5) + 128, mig_cap=256,
                       coarse=8, dilate=3)
    parts = distribute_hilbert(host, box, hc, mesh)
    states = [SimState(p=p, ttot=state.ttot.to(p.device),
                       dt=state.dt.to(p.device),
                       dt_m1=state.dt_m1.to(p.device),
                       iteration=state.iteration.to(p.device))
              for p in parts]
    states, d = make_ve_step_hilbert(box, grid, cfg, hc, mesh)(states)
    assert int(d.lost) == 0, f"hilbert lost {int(d.lost)}"
    assert int(d.n_owned) == n, (int(d.n_owned), n)
    assert np.isfinite(float(d.etot))
    return dict(n=n, imbalance=float(d.imbalance), etot=float(d.etot))


def _leg_bdt(D: int, mesh, device) -> dict:
    from sphexa_tpu_torch.config import SphConfig
    from sphexa_tpu_torch.domain.slab import SlabConfig
    from sphexa_tpu_torch.init.sedov import init_sedov
    from sphexa_tpu_torch.ops.cellmajor import CMGrid
    from sphexa_tpu_torch.propagator.ve_bdt import BdtVE
    from sphexa_tpu_torch.propagator.ve_bdt_sharded import ShardedBdtVE

    cfg = SphConfig(cell_cap=256, ngpad=256)
    state, box, cfg = init_sedov(10, cfg, dt0=2e-4, device=device)
    n = 10 ** 3
    ng = max(4, D)
    one = BdtVE(box, CMGrid(n=ng, cap=128), cfg, num_rungs=2,
                device=device)
    _, diags1 = one.run_cycle(one.bind_bdt(state))
    state_b, _, _ = init_sedov(10, cfg, dt0=2e-4, device=device)
    sc = SlabConfig(n_slabs=D, cap=(n // D) * 2 + 64, halo_cap=64,
                    mig_cap=128)
    eng = ShardedBdtVE(box, CMGrid(n=ng, cap=128, nzi=max(ng // D, 1)),
                       cfg, sc, mesh, num_rungs=2)
    _, diagsN = eng.run_cycle(eng.distribute_bind(state_b))
    assert int(diagsN[-1].overflow) == 0, "sharded BDT slot overflow"
    hists = []
    for d1, dN in zip(diags1, diagsN):
        h1, hN = d1.rung_hist.cpu().numpy(), dN.rung_hist.cpu().numpy()
        assert (h1 == hN).all(), (
            f"rung histogram diverged: one device {h1.tolist()} vs "
            f"{D} shards {hN.tolist()}")
        hists.append(hN.tolist())
    fr = [float(d.active_frac) for d in diagsN]
    return dict(n=n, rung_hist=hists, active_frac=[min(fr), max(fr)])


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The three legs on n_devices shards of `device` (default: the
    GPU). Returns each leg's figures and seconds; raises on a failed
    check."""
    from sphexa_tpu_torch.domain.mesh import SlabMesh
    from sphexa_tpu_torch.util.device import resolve_device

    device = resolve_device(device)
    mesh = SlabMesh(n_devices, devices=[device])
    out = {}
    for name, leg, what in (
            ("slab", _leg_slab, "slab-sharded cell-major step"),
            ("hilbert", _leg_hilbert, "balanced Hilbert domain + gravity on "
                                      "clustered Evrard"),
            ("bdt", _leg_bdt, "sharded BDT cycle (== one device)")):
        t0 = time.perf_counter()
        r = leg(n_devices, mesh, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        r["seconds"] = time.perf_counter() - t0
        out[name] = r
        print(f"dryrun_multichip({n_devices}): ok: {what}, "
              + ", ".join(f"{k}={v}" for k, v in r.items()), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=4)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    a = ap.parse_args()
    dryrun_multichip(a.n_devices, device="cpu" if a.cpu else None)
