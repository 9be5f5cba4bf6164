"""The tile adapter's halo cap against the JAX adapter's, and the tile
step on windows wider than the periodic box against the port's
single-device step.

1. Sedov 10^3 on 2 shards (1 x 2 tiles on CMGrid(n=2, cap=256)): each
   tile's z-range grown by one cell covers the periodic box and one cell
   more, so each tile's halo is the other tile's 500 rows twice (at both
   ends of the window: plainly and through the seam), 1000 rows. The
   JAX adapter's halo_cap, max(0.6 N / D, 256) rounded up to 8 = 304
   (multichip.py:230), is below it: the step on that TileDomain drops
   the rows past the cap and counts them in `lost`, so the run
   fail-stops at its first step. The port's adapter raises the cap to
   1.3 x the halo measured on the initial tiles (plan_tile_halo) + 64
   and runs; every other field of its TileDomain is the JAX adapter's
   (ROADMAP Queue 3). No interpret-mode JAX program runs here: the JAX
   adapter is built (it plans without stepping) and stopped at its
   distribution.
2. Sedov 8^3 on CMGrid(n=2, cap=128) at D = 2 (1 x 2) and D = 4 (2 x 2),
   each window exactly the widest tile and its two halo cells (3 cells,
   one more than the box): the tile step against make_ve_step_cellmajor
   on the same global grid, 2 steps, the particles matched by position.
   dt, eint, ecin and etot within rtol 1e-5, every field within 1e-5 of
   its scale, lost 0, span_ok, all particles owned. The JAX step sends
   the rows of a window's end cells once (ve_pallas_tiles.py:191
   _wrap_shift), so the rows by the seam lose their neighbours across
   it (ROADMAP Queue 3); the port's step sending one copy, as the JAX
   step does, puts alpha 0.155 of its scale and ecin 5.7e-4 (relative)
   off the single-device step at D = 2, and 0.234 and 1.1e-3 at D = 4.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.init.sedov import init_sedov as j_init_sedov
from sphexa_tpu.propagator import multichip as jmc
from sphexa_tpu.propagator import ve_pallas_tiles as J
from sphexa_tpu.state import _FIELDS
from sphexa_tpu_torch.domain.mesh import SlabMesh
from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.init.sedov import init_sedov
from sphexa_tpu_torch.interop import (box_from_numpy, config_from_dict,
                                      state_from_numpy)
from sphexa_tpu_torch.ops.cellmajor import CMGrid
from sphexa_tpu_torch.propagator import multichip as tmc
from sphexa_tpu_torch.propagator import ve_pallas_tiles as T
from sphexa_tpu_torch.propagator.ve_cellmajor import make_ve_step_cellmajor
from sphexa_tpu_torch.state import SimState
from torch_threads import two_torch_threads  # noqa: F401


def test_halo_cap_from_the_measured_halo(monkeypatch):
    state, jb, cfg = j_init_sedov(10, JCfg(), dt0=2e-4)
    h_max = float(np.asarray(state.p.h).max())
    devs = jax.devices()[:2]
    seen = {}

    def spy(host, box, td, mesh):
        seen["td"] = td
        raise StopIteration

    with monkeypatch.context() as m:
        m.setattr(jax, "devices", lambda *a: devs)
        m.setattr(J, "distribute_tiles", spy)
        with pytest.raises(StopIteration):
            jmc.MultiChipAdapter("ve-pallas-tiles", jb, cfg, state, h_max)
    jtd = seen["td"]
    assert (jtd.n_rows, jtd.n_cols, jtd.n, jtd.halo_cap) == (1, 2, 2, 304)

    monkeypatch.setenv("SPHEXA_NUM_DEVICES", "2")
    box = box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                          jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    ts = state_from_numpy({f: np.asarray(getattr(state.p, f))
                           for f in _FIELDS}, 0.0, float(state.dt),
                          float(state.dt_m1), 0, device="cpu")
    ad = tmc.MultiChipAdapter("ve-pallas-tiles", box, tcfg, ts, h_max,
                              device="cpu")
    host = {f: getattr(ts.p, f).numpy() for f in "xyz"}
    halo = T.plan_tile_halo(box, dict(n=2, n_rows=1, n_cols=2),
                            host["x"], host["y"], host["z"])
    assert halo == 1000
    assert ad.td == T.TileDomain(**dict(dataclasses.asdict(jtd),
                                        halo_cap=1368))   # 1364 up to 8

    # the step on the JAX adapter's TileDomain loses the rows past 304
    mesh = SlabMesh(2, devices=["cpu"])
    td = T.TileDomain(**dataclasses.asdict(jtd))
    parts = T.distribute_tiles({f: getattr(ts.p, f).numpy()
                                for f in _FIELDS[:-1]}, box, td, mesh)
    step = T.make_ve_step_pallas_tiles(box, td, ad.grid.cap, tcfg, mesh)
    _, d = step([SimState(p=p, ttot=ts.ttot, dt=ts.dt, dt_m1=ts.dt_m1,
                          iteration=ts.iteration) for p in parts])
    assert int(d.lost) == 2 * (1000 - 304)
    assert bool(d.span_ok) and int(d.n_total) == 1000

    # the port's adapter: lost 0 (it fail-stops otherwise), every row
    st, diag = ad(ts)
    assert int(diag.raw.lost) == 0 and int(diag.raw.n_total) == 1000
    assert int(st.p.alive.sum()) == 1000


@pytest.mark.parametrize("R,C", [(1, 2), (2, 2)])
def test_wide_windows_against_single_device(R, C):
    side, n, cap, steps = 8, 2, 128, 2
    state, box, cfg = init_sedov(side, SphConfig(cell_cap=256, ngpad=256),
                                 dt0=2e-4, device="cpu")
    step1 = make_ve_step_cellmajor(box, CMGrid(n=n, cap=cap), cfg,
                                   device="cpu")
    s1 = state
    for _ in range(steps):
        s1, d1 = step1(s1)

    host = {f: getattr(state.p, f).numpy() for f in _FIELDS[:-1]}
    part = dict(n=n, n_rows=R, n_cols=C)
    rows_cap, zcols_cap = T.plan_tile_caps(box, part, host["x"], host["y"],
                                           host["z"])
    assert max(rows_cap if R > 1 else 0, zcols_cap) == n + 1
    D, N = R * C, side ** 3
    td = T.TileDomain(n_rows=R, n_cols=C, n=n, cap=N * 2 // D + 256,
                      halo_cap=T.plan_tile_halo(box, part, host["x"],
                                                host["y"], host["z"]),
                      mig_cap=512, rows_cap=rows_cap, zcols_cap=zcols_cap)
    mesh = SlabMesh(D, devices=["cpu"])
    states = [SimState(p=p, ttot=state.ttot.clone(), dt=state.dt.clone(),
                       dt_m1=state.dt_m1.clone(),
                       iteration=state.iteration.clone())
              for p in T.distribute_tiles(host, box, td, mesh)]
    stepN = T.make_ve_step_pallas_tiles(box, td, cap, cfg, mesh)
    for _ in range(steps):
        states, dN = stepN(states)
    assert int(dN.lost) == 0 and int(dN.overflow) == 0
    assert bool(dN.span_ok) and int(dN.n_total) == N
    for k in ("dt", "eint", "ecin", "etot"):
        np.testing.assert_allclose(float(getattr(dN, k)),
                                   float(getattr(d1, k)), rtol=1e-5,
                                   err_msg=k)
    alive = torch.cat([s.p.alive for s in states]).numpy()
    b = {f: torch.cat([getattr(s.p, f) for s in states]).numpy()[alive]
         for f in _FIELDS[:-1]}
    a = {f: getattr(s1.p, f).numpy() for f in _FIELDS[:-1]}
    dist, j = cKDTree(np.c_[a["x"], a["y"], a["z"]]).query(
        np.c_[b["x"], b["y"], b["z"]])
    assert dist.max() < 1e-6
    assert len(np.unique(j)) == len(j) == N
    for f in _FIELDS[:-1]:
        scale = max(np.abs(a[f]).max(), 1e-12)
        err = np.abs(b[f] - a[f][j]).max() / scale
        assert err < 1e-5, (f, err)
