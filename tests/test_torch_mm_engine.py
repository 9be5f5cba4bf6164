"""The port's resident engine under the moment-matmul configuration
(SphConfig(mxu_moments=True, mxu_momentum=True): K8, K9 and K10)
against the JAX ResidentVE with the same options (Pallas in interpret
mode), from the same Sedov 10^3 state, 3 steps with a forced rebin at
step 1, on two grids: CMGrid(n=2, cap=128) (2 cells a side, each half
the box) and CMGrid(n=4, cap=128).

Bounds, and why:
  - dt rtol 1e-5, eint rtol 1e-6, ecin rtol 1e-3, h_max rtol 1e-5, equal
    rebin flags and h_nonconv, and the unbound x, y, z, vx, temp, h within
    2e-3 of their scale: those of tests/test_torch_resident.py.
  - alpha, 1e-4 of its scale. The moment bodies expand every pair sum
    about the i-cell's mean, and the centred moments cancel when the cell
    is wide against h: K8's divv then carries a rounding noise of a few
    1e-6 (here, against divv values up to 2.4). Where |divv| is within a
    few noise amplitudes of zero, the sign of divv (which switches
    alphaloc on) and graddivv (a difference of such divv values) are
    noise, so alpha there depends on the summation order. JAX's own mm
    run with another expansion origin (SPHEXA_IBLOCK 64: two origins per
    128-slot cell) moves alpha by up to 0.40 at those slots.
    On n = 2 the slots compared are those whose JAX |divv| stays above
    the noise floor at every step that has a velocity field (steps 1
    and 2; step 0 starts at rest, divv = 0): the floor is 4 x K8's noise
    amplitude, the largest |divv| difference between the JAX mm runs at
    SPHEXA_IBLOCK 128 and 64 (3.3e-6 on this run, so the floor is
    1.3e-5; 304 of 1000 particles excluded). The largest |divv| among the
    slots whose alpha flips between those two runs (5.6e-8) is too low a
    floor: JAX against JAX differs by 4.5e-4 of alpha's scale at the
    slots it keeps, and the port's flips reach |divv| 9.0e-8. With the
    4x floor the kept slots agree within 4.0e-5 (JAX IB 64 against
    IB 128: 3.2e-5).
    On n = 4 (cell edge 1/4) every slot is compared, with no exclusion:
    the port is within 6.9e-5 of alpha's scale there.
  (All figures: my CPU runs, in this file's setting.)
The JAX runs are made once per module; the n = 2 runs capture the
per-step divv through a debug callback on the JAX step's pipeline.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sphexa_tpu.propagator.ve_pallas as jvp
from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.init.sedov import init_sedov as j_init_sedov
from sphexa_tpu.ops import cellmajor as jcm
from sphexa_tpu.state import _FIELDS
from sphexa_tpu_torch.interop import (box_from_numpy, config_from_dict,
                                      state_from_numpy)
from sphexa_tpu_torch.ops.cellmajor import CMGrid
from sphexa_tpu_torch.propagator.ve_cellmajor import ResidentVE
from torch_threads import one_torch_thread  # noqa: F401

N_STEPS = 3
FORCE_REBIN_AT = 1
MM = dict(mxu_moments=True, mxu_momentum=True)
NOISE_FACTOR = 4.0


def _jax_run(state, jb, cfg, grid, iblock, capture):
    """The JAX engine for N_STEPS; with capture, the divv row and the gid
    row of every step's pipeline."""
    store = []
    orig = jvp._run_pipeline

    def run_pipeline(pve, refresh, base, *args):
        out = orig(pve, refresh, base, *args)
        jax.debug.callback(
            lambda d, g: store.append((np.asarray(d), np.asarray(g))),
            out["divv"], base[4])
        return out

    old_ib = os.environ.get("SPHEXA_IBLOCK")
    os.environ["SPHEXA_IBLOCK"] = str(iblock)
    if capture:
        jvp._run_pipeline = run_pipeline
    try:
        eng = jvp.ResidentVE(jb, grid, cfg, interpret=True)
        r = eng.bind(state)
        diags = []
        for i in range(N_STEPS):
            if i == FORCE_REBIN_AT:
                r = r.replace(drift=jnp.float32(1e9))
            r, d = eng.step(r)
            diags.append({k: np.asarray(v) for k, v in d._asdict().items()})
        out = eng.unbind(r, state.p.n)
        jax.effects_barrier()
    finally:
        jvp._run_pipeline = orig
        if old_ib is None:
            os.environ.pop("SPHEXA_IBLOCK")
        else:
            os.environ["SPHEXA_IBLOCK"] = old_ib
    fields = {f: np.asarray(getattr(out.p, f)) for f in _FIELDS}
    return dict(diags=diags, fields=fields, divv=store)


def _port_run(state, jb, cfg, grid):
    host = ({f: np.asarray(getattr(state.p, f)) for f in _FIELDS},
            float(state.ttot), float(state.dt), float(state.dt_m1),
            int(state.iteration))
    tbox = box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                           jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])
    eng = ResidentVE(tbox, CMGrid(n=grid.n, cap=grid.cap),
                     config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    assert [k.name for k in eng.pve.kernels][2:] == [
        "pair_iad_mm", "pair_av_mm", "pair_momentum_mm"]
    ts = state_from_numpy(*host, device="cpu")
    r = eng.bind(ts)
    diags = []
    for i in range(N_STEPS):
        if i == FORCE_REBIN_AT:
            r = r.replace(drift=r.drift.new_tensor(1e9))
        r, d = eng.step(r)
        diags.append({k: np.asarray(v) for k, v in d._asdict().items()})
    out = eng.unbind(r, ts.p.n)
    return dict(diags=diags,
                fields={f: getattr(out.p, f).numpy() for f in _FIELDS})


def _per_particle(grid, divv, gid, n):
    """A cm-frame divv row on the particles (interior valid slots)."""
    out = np.full(n, np.nan)
    m = np.asarray(jcm.interior_mask(grid)) & (gid >= 0)
    out[gid[m].astype(np.int64)] = divv[m]
    return out


@pytest.fixture(scope="module")
def runs():
    state, jb, cfg = j_init_sedov(10, JCfg(), dt0=2e-4)
    cfg = cfg.replace(**MM)
    res = {}
    for name, n in (("n2", 2), ("n4", 4)):
        grid = jcm.CMGrid(n=n, cap=128)
        res[name] = dict(grid=grid,
                         jax=_jax_run(state, jb, cfg, grid, 128, n == 2),
                         port=_port_run(state, jb, cfg, grid))
    g2 = res["n2"]["grid"]
    res["n2"]["jax64"] = _jax_run(state, jb, cfg, g2, 64, True)
    return res


@pytest.mark.parametrize("step", range(N_STEPS))
@pytest.mark.parametrize("grid", ["n2", "n4"])
def test_step_diagnostics(runs, grid, step):
    a = runs[grid]["jax"]["diags"][step]
    b = runs[grid]["port"]["diags"][step]
    assert int(b["overflow"]) == int(a["overflow"]) == 0
    assert bool(b["rebinned"]) == bool(a["rebinned"])
    if step == FORCE_REBIN_AT:
        assert bool(b["rebinned"])
    np.testing.assert_allclose(b["dt"], a["dt"], rtol=1e-5)
    np.testing.assert_allclose(b["eint"], a["eint"], rtol=1e-6)
    np.testing.assert_allclose(b["ecin"], a["ecin"], rtol=1e-3, atol=1e-12)
    np.testing.assert_allclose(b["h_max"], a["h_max"], rtol=1e-5)
    assert int(b["h_nonconv"]) == int(a["h_nonconv"])


@pytest.mark.parametrize("grid", ["n2", "n4"])
def test_unbound_fields(runs, grid):
    a, b = runs[grid]["jax"]["fields"], runs[grid]["port"]["fields"]
    np.testing.assert_array_equal(b["alive"], a["alive"])
    for f in ("x", "y", "z", "vx", "temp", "h"):
        scale = max(np.abs(a[f]).max(), 1e-12)
        assert np.abs(b[f] - a[f]).max() / scale < 2e-3, f


def test_alpha_n2_above_noise_floor(runs):
    r = runs["n2"]
    grid, n = r["grid"], r["jax"]["fields"]["alpha"].shape[0]

    def divv_steps(run):
        return np.stack([_per_particle(grid, d, g, n)
                         for d, g in run["divv"][1:]])

    d128, d64 = divv_steps(r["jax"]), divv_steps(r["jax64"])
    assert len(r["jax"]["divv"]) == len(r["jax64"]["divv"]) == N_STEPS
    noise = np.nanmax(np.abs(d64 - d128))
    floor = NOISE_FACTOR * noise
    excluded = (np.abs(d128) <= floor).any(0)
    a = r["jax"]["fields"]["alpha"]
    b = r["port"]["fields"]["alpha"]
    scale = np.abs(a).max()
    err = np.abs(b - a)[~excluded].max() / scale
    print(f"n2: K8 noise {noise:.3e}, floor {floor:.3e}, excluded "
          f"{int(excluded.sum())} of {n}, kept alpha err {err:.3e} of scale")
    assert 0.0 < noise < 1e-4 * np.nanmax(np.abs(d128))
    assert excluded.sum() < n // 2
    assert err <= 1e-4


def test_alpha_n4_every_slot(runs):
    a = runs["n4"]["jax"]["fields"]["alpha"]
    b = runs["n4"]["port"]["fields"]["alpha"]
    assert np.abs(b - a).max() <= 1e-4 * np.abs(a).max()
