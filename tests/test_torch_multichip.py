"""The port's MultiChipAdapter (sphexa_tpu_torch/propagator/multichip.py)
and the multi-device props through main, on the CPU.

- Sizing against the JAX adapter built on the same state (building it
  runs no step; jax.devices is cut to D of the conftest's virtual CPU
  devices): for each of the five props at D = 2 the shard count, the
  grid (CMGrid, CellGrid or the tiers), the caps of the SlabConfig or
  HilbertConfig and the measured gravity_band_cap (FMM at level 3);
  ve-hilbert at D = 8 too, where the pooled halo frame starts.
- Through main under SPHEXA_PLATFORM=cpu SPHEXA_NUM_DEVICES=2: each
  prop's run equals its engine driven by hand on the adapter's plan,
  bit for bit (one torch thread; same code, same order; the BDT props
  at 2 rungs).
- ve-hilbert's cell_cap fail-stop (which the JAX step lacks): at
  Evrard 10 the densest cell of an extended frame holds more than the
  case's cell_cap, so main re-grids and retries, as for --prop ve.
- The exit below 2 shards, as the JAX adapter exits.

The rung and OU restart: tests/test_torch_multichip_restart.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.init.factory import make_initializer as j_make_init
from sphexa_tpu.propagator import multichip as jmc
from sphexa_tpu.propagator import ve_hilbert as jvh
from sphexa_tpu.state import _FIELDS
from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.init.factory import make_initializer
from sphexa_tpu_torch.interop import (box_from_numpy, config_from_dict,
                                      state_from_numpy, tiers_from_numpy)
from sphexa_tpu_torch.main import main
from sphexa_tpu_torch.propagator import multichip as tmc
from sphexa_tpu_torch.state import SimState
from torch_threads import one_torch_thread  # noqa: F401

PROPS = ("ve-hilbert", "ve-pallas-sharded", "ve-bdt-sharded",
         "turbulence-ve-bdt-sharded", "ve-tiered-sharded")
CASE = {"ve-hilbert": ("evrard", 8), "ve-pallas-sharded": ("sedov", 8),
        "ve-bdt-sharded": ("evrard", 8),
        "turbulence-ve-bdt-sharded": ("turbulence", 8),
        "ve-tiered-sharded": ("evrard", 10)}


@pytest.fixture
def cpu(monkeypatch):
    """Two CPU shards; the BDT props at 2 rungs (2 substeps a cycle, not
    the adapter's 8), main and the engine by hand alike."""
    monkeypatch.setenv("SPHEXA_PLATFORM", "cpu")
    monkeypatch.setenv("SPHEXA_NUM_DEVICES", "2")
    monkeypatch.setattr(tmc, "BDT_RUNGS", 2)


# ---------------------------------------------------------------------------
# sizing against the JAX adapter
# ---------------------------------------------------------------------------

def _jax_adapter(monkeypatch, prop, case, side, D, fmm):
    state, box, cfg = j_make_init(case)(side, JCfg())
    if fmm:
        cfg = cfg.replace(gravity_solver="fmm", fmm_level=3)
    alive = np.asarray(state.p.alive)
    h_max = float(np.asarray(state.p.h)[alive].max())
    devs = jax.devices()[:D]
    monkeypatch.setattr(jax, "devices", lambda *a: devs)
    seen = {}
    real = jvh.distribute_hilbert

    def spy(host, box_, hc, mesh):
        seen["hc"] = hc
        return real(host, box_, hc, mesh)

    monkeypatch.setattr(jvh, "distribute_hilbert", spy)
    ad = jmc.MultiChipAdapter(prop, box, cfg, state, h_max)
    if "hc" not in seen:
        host = {f: np.asarray(getattr(state.p, f))[alive]
                for f in _FIELDS[:-1]}
        _, sc, _, _ = ad._slab_setup(host, box, h_max, np.array(devs), True)
        seen["sc"] = sc
    tstate = state_from_numpy({f: np.asarray(getattr(state.p, f))
                               for f in _FIELDS}, float(state.ttot),
                              float(state.dt), float(state.dt_m1),
                              int(state.iteration), device="cpu")
    tb = box_from_numpy([box.xmin, box.xmax, box.ymin, box.ymax, box.zmin,
                         box.zmax], [b.value for b in (box.bx, box.by,
                                                       box.bz)])
    return ad, seen, tstate, tb, config_from_dict(dataclasses.asdict(cfg)), \
        h_max


@pytest.mark.parametrize("prop,D", [(p, 2) for p in PROPS]
                         + [("ve-hilbert", 8)])
def test_adapter_sizing_equals_jax(monkeypatch, prop, D):
    case, side = CASE[prop]
    fmm = case == "evrard" and prop in ("ve-hilbert", "ve-tiered-sharded")
    ad, seen, tstate, tb, tcfg, h_max = _jax_adapter(
        monkeypatch, prop, case, side, D, fmm)
    monkeypatch.setenv("SPHEXA_NUM_DEVICES", str(D))
    tad = tmc.MultiChipAdapter(prop, tb, tcfg, tstate, h_max, device="cpu")
    assert tad.D == ad.D
    assert tad.cfg.gravity_band_cap == ad.cfg.gravity_band_cap
    if fmm:
        assert tad.cfg.gravity_band_cap > 0
    if "hc" in seen:
        assert dataclasses.asdict(tad.hc) == dataclasses.asdict(seen["hc"])
        if prop == "ve-tiered-sharded":
            assert tad.grid == tiers_from_numpy(ad.grid)
            assert len(tad.grid) >= 1
        else:
            assert tad.grid.level == ad.grid.level
        if D > 6:
            assert tad.hc.halo_pool > 0
    else:
        assert dataclasses.asdict(tad.sc) == dataclasses.asdict(seen["sc"])
        assert dataclasses.asdict(tad.grid) == dataclasses.asdict(ad.grid)


def test_adapter_exits_below_two_shards(monkeypatch):
    """Without SPHEXA_NUM_DEVICES the CPU is one shard: the adapter
    exits as the JAX one does, and so does SPHEXA_NUM_DEVICES=1."""
    monkeypatch.setenv("SPHEXA_PLATFORM", "cpu")
    monkeypatch.delenv("SPHEXA_NUM_DEVICES", raising=False)
    argv = ["--init", "sedov", "-n", "6", "--prop", "ve-pallas-sharded",
            "-s", "1", "--quiet", "--constants", ""]
    with pytest.raises(SystemExit, match="needs >= 2 devices"):
        main(argv)
    monkeypatch.setenv("SPHEXA_NUM_DEVICES", "1")
    with pytest.raises(SystemExit, match="got 1"):
        main(argv)
    assert tmc.shard_devices(torch.device("cpu")) == (1, [
        torch.device("cpu")])


# ---------------------------------------------------------------------------
# main against the engines by hand
# ---------------------------------------------------------------------------

def _argv(prop, steps, *extra):
    case, side = CASE[prop]
    return ["--init", case, "-n", str(side), "--prop", prop, "-s",
            str(steps), "--quiet", "--constants", "", *extra]


def _by_hand(prop, steps):
    """The adapter's plan, run through the engine's own API."""
    case, side = CASE[prop]
    state, box, cfg = make_initializer(case)(side, SphConfig(), device="cpu")
    alive = state.p.alive
    h_max = float(state.p.h[alive].max())
    ad = tmc.MultiChipAdapter(prop, box, cfg, state, h_max, device="cpu")
    if ad.bdt is not None:
        bsts = ad.bdt.distribute_bind(state)
        for _ in range(steps):
            bsts, _ = ad.bdt.run_cycle(bsts)
        return ad.bdt.unbind(bsts, ad.n_global)
    states = [SimState(p=p, ttot=state.ttot, dt=state.dt,
                       dt_m1=state.dt_m1, iteration=state.iteration)
              for p in ad._states0]
    for _ in range(steps):
        states, _ = ad._step(states)
    return ad._join(states)


@pytest.mark.parametrize("prop", PROPS)
def test_cli_equals_engine(cpu, prop):
    steps = 1 if "bdt" in prop else 2
    got = main(_argv(prop, steps))
    want = _by_hand(prop, steps)
    for f in _FIELDS:
        assert torch.equal(getattr(got.p, f), getattr(want.p, f)), f
    for f in ("ttot", "dt", "dt_m1", "iteration"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int(got.p.alive.sum()) == int(want.p.alive.sum())


def test_hilbert_cell_cap_fail_stop(cpu, capsys):
    state, box, cfg = make_initializer("evrard")(10, SphConfig(),
                                                 device="cpu")
    h_max = float(state.p.h[state.p.alive].max())
    ad = tmc.MultiChipAdapter("ve-hilbert", box, cfg, state, h_max,
                              device="cpu")
    _, d = ad(state)
    assert d.max_cell_count > cfg.cell_cap
    assert int(d.raw.max_cell_count) == d.max_cell_count
    got = main(["--init", "evrard", "-n", "10", "--prop", "ve-hilbert",
                "-s", "1", "--constants", ""])
    err = capsys.readouterr().err
    assert "# re-gridded with larger caps" in err
    assert f"cell_cap={2 * d.max_cell_count}" in err
    assert int(got.iteration) == 2 and int(got.p.alive.sum()) == 552


def test_plan_slab_within_kernel_cap():
    """Where the JAX slab rule's cell cap exceeds the pair kernels'
    limit (a clustered field), plan_slab takes the finest grid the
    2 h_max bound allows whose cap fits, measured on the same binning;
    past every grid it raises (the CLI's fail-stop, not the JAX
    adapter's exit for a slab thinner than 2 h_max). Where the JAX cap
    fits, as this frame's 640 fits the kernels' default limit, it is the
    JAX plan (tests/test_torch_sharded.py::test_plan_slab_equal). The
    limits of 512 and 128 here stand in for the kernels' one."""
    from sphexa_tpu_torch.ops.pair_ve import MAX_CAP
    from sphexa_tpu_torch.propagator.ve_sharded import plan_slab

    r = np.random.default_rng(5)
    n = 6000
    core = r.random(n) < 0.5
    host = {c: np.where(core, r.normal(0, 0.03, n), r.uniform(-1, 1, n))
            .clip(-0.999, 0.999).astype(np.float32) for c in "xyz"}
    box = box_from_numpy([-1, 1, -1, 1, -1, 1], [0, 0, 0])
    h_max = 0.06
    g0, sc0 = plan_slab(host, box, h_max, 2)
    assert 512 < g0.cap <= MAX_CAP
    g1, sc1 = plan_slab(host, box, h_max, 2, cap_max=512)
    assert g1.cap <= 512 and g1.n > g0.n and sc1 == sc0
    edge = 2.0 / g1.n
    assert edge >= 2 * h_max * 1.25 and 2.0 / (2 * g1.nz) >= 2 * h_max
    gx, gy, gz = (np.clip(((host[c] + 1) / 2 * k).astype(np.int64), 0, k - 1)
                  for c, k in (("x", g1.n), ("y", g1.n), ("z", 2 * g1.nz)))
    occ = np.bincount((gx * g1.n + gy) * (2 * g1.nz) + gz).max()
    assert occ + 8 <= g1.cap
    with pytest.raises(RuntimeError, match="too clustered"):
        plan_slab(host, box, h_max, 2, cap_max=128)
