"""The port's TieredBdtVE (block time-steps on the h-tier grids, the gated
stages K2g on each tier) against the JAX package's TieredBdtVE (Pallas
in interpret mode): Evrard 10 without gravity on the two tiers of
tests/test_torch_tiers.py (CMGrid(n=2, cap=64), CMGrid(n=2, cap=128)),
2 rungs, one cycle of 2 substeps from the same bound state (the JAX
substep is one jitted program, called twice).

Per substep: dt, eint, ecin at rtol 1e-5, egrav 0, the rung
histogram, the active fraction, the fold and its four parts equal.
After the cycle: rungs and ticks per particle equal, the particle rows
and the frozen store within 1e-5 of each row's scale
(tests/test_torch_gravity_engine.py's tolerances). The second substep
runs gated: only the particles on rung 0 are active there. For a dt
contrast the cold sphere gets a hot core (u = 5 exp(-r^2 / 0.2^2) +
1e-4, the Sedov-style spike of tests/test_tiered.py:185): the shell's
Courant dt is then far above the core's, and the coarse tier's cells
sit on rung 1 (at Evrard 10 the tier cells are octants, and the cold
start puts every cell on rung 0: with gravity the near-uniform g sets
every dt_i, without it dt_i ~ h spreads too little). The same cycle
under the direct-sum self-gravity is held in
tests/test_torch_tiered_bdt_gravity.py, with this file's cycles and
checks: a second JAX TieredBdtVE in one process fails its first
substep (ROADMAP Queue 3), so that file runs its JAX side in a
process of its own.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.init.evrard import init_evrard as j_init_evrard
from sphexa_tpu.propagator import ve_tiered as J
from sphexa_tpu.propagator.ve_tiered_bdt import TieredBdtVE as JTieredBdtVE
from sphexa_tpu.sph.eos import ideal_gas_cv
from sphexa_tpu.state import _FIELDS
from sphexa_tpu_torch.interop import (box_from_numpy, config_from_dict,
                                      state_from_numpy, tiers_from_numpy)
from sphexa_tpu_torch.propagator.ve_tiered_bdt import _FROZEN, TieredBdtVE

RUNGS = 2
ROWS = ("x", "y", "z", "vx", "vy", "vz", "h", "temp", "alpha", "du_m1",
        "x_m1")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _inputs(gravity: bool):
    """The hot-core Evrard 10 state, its tiers and config (the direct sum
    on, or gravG 0)."""
    cfg = JCfg(chunk=512, cell_cap=512, ngpad=256, gravity_solver="direct")
    state, jb, cfg = j_init_evrard(10, cfg, dt0=1e-4)
    if not gravity:
        cfg = cfg.replace(gravG=0.0)
    p = state.p
    r2 = np.asarray(p.x) ** 2 + np.asarray(p.y) ** 2 + np.asarray(p.z) ** 2
    u = 5.0 * np.exp(-r2 / 0.2 ** 2) + 1e-4
    state = state.replace(p=p.replace(temp=jnp.asarray(
        (u / ideal_gas_cv(cfg.mui, cfg.gamma)).astype(np.float32))))
    p = state.p
    jt = J.choose_tiers(jb, *(np.asarray(getattr(p, c)) for c in "xyzh"),
                        alive=np.asarray(p.alive), cap_max=128,
                        cap_max_top=64, theta=1.3, grid_slack=1.0,
                        top_headroom=1.0, headroom=0)
    return state, jb, jt, cfg


def jax_cycle(gravity: bool):
    """The JAX engine's RUNGS cycle (Pallas in interpret mode)."""
    state, jb, jt, cfg = _inputs(gravity)
    jeng = JTieredBdtVE(jb, jt, cfg, num_rungs=RUNGS, interpret=True)
    jb_, jdiags = jeng.run_cycle(jeng.bind(state), check=False)
    return dict(
        alive=np.asarray(state.p.alive), n_tiers=len(jt),
        jd=[{k: np.asarray(v) for k, v in d._asdict().items()}
            for d in jdiags],
        jrows={f: np.asarray(getattr(jb_.p, f)) for f in ROWS},
        jfrozen={k: np.asarray(v) for k, v in jb_.frozen.items()},
        jrung=(np.asarray(jb_.rung), np.asarray(jb_.ticks)))


def port_cycle(gravity: bool):
    """The port's RUNGS cycle from the same state, tiers and config."""
    state, jb, jt, cfg = _inputs(gravity)
    p = state.p
    host = ({f: np.asarray(getattr(p, f)) for f in _FIELDS},
            float(state.ttot), float(state.dt), float(state.dt_m1),
            int(state.iteration))
    tb = box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                         jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])
    teng = TieredBdtVE(tb, tiers_from_numpy(jt),
                       config_from_dict(dataclasses.asdict(cfg)),
                       num_rungs=RUNGS, device="cpu")
    tb_, tdiags = teng.run_cycle(
        teng.bind(state_from_numpy(*host, device="cpu")), check=False)
    return dict(
        td=[{k: v.numpy() for k, v in d._asdict().items()} for d in tdiags],
        trows={f: getattr(tb_.p, f).numpy() for f in ROWS},
        tfrozen={k: v.numpy() for k, v in tb_.frozen.items()},
        trung=(tb_.rung.numpy(), tb_.ticks.numpy()))


@pytest.fixture(scope="module")
def cycle():
    return dict(jax_cycle(False), **port_cycle(False))


def _check_substep(cycle, sub, gravity):
    a, b = cycle["jd"][sub], cycle["td"][sub]
    assert cycle["n_tiers"] == 2
    for k in ("dt", "eint", "ecin"):
        np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
    if gravity:
        assert float(a["egrav"]) < 0.0
        np.testing.assert_allclose(b["egrav"], a["egrav"], rtol=1e-5)
    else:
        assert float(b["egrav"]) == float(a["egrav"]) == 0.0
    np.testing.assert_array_equal(b["rung_hist"], a["rung_hist"])
    assert float(b["active_frac"]) == float(a["active_frac"])
    assert int(b["fold"]) == int(a["fold"])
    np.testing.assert_array_equal(b["fold_parts"], a["fold_parts"])
    assert int(b["nf_truncated"]) == 0


def _check_rungs(cycle):
    alive = cycle["alive"]
    for a, b in zip(cycle["jrung"], cycle["trung"]):
        np.testing.assert_array_equal(b[alive], a[alive])


def _check_rows(j, t, alive, name):
    a, b = j[name][alive], t[name][alive]
    scale = max(np.abs(a).max(), 1e-30)
    assert np.abs(b - a).max() <= 1e-5 * scale, name


@pytest.mark.parametrize("sub", range(1 << (RUNGS - 1)))
def test_substep_diagnostics(cycle, sub):
    _check_substep(cycle, sub, gravity=False)


def test_rungs_split_the_cycle(cycle):
    """Both rungs are populated, so the second substep skips the rung-1
    particles (gated); per-particle rungs and ticks equal."""
    hist = cycle["td"][-1]["rung_hist"]
    assert hist[0] > 0 and hist[1] > 0
    assert float(cycle["td"][1]["active_frac"]) < 1.0
    _check_rungs(cycle)


@pytest.mark.parametrize("row", ROWS)
def test_rows_after_cycle(cycle, row):
    _check_rows(cycle["jrows"], cycle["trows"], cycle["alive"], row)


@pytest.mark.parametrize("name", _FROZEN)
def test_frozen_store(cycle, name):
    _check_rows(cycle["jfrozen"], cycle["tfrozen"], cycle["alive"], name)
