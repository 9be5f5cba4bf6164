"""The port's TieredBdtVE against the JAX package's TieredBdtVE (Pallas
in interpret mode) under the direct-sum self-gravity: the cycle of
tests/test_torch_tiered_bdt.py (hot-core Evrard 10, its two tiers, 2
rungs, one cycle of 2 substeps) with gravity recomputed every substep
on the alive rows and committed with the active particles' kick
forces.

A second JAX TieredBdtVE in one process fails its first substep
(ROADMAP Queue 3), and test_torch_tiered_bdt.py runs one in its own
process, which may be this file's pytest worker. So the JAX side runs
here in a child process (this file run as a script), which then builds
a second engine to show that fault (test_jax_second_engine_fails).

Per substep: dt, eint, ecin and egrav at rtol 1e-5, the rung
histogram, the active fraction, the fold and its four parts equal,
nf_truncated 0 (the port reports it; the JAX engine drops its
_add_gravity count). After the cycle: rungs and ticks per particle
equal, the particle rows and the frozen store within 1e-5 of each
row's scale.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest

from sphexa_tpu_torch.propagator.ve_tiered_bdt import _FROZEN
from test_torch_tiered_bdt import (ROWS, RUNGS, _check_rows, _check_rungs,
                                   _check_substep, jax_cycle, port_cycle)
from test_torch_tiered_bdt import _two_threads  # noqa: F401 (autouse)

_TESTS = Path(__file__).resolve().parent


def _jax_child(out: str):
    """The child process: the JAX cycle, then a second engine's cycle,
    whose raise (or its absence) is recorded beside it."""
    res = jax_cycle(True)
    try:
        jax_cycle(True)
        res["second_engine"] = None
    except ValueError as e:
        res["second_engine"] = str(e)
    with open(out, "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def cycle_direct(tmp_path_factory):
    out = tmp_path_factory.mktemp("tiered_bdt_gravity") / "jax.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(_TESTS.parent), str(_TESTS)]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        str(out)], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(out, "rb") as f:
        res = pickle.load(f)
    return dict(res, **port_cycle(True))


@pytest.mark.parametrize("sub", range(1 << (RUNGS - 1)))
def test_direct_substep_diagnostics(cycle_direct, sub):
    _check_substep(cycle_direct, sub, gravity=True)


def test_direct_rungs(cycle_direct):
    """Per-particle rungs and ticks equal under gravity, and both rungs
    populated, so the second substep runs gated."""
    hist = cycle_direct["td"][-1]["rung_hist"]
    assert hist[0] > 0 and hist[1] > 0
    assert float(cycle_direct["td"][1]["active_frac"]) < 1.0
    _check_rungs(cycle_direct)


@pytest.mark.parametrize("row", ROWS)
def test_direct_rows_after_cycle(cycle_direct, row):
    _check_rows(cycle_direct["jrows"], cycle_direct["trows"],
                cycle_direct["alive"], row)


@pytest.mark.parametrize("name", _FROZEN)
def test_direct_frozen_store(cycle_direct, name):
    _check_rows(cycle_direct["jfrozen"], cycle_direct["tfrozen"],
                cycle_direct["alive"], name)


def test_jax_second_engine_fails(cycle_direct):
    """The JAX package's fault (ROADMAP Queue 3): once a TieredBdtVE has
    run in a process, a second one's jitted substep
    (ve_tiered_bdt.py:110) raises at its first call, with the same
    configuration too."""
    msg = cycle_direct["second_engine"]
    assert msg is not None and "buffers but compiled program" in msg, msg


if __name__ == "__main__":
    _jax_child(sys.argv[1])
