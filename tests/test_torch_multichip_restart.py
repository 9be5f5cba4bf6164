"""The rung and OU restart of --prop turbulence-ve-bdt-sharded through
main (SPHEXA_PLATFORM=cpu SPHEXA_NUM_DEVICES=2, turbulence 8^3, the
adapter's rungs cut to 2): two cycles in one run against one cycle, an HDF5 dump (the rungs, the OU
phases and RNG state) and a restart for one more. The restart
re-distributes the dumped frame where the continued run resyncs its
shards' frames, so the slots of a cell may be packed in another order:
the fields are held within 1e-5 of their scale, time and alive rows
exactly as far as float32 sums allow (ttot at rtol 1e-6).
"""

import numpy as np
import pytest
import torch

from sphexa_tpu_torch.io import hdf5
from sphexa_tpu_torch.main import main
from sphexa_tpu_torch.propagator import multichip as tmc
from torch_threads import one_torch_thread  # noqa: F401

PROP = "turbulence-ve-bdt-sharded"


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("SPHEXA_PLATFORM", "cpu")
    monkeypatch.setenv("SPHEXA_NUM_DEVICES", "2")
    monkeypatch.setattr(tmc, "BDT_RUNGS", 2)


def _argv(steps, *extra):
    return ["--init", "turbulence", "-n", "8", "--prop", PROP, "-s",
            str(steps), "--quiet", "--constants", "", *extra]


def test_cli_rung_and_ou_restart(cpu, tmp_path):
    dump = str(tmp_path / "t.h5")
    whole = main(_argv(2))
    main(_argv(1, "-w", "1", "-o", dump))
    ou, rungs = hdf5.load_turbulence_state(dump), hdf5.load_bdt_state(dump)
    assert np.abs(ou["phases"]).max() > 0
    assert rungs["num_rungs"] == 2 and rungs["dt_min"] > 0
    assert len(rungs["rung"]) == int(whole.p.alive.sum())
    restarted = main(["--init", dump] + _argv(1)[4:])
    assert int(restarted.iteration) == int(whole.iteration)
    np.testing.assert_allclose(float(restarted.ttot), float(whole.ttot),
                               rtol=1e-6)
    a = whole.p.alive
    assert torch.equal(restarted.p.alive, a)
    for f in ("x", "y", "z", "vx", "vy", "vz", "temp", "h", "alpha"):
        w = getattr(whole.p, f)[a].numpy()
        r = getattr(restarted.p, f)[a].numpy()
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(r - w).max() <= 1e-5 * scale, f
