"""The H100 probes' plain versions (sphexa_tpu_torch/probes/) against the
TPU scripts' own functions, run in Pallas interpret mode
(pltpu.force_tpu_interpret_mode) at sizes cut by monkeypatching the
scripts' module globals (nothing in scripts/ is edited):

  - P1 vpu_ceiling.make: NCELL 4; rtol 1e-6 (the same float32 chain).
  - P2-P4 dma_lab.make_many / make_few / make_pipe: K 3, F 24, NS 4096,
    4 programs, 4 reps; within 1e-6 of the output's scale. XLA on the
    CPU contracts the window fold into FMAs, the port rounds each
    product as the kernel does, so entries that cancel to near zero
    differ by more than 1e-6 of themselves (1.8e-4 at most here, 2e-7
    of the scale; my CPU run).
  - P5 mxu_micro.make: NCELL 3, vpu_flops 0 and 3, every mode; within
    1e-5 of the output's scale (the interpret-mode dot is true float32;
    under bf16 both sides round the operands to bf16 and sum in float32).
Each staging design of the port is held against the script function it
computes; the CPU wrappers run the plain versions and count no launch.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from scripts import dma_lab, mxu_micro, vpu_ceiling
from sphexa_tpu_torch.probes import fma_ceiling, mma_micro, staging_lab
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("rows,nchain", [(8, 1), (8, 2), (16, 4), (8, 8),
                                         (8, 32)])
def test_p1_fma_chains_match_script(monkeypatch, interpret, rows, nchain):
    monkeypatch.setattr(vpu_ceiling, "NCELL", 4)
    monkeypatch.setattr(fma_ceiling, "NCELL", 4)
    x = np.random.default_rng(rows + nchain).uniform(
        0.5, 2.0, (4 * rows, vpu_ceiling.W)).astype(np.float32)
    length = fma_ceiling.STEPS // nchain
    a = np.asarray(vpu_ceiling.make(rows, nchain, length)(jnp.asarray(x)))
    before = fma_ceiling.fma_chains.launches
    b = fma_ceiling.make(rows, nchain, length)(torch.from_numpy(x)).numpy()
    assert fma_ceiling.fma_chains.launches == before
    np.testing.assert_allclose(b, a, rtol=1e-6)


K, F, NS, NPROG, REPS = 3, 24, 4096, 4, 4
SCRIPT = {"many": dma_lab.make_many, "few": dma_lab.make_few,
          "pipe": dma_lab.make_pipe}


@pytest.mark.parametrize("design", sorted(staging_lab.VARIANTS))
def test_p2_p4_staging_matches_script(interpret, design):
    fn = staging_lab.VARIANTS[design][1]
    src, starts = staging_lab.inputs(K, F, NS, NPROG)
    a = np.asarray(SCRIPT[fn](K, F, NS, NPROG, REPS)(
        jnp.asarray(src.numpy()), jnp.asarray(starts.numpy())))
    make = {"many": staging_lab.make_many, "few": staging_lab.make_few,
            "pipe": staging_lab.make_pipe}[fn]
    kw = {"design": design} if fn == "many" else {}
    b = make(K, F, NS, NPROG, REPS, **kw)(src, starts).numpy()
    assert a.shape == b.shape == (NPROG * 8, 128)
    assert np.abs(b - a).max() <= 1e-6 * np.abs(a).max()
    assert staging_lab.PROBES[design].launches == 0


@pytest.mark.parametrize("vpu_flops", [0, 3])
@pytest.mark.parametrize("mode", mma_micro.MODES)
def test_p5_mma_cells_match_script(monkeypatch, interpret, mode, vpu_flops):
    monkeypatch.setattr(mxu_micro, "NCELL", 3)
    monkeypatch.setattr(mma_micro, "NCELL", 3)
    x = np.random.default_rng(7).uniform(-1.0, 1.0, (mxu_micro.FJ,
                                                     mxu_micro.RUNW))
    x = x.astype(np.float32)
    a = np.asarray(mxu_micro.make(mode, vpu_flops)(jnp.asarray(x)))
    b = mma_micro.make(mode, vpu_flops)(torch.from_numpy(x)).numpy()
    assert a.shape == b.shape == (mma_micro.CAP, mma_micro.RUNW)
    assert (b[:, mma_micro.K:] == 0).all()
    assert np.abs(b - a).max() <= 1e-5 * np.abs(a).max()


def test_probe_sizes_are_the_scripts():
    """The port's copies of the scripts' constants."""
    assert (fma_ceiling.NCELL, fma_ceiling.W) == (vpu_ceiling.NCELL,
                                                  vpu_ceiling.W)
    assert (mma_micro.CAP, mma_micro.RUNW, mma_micro.K, mma_micro.NCELL,
            mma_micro.FJ) == (mxu_micro.CAP, mxu_micro.RUNW, mxu_micro.K,
                              mxu_micro.NCELL, mxu_micro.FJ)
    assert set(fma_ceiling.CHAINS) >= {1, 2, 4, 8}
