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
P2-P4's byte counts (staging_lab.byte_counts) are held against the
plain versions' own window lanes; P5's design names, the launcher's
refusals and mma_parts' builds of the source need no card.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from scripts import dma_lab, mxu_micro, vpu_ceiling
from sphexa_tpu_torch.ops import _cuda
from sphexa_tpu_torch.probes import (fma_ceiling, mma_micro, mma_parts,
                                     staging_lab)
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


@pytest.mark.parametrize("fn", ["many", "few", "pipe"])
def test_p2_p4_byte_counts(fn):
    """unique: the lanes the plain version's windows read; lru: every
    sector column a miss with no cache, each once with a cache past the
    source."""
    src, starts = staging_lab.inputs(K, F, NS, NPROG)
    win = staging_lab._INDEX[fn](src, starts, K, NPROG)   # [K, nprog, 128]
    idx = win.reshape(-1)
    c = staging_lab.byte_counts(fn, starts, K, F, NS, NPROG,
                                cache_bytes=4 * F * NS)
    assert c["unique"] == 4 * F * int(torch.unique(idx).numel())
    assert c["windows"] == 4 * F * idx.numel()
    sectors = idx // staging_lab.SECTOR
    runs = (win.permute(1, 0, 2).reshape(NPROG, -1) if fn == "few"
            else win.reshape(-1, 128)) // staging_lab.SECTOR
    col = 4 * F * staging_lab.SECTOR
    assert c["lru"] == col * int(torch.unique(sectors).numel())
    cold = staging_lab.lru_bytes(fn, starts, K, F, NS, NPROG, cache_bytes=0)
    assert cold == col * sum(int(torch.unique(r).numel()) for r in runs)


def test_p5_designs():
    """The designs' names; "none" runs mma_sync's loop under either, and
    a CPU tensor takes the plain version under every design."""
    assert mma_micro.DESIGNS == ("mma_sync", "wgmma")
    assert mma_micro.kernel_design("none", "wgmma") == "mma_sync"
    assert mma_micro.kernel_design("bf16", "wgmma_serial") == "wgmma_serial"
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        -1.0, 1.0, (mma_micro.FJ, mma_micro.RUNW)).astype(np.float32))
    ref = mma_micro.mma_cells.plain(x, "bf16", 2, 1)
    for design in _cuda.MMA_DESIGNS:
        assert torch.equal(mma_micro.mma_cells(x, "bf16", 2, 1, design), ref)
    assert not any(mma_micro.mma_cells.launches.values())


@pytest.mark.parametrize("design,mode", [("tensor", 1), ("wgmma", 0),
                                         ("wgmma_serial", 0),
                                         ("mma_sync", 4)])
def test_p5_launcher_refuses(design, mode):
    """An unknown design or mode, or mode 0 (no product) under wgmma, is
    refused before any build or launch."""
    x = torch.zeros((mma_micro.FJ, mma_micro.RUNW))
    out = torch.zeros((mma_micro.CAP, mma_micro.RUNW))
    with pytest.raises(ValueError):
        _cuda.mma_micro_launch(design, mode, x, out, 1, 0)
    with pytest.raises(ValueError):
        _cuda.mma_micro_info(design, mode)
    if design == "tensor":
        with pytest.raises(ValueError):
            mma_micro.make("f32", 0, design)


@pytest.mark.parametrize("part", ["elementwise", "product"])
def test_p5_parts_cut_the_source(part):
    """Each part of mma_parts is probes.cu built with -DMW_PART=1 or 2, a
    value the source tests (the library is built on the card only)."""
    flag = {"product": 1, "elementwise": 2}[part]
    name = mma_parts.LIBRARIES[part]
    assert _cuda._source(name) == ("probes.cu", [f"-DMW_PART={flag}"])
    assert f"#if MW_PART == {flag}" in (_cuda._CSRC / "probes.cu").read_text()
    header = _cuda._consts_header()
    assert _cuda._target(name, header) != _cuda._target("probes.cu", header)


def test_probe_sizes_are_the_scripts():
    """The port's copies of the scripts' constants."""
    assert (fma_ceiling.NCELL, fma_ceiling.W) == (vpu_ceiling.NCELL,
                                                  vpu_ceiling.W)
    assert (mma_micro.CAP, mma_micro.RUNW, mma_micro.K, mma_micro.NCELL,
            mma_micro.FJ) == (mxu_micro.CAP, mxu_micro.RUNW, mxu_micro.K,
                              mxu_micro.NCELL, mxu_micro.FJ)
    assert set(fma_ceiling.CHAINS) >= {1, 2, 4, 8}
