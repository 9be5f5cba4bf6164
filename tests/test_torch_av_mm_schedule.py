"""K9's tile schedule (csrc/cell_pair.cu, tile::pair_cell<AvMmStage>),
emulated in torch by tests/test_torch_tile_schedule.py's tile_schedule
on that file's frames (frame_inputs), against the JAX package's
_av_mm_body (PallasVE under mxu_moments, interpret mode, jitted once a
grid) and against the port's plain version pair_av_mm.plain.

The kernel stages the occupied 32-slot groups of the 27 neighbour cells
in neighbour-then-slot order, writes each staged slot's 8 moment
columns (vol_j (1, x_jc), vd_j (1, x_jc)) from the own cell's means of
x, y, z and divv (one origin a cell), and each lane adds W_ij times the
columns of its in-support pairs one at a time in that order, with the
signal speed as a max; an i-tile of min(cap, 128) slots with no valid
slot stores 0. tile_schedule runs the plain body on the packed run of
occupied groups with the contraction summed pair by pair in run order
(_seq_contract), so it differs from the plain version only in the
order of the sums.

Frames: Sedov 10^3 with seeded jitter on CMGrid(n=2, cap=256) (most
cells' second i-tile empty) and CMGrid(n=4, cap=64), periodic and open
boxes, K6's inputs (divv and cij drawn from a seeded generator).
Tolerances, and why:

  - alpha: rtol 1e-5 against the plain version on every valid interior
    slot; against the same body in float64 (k9_noise_floor in
    tests/test_torch_cuda.py) and against the JAX package, rtol 1e-5 on
    every valid interior slot above K9's noise floor. The slots at the
    floor are named from the inputs: graddivv is a difference of
    centred moment sums (the mm alpha property of ROADMAP Queue 3), and
    where four times its float32 rounding noise, carried into alpha,
    reaches the tolerance, the order of the sums alone can move alpha
    by it: at one such slot of the cap-256 frames the kernel's order is
    1.31e-5 (periodic) and 1.03e-5 (open) from float64, the JAX body's
    4.5e-6. No criterion on the inputs singles that slot out: 25 slots
    of the periodic frame are as ill-conditioned. The named slots
    (NAMED, counted) are held within 8 times their noise of float64
    (every order measured sits within 4.5 times it), the JAX body's
    too. divv is an input here, so the sign that switches alphaloc on
    cannot flip. At cap 256 the JAX body takes its origin per 128-slot
    i-block (pallas_ve.py:211-214), the port one per cell: any origin
    is algebraically exact (pair_ve._cell_means).
  - invalid interior slots: exactly 0, as the JAX package and plain.
"""

import dataclasses

import jax
import numpy as np
import pytest

from sphexa_tpu.ops import cellmajor as jcm
from sphexa_tpu.ops import pallas_ve as jpv
from sphexa_tpu_torch.interop import config_from_dict
from sphexa_tpu_torch.ops import pair_ve as tpv

from test_torch_cuda import k9_noise_floor
from test_torch_tile_schedule import (BOXES, GRIDS, TILE, av_switches_call,
                                      frame_inputs, tile_schedule)
from torch_threads import one_torch_thread  # noqa: F401

# valid interior slots at K9's noise floor, of 1000 in each frame
NAMED = {("cap256", "periodic"): 29, ("cap256", "open"): 21,
         ("cap64", "periodic"): 5, ("cap64", "open"): 7}


@pytest.fixture(scope="module")
def mm_frames():
    """Per (grid, box): the JAX _av_mm_body's output on the frame, the
    port's J and I2 rows, grid and masks; and the port's config."""
    fr, cfg = frame_inputs()
    mcfg = cfg.replace(mxu_moments=True)
    jits = {}
    for (gname, bname), f in fr.items():
        if gname not in jits:
            pve = jpv.PallasVE(jcm.CMGrid(**GRIDS[gname][0]), mcfg,
                               interpret=True)
            jits[gname] = jax.jit(pve.av_switches)
        f["jout"] = np.asarray(av_switches_call(jits[gname], f["jax"]))
    return fr, config_from_dict(dataclasses.asdict(mcfg))


CASES = [(g, b) for g in GRIDS for b in BOXES]


@pytest.mark.parametrize("gname,bname", CASES,
                         ids=[f"{g}-{b}" for g, b in CASES])
def test_av_mm_schedule(mm_frames, gname, bname):
    fr, cfg = mm_frames
    f = fr[gname, bname]
    k = tpv.pair_av_mm
    J, I2 = f["tin"]["pair_av_mm"]
    grid = f["grid"]
    assert cfg.mxu_moments
    jout = f["jout"]
    sched = tile_schedule(k, J, I2, grid, cfg).numpy()[0]
    plain = k.plain(J, I2, grid, cfg).numpy()[0]
    v, bad = f["valid"], f["inside"] & ~f["valid"]
    assert v.any() and bad.any()
    if grid.cap > TILE:
        tiles = f["valid"].reshape(-1, TILE).any(-1)
        assert (~tiles & f["inside"].reshape(-1, TILE).all(-1)).any()
    np.testing.assert_allclose(sched[v], plain[v], rtol=1e-5)
    ref, noise, named = (t.numpy() for t in k9_noise_floor(J, I2, grid,
                                                           cfg))
    assert (v & named).sum() == NAMED[gname, bname]
    held, floor = v & ~named, v & named
    for out in (sched, jout):
        np.testing.assert_allclose(out[held], ref[held], rtol=1e-5)
        assert (np.abs(out[floor] - ref[floor])
                <= 8.0 * noise[floor] * np.abs(ref[floor])).all()
    np.testing.assert_allclose(sched[held], jout[held], rtol=1e-5)
    assert (sched[bad] == 0.0).all()
    np.testing.assert_array_equal(sched[bad], jout[bad])
    np.testing.assert_array_equal(sched[bad], plain[bad])
    # the alpha update is exercised both ways
    d = sched[v] - I2[6].numpy()[v]
    assert (d > 0).any() and (d < 0).any()
