"""The tile schedule of the K4 and K6 kernels (csrc/cell_pair.cu,
tile::pair_cell<GradhStage> and <AvStage>), emulated in torch, against
the JAX package's _gradh_body and _av_direct_body (PallasVE in interpret
mode) and against the port's plain versions pair_gradh.plain and
pair_av.plain. K9's schedule (tile::pair_cell<AvMmStage>) is held by
tests/test_torch_av_mm_schedule.py with this file's tile_schedule and
frame_inputs.

The kernels stage the occupied 32-slot groups of the 27 neighbour cells
in neighbour-then-slot order (each up to its last valid slot: valid
slots are a prefix of a cell, so the rest of the last group is invalid
and fails the support test), and each lane adds its in-support pairs to
its sums one at a time in that order; K6's signal speed is a max. An
i-tile of min(cap, 128) slots with no valid slot returns before staging
and stores the Stage's fill values: 1.0 for kx and gradh (kx is a
divisor downstream), 0 for alpha. `tile_schedule` below follows that
schedule with the plain versions' float32 expressions: it runs the
plain body on the packed run of occupied groups with its sums taken one
pair at a time in run order, so it differs from the plain version only
in what the schedule changes, the order of the sums.

Inputs: Sedov 10^3 with seeded jitter of positions (4e-3) and h (5%),
per-particle rows drawn from a seeded generator (kx and xm 1.0 on
invalid slots, as the pipeline's K3 and K4 leave them), on
CMGrid(n=2, cap=256) (about 125 particles a cell, so most cells' second
i-tile is empty) and on CMGrid(n=4, cap=64) (h at 0.75 of Sedov's, so 2h
stays inside a cell), in a periodic and an open box. Tolerances, and
why:

  - kx, gradh, alpha: rtol 1e-5 against the JAX package on the valid
    interior slots, as in tests/test_torch_pair_ve.py: the sums are
    reduced in another order (nine z-run windows in the Pallas body, the
    run's k order here).
  - invalid interior slots: exact against the JAX package, kx = gradh =
    1.0 and alpha = 0.
  - against the plain version: the same values at the same tolerances
    (pairwise summation in torch).
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.init.sedov import init_sedov as j_init_sedov
from sphexa_tpu.ops import cellmajor as jcm
from sphexa_tpu.ops import pallas_ve as jpv
from sphexa_tpu.sfc.box import Box as JBox, Boundary as JBoundary
from sphexa_tpu_torch.interop import config_from_dict
from sphexa_tpu_torch.ops import pair_ve as tpv
from sphexa_tpu_torch.ops.cellmajor import CMGrid, _interior_cells_np
from torch_threads import one_torch_thread  # noqa: F401

GRIDS = {"cap256": (dict(n=2, cap=256), 1.0),
         "cap64": (dict(n=4, cap=64), 0.75)}   # (grid, h scale)
BOXES = ("periodic", "open")
STAGES = {"pair_gradh": 1.0, "pair_av": 0.0}    # stage: fill value
FILLS = dict(STAGES, pair_av_mm=0.0)
TILE = 128
CELLS_AT_ONCE = 16


def _seq_sum(t):
    """Sum over the last axis one term at a time, in order (a lane's
    sums in the kernel)."""
    acc = torch.zeros_like(t[..., :1])
    for k in range(t.shape[-1]):
        acc = acc + t[..., k:k + 1]
    return acc


def _seq_contract(w, cols):
    """The moment contraction with each (i, column) sum taken one pair
    at a time in run order (K9's per-lane sums); [C, CAP, K]."""
    M = torch.cat(cols, dim=1)                       # [C, K, W]
    acc = torch.zeros((*w.shape[:2], M.shape[1]), dtype=torch.float32)
    for j in range(w.shape[-1]):
        acc = acc + w[:, :, j:j + 1] * M[:, None, :, j]
    return acc


def tile_schedule(k, J, I2, grid, cfg):
    """K4's, K6's or K9's schedule in torch: output rows, zero outside
    the interior cells."""
    cap, G = grid.cap, grid.cap // 32
    T = min(cap, TILE)
    valid = J[tpv.RX] < 0.5 * tpv.FILL_POS
    out = torch.zeros((k.fo, grid.n_slots), dtype=torch.float32)
    cells = torch.tensor(tpv.interior_cells(grid))
    offs = torch.tensor(tpv._nbr_offsets(grid))
    lane = torch.arange(cap)
    for c0 in range(0, len(cells), CELLS_AT_ONCE):
        cc = cells[c0:c0 + CELLS_AT_ONCE]
        C = len(cc)
        # the 27 cells' 32-slot groups in nb-then-slot order; the run
        # packs the occupied ones, in order, then the unoccupied ones
        # (every slot invalid: out of every support, a zero term)
        groups = ((cc[:, None] + offs)[:, :, None] * cap + lane).view(
            C, 27 * G, 32)
        occ = valid[groups].any(-1)
        order = torch.argsort((~occ).to(torch.int8), dim=1, stable=True)
        nrun = 32 * int(occ.sum(1).max())
        run = groups.gather(1, order[..., None].expand(-1, -1, 32)).view(
            C, -1)[:, :nrun]
        own = cc[:, None] * cap + lane                        # [C, cap]
        I = J[:, own].reshape(J.shape[0], C, cap, 1)
        Jn = J[:, run].reshape(J.shape[0], C, 1, nrun)
        i2 = None if I2 is None else I2[:, own].reshape(I2.shape[0], C,
                                                        cap, 1)
        with mock.patch.object(tpv, "_sum", _seq_sum), \
                mock.patch.object(tpv, "_contract", _seq_contract):
            res = k.body(I, Jn, i2, **k._body_kw(cfg))
        # an i-tile with no valid slot stores the fill values
        empty = ~valid[own].view(C, cap // T, T).any(-1)
        empty = empty.repeat_interleave(T, dim=1)             # [C, cap]
        for r, v in enumerate(res):
            v = torch.where(empty, FILLS[k.name], v.reshape(C, cap))
            out[r, own.reshape(-1)] = v.reshape(-1)
    return out


def frame_inputs():
    """Per (grid, box): the JAX stage inputs (base rows, cell-major rows,
    cij, dt), the port's J and I2 rows of K4 and K6 (K9 reads K6's), the
    port's grid and masks; and the JAX config."""
    state, pbox, cfg = j_init_sedov(10, JCfg(), dt0=1e-5)
    n = 1000
    r = np.random.default_rng(0)
    h0 = float(state.p.h[0])
    xyz = [np.asarray(getattr(state.p, c))
           + r.normal(0, 0.004, n).astype(np.float32) for c in "xyz"]
    hjit = (1.0 + 0.05 * r.normal(0, 1, n)).astype(np.float32)

    def u(lo, hi):
        return r.uniform(lo, hi, n).astype(np.float32)

    m = np.asarray(state.p.m)
    # K6's xm a hundred times K4's: graddivv large enough that alphaloc
    # passes alpha_i on some slots (K4's at the scale of m keeps gradh
    # near 1)
    part = dict(xm=u(0.5, 1.5) * 1e-3, xm_av=u(0.5, 1.5) * 0.1,
                c=u(0.5, 1.5), kx=u(0.5, 2.0),
                divv=r.normal(0, 1, n).astype(np.float32),
                alpha=u(0.05, 1.0))
    for key in ("vx", "vy", "vz", "c11", "c12", "c13", "c22", "c23", "c33"):
        part[key] = r.normal(0, 1, n).astype(np.float32)
    dt = 0.02
    obox = JBox(-0.5, 0.5, -0.5, 0.5, -0.5, 0.5, *(JBoundary.open,) * 3)
    out = {}
    for gname, (gkw, hscale) in GRIDS.items():
        grid = jcm.CMGrid(**gkw)
        pve = jpv.PallasVE(grid, cfg, interpret=True)
        for bname, box in (("periodic", pbox), ("open", obox)):
            X = [jnp.asarray(a) for a in xyz]
            lay = jcm.build_layout(grid, box, *X)
            base = pve.base_rows(lay, *X, jnp.asarray(hscale * h0 * hjit))

            def cm(a, fill=0.0, lay=lay):
                return jcm.to_cm(lay, jnp.asarray(a), fill)

            rows = dict(m=cm(m), xm=cm(part["xm"], 1.0),
                        xm_av=cm(part["xm_av"], 1.0), c=cm(part["c"], 1.0),
                        kx=cm(part["kx"], 1.0), divv=cm(part["divv"]),
                        alpha=cm(part["alpha"]))
            for key in ("vx", "vy", "vz", "c11", "c12", "c13", "c22", "c23",
                        "c33"):
                rows[key] = cm(part[key])
            cij = tuple(rows[key] for key in ("c11", "c12", "c13", "c22",
                                              "c23", "c33"))

            def t(keys, base=base, rows=rows):
                return torch.from_numpy(np.stack(
                    [np.asarray(b) for b in base]
                    + [np.asarray(rows[key]) for key in keys]))
            dt_row = np.full(grid.n_slots, dt, np.float32)
            tin = {
                "pair_gradh": (t(("m", "xm")), None),
                "pair_av": (t(("c", "kx", "xm_av", "divv", "vx", "vy", "vz")),
                            torch.from_numpy(np.stack(
                                [np.asarray(c) for c in cij]
                                + [np.asarray(rows["alpha"]), dt_row])))}
            tin["pair_av_mm"] = tin["pair_av"]
            tgrid = CMGrid(**gkw)
            inside = np.repeat(_interior_cells_np(tgrid), tgrid.cap)
            out[gname, bname] = dict(
                jax=dict(base=base, rows=rows, cij=cij, dt=dt), tin=tin,
                grid=tgrid, inside=inside,
                valid=np.asarray(lay.valid) & inside)
    return out, cfg


def av_switches_call(f, jx):
    """The JAX av_switches `f` on a frame's inputs, as K6's and K9's J
    rows hold them."""
    rows = jx["rows"]
    return f(jx["base"], rows["c"], rows["kx"], rows["xm_av"], rows["divv"],
             rows["vx"], rows["vy"], rows["vz"], jx["cij"], rows["alpha"],
             jnp.float32(jx["dt"]))


@pytest.fixture(scope="module")
def frames():
    """Per (grid, box): the JAX stage calls, the port's J and I2 rows,
    grid and masks; and the port's config."""
    fr, cfg = frame_inputs()
    jits = {}
    for (gname, bname), f in fr.items():
        if gname not in jits:
            # jitted once a grid: the second box reuses the compiled
            # kernels
            pve = jpv.PallasVE(jcm.CMGrid(**GRIDS[gname][0]), cfg,
                               interpret=True)
            jits[gname] = (jax.jit(pve.gradh), jax.jit(pve.av_switches))
        gradh, av_switches = jits[gname]
        jx = f["jax"]
        f["jin"] = {
            "pair_gradh": lambda f=gradh, jx=jx:
                f(jx["base"], jx["rows"]["m"], jx["rows"]["xm"]),
            "pair_av": lambda f=av_switches, jx=jx:
                (av_switches_call(f, jx),)}
    return fr, config_from_dict(dataclasses.asdict(cfg))


CASES = [(s, g, b) for s in STAGES for g in GRIDS for b in BOXES]


@pytest.mark.parametrize("stage,gname,bname", CASES,
                         ids=[f"{s}-{g}-{b}" for s, g, b in CASES])
def test_tile_schedule(frames, stage, gname, bname):
    fr, cfg = frames
    f = fr[gname, bname]
    k = getattr(tpv, stage)
    J, I2 = f["tin"][stage]
    grid = f["grid"]
    jout = np.stack([np.asarray(o) for o in f["jin"][stage]()])
    sched = tile_schedule(k, J, I2, grid, cfg).numpy()
    plain = k.plain(J, I2, grid, cfg).numpy()
    v, bad = f["valid"], f["inside"] & ~f["valid"]
    # the inputs hold the cases the schedule treats apart: invalid
    # interior slots, and at cap 256 i-tiles with no valid slot
    assert v.any() and bad.any()
    if grid.cap > TILE:
        tiles = f["valid"].reshape(-1, TILE).any(-1)
        assert (~tiles & f["inside"].reshape(-1, TILE).all(-1)).any()
    for r in range(k.fo):
        np.testing.assert_allclose(sched[r, v], jout[r, v], rtol=1e-5)
        np.testing.assert_allclose(sched[r, v], plain[r, v], rtol=1e-5)
        assert (sched[r, bad] == STAGES[stage]).all()
        np.testing.assert_array_equal(sched[r, bad], jout[r, bad])
        np.testing.assert_array_equal(sched[r, bad], plain[r, bad])
    if stage == "pair_av":
        # the alpha update is exercised both ways: alphaloc above
        # alpha_i on some slots, alpha_i + alphadot * dt below it on
        # others
        d = sched[0, v] - I2[6].numpy()[v]
        assert (d > 0).any() and (d < 0).any()
