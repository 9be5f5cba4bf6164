"""K2g's gate plan, the plain reference of the card's gate pass
(pair_ve.gate_plan and pair_gate.plain; csrc/cell_pair.cu gate_pass),
against the JAX package's gated driver make_cell_pair_call(gated=True)
(interpret mode, jitted once a grid) and against supercell_active and
the interior cells.

The JAX driver computes a z-supercell (Z z-cells of one (x, y) column,
legal_zgroup) where max(act) over its Z * cap slots exceeds 0.5 and
copies prev elsewhere; a body that returns ones marks, slot by slot,
the cells it computed. gate_plan lists the interior cells of those
supercells (ascending) and keeps prev on the interior slots of the
others. pair_gate.plain's workspace holds the count at ws[0], the cells
from ws[GATE_HDR] and a flag a supercell of the interior columns from
gate_flags, as the card's does.

Grids: CMGrid(n=4, cap=64) (npz 6, Z 6: one supercell a column, from
the bottom z-ghost cell to the top one) and CMGrid(n=10, cap=64) (npz
12, Z 6: two supercells a column, each holding one z end). Activity on
the valid interior slots of a Sedov 10^3 layout in a periodic and an
open box: none active; all active; one active slot in the interior
cell next to a padded z end (cz 1 of one column, cz nz of another);
one active slot in a z-ghost cell (the driver reads the whole
supercell); and a seeded mix of active, inactive and one-slot cells.
Everything is compared exactly: the plan is a set of cells.
"""

import functools

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
from sphexa_tpu_torch.ops import pair_ve as tpv
from sphexa_tpu_torch.ops.cellmajor import CMGrid, _interior_cells_np
from torch_threads import one_torch_thread  # noqa: F401

GRIDS = {"n4": dict(n=4, cap=64), "n10": dict(n=10, cap=64)}
BOXES = ("periodic", "open")
PATTERNS = ("none", "all", "end_interior", "end_ghost", "seeded")
FO = 8


@functools.lru_cache(maxsize=None)
def _driver(gname):
    """The JAX gated driver on the grid with a body of ones, jitted."""
    grid = jcm.CMGrid(**GRIDS[gname])

    def body(center, get_run):
        return jnp.ones((FO, center.shape[1]), jnp.float32)

    call = jpv.make_cell_pair_call(grid, 8, FO, body, interpret=True,
                                   gated=True)
    return jax.jit(lambda J, act, prev: call(J, act=act, prev=prev))


@functools.lru_cache(maxsize=None)
def _valid(gname, bname):
    """Valid slots of a Sedov 10^3 layout on the grid."""
    state, pbox, _ = j_init_sedov(10, JCfg(), dt0=1e-5)
    box = pbox if bname == "periodic" else JBox(
        -0.5, 0.5, -0.5, 0.5, -0.5, 0.5, *(JBoundary.open,) * 3)
    grid = jcm.CMGrid(**GRIDS[gname])
    lay = jcm.build_layout(grid, box, *(jnp.asarray(getattr(state.p, c))
                                        for c in "xyz"))
    assert int(lay.overflow) == 0
    return np.asarray(lay.valid)


def _activity(pattern, grid, valid, seed):
    """A 0/1 activity row [n_slots] of the pattern."""
    shape = (grid.npx, grid.np_, grid.npz, grid.cap)
    inside = np.repeat(_interior_cells_np(grid), grid.cap).reshape(shape)
    vi = valid.reshape(shape) & inside
    act = np.zeros(shape, np.float32)
    if pattern == "all":
        act[vi] = 1.0
    elif pattern == "end_interior":
        act[1, 1, 1, 0] = 1.0
        act[grid.nx, grid.n, grid.nz, 0] = 1.0
    elif pattern == "end_ghost":
        act[2, 1, 0, 0] = 1.0
    elif pattern == "seeded":
        r = np.random.default_rng(seed)
        kind = r.integers(0, 3, shape[:3])
        act[kind == 2] = 1.0
        act[..., 0][kind == 1] = 1.0
        act *= vi
    return act.reshape(-1)


def _expected(act, grid, Z):
    """Interior cells of the supercells holding an active slot (numpy,
    from the supercell layout directly)."""
    sc = (act.reshape(grid.npx, grid.np_, grid.npz // Z, Z * grid.cap)
          > 0.5).any(-1)
    on = np.repeat(sc, Z, axis=2).reshape(-1)
    return np.flatnonzero(on & _interior_cells_np(grid))


CASES = [(g, b, p) for g in GRIDS for b in BOXES for p in PATTERNS]


@pytest.mark.parametrize("gname,bname,pattern", CASES,
                         ids=[f"{g}-{b}-{p}" for g, b, p in CASES])
def test_gate_plan(gname, bname, pattern):
    grid = CMGrid(**GRIDS[gname])
    Z = tpv.resolve_zgroup(grid)
    assert Z == 6 and (grid.npz == Z) == (gname == "n4")
    valid = _valid(gname, bname)
    act = _activity(pattern, grid, valid, seed=len(pattern))
    tact = torch.from_numpy(act)
    cells, keep = tpv.gate_plan(tact, grid, Z)
    cells, keep = cells.numpy(), keep.numpy()

    # against the supercell layout, and supercell_active
    want = _expected(act, grid, Z)
    np.testing.assert_array_equal(cells, want)
    on = tpv.supercell_active(tact, grid, Z).numpy()
    inside = _interior_cells_np(grid)
    np.testing.assert_array_equal(cells, np.flatnonzero(on & inside))
    lane = np.arange(grid.cap)
    rest = np.flatnonzero(~on & inside)
    np.testing.assert_array_equal(keep, (rest[:, None] * grid.cap
                                         + lane).ravel())
    n_int = int(inside.sum())
    expect_n = {"none": 0, "all": n_int, "end_interior": 2 * grid.nz
                if grid.npz == Z else 2 * (Z - 1)}
    if pattern in expect_n:
        assert len(cells) == expect_n[pattern]
    if pattern == "end_ghost":
        assert len(cells) == min(Z - 1, grid.nz)

    # against the JAX gated driver: the slots it computed
    J = jnp.zeros((8, grid.n_slots), jnp.float32)
    out = np.asarray(_driver(gname)(
        J, jnp.asarray(np.broadcast_to(act, (8, grid.n_slots))),
        jnp.full((FO, grid.n_slots), -1.0, jnp.float32)))
    slot_in = np.repeat(inside, grid.cap)
    computed = (out[0] == 1.0) & slot_in
    np.testing.assert_array_equal(
        np.flatnonzero(computed.reshape(-1, grid.cap).any(1)), cells)
    assert (out[0][keep] == -1.0).all()

    # the gate pass's plain version: the count and list in the card's
    # layout, and a flag a supercell of the interior columns
    ws = tpv.pair_gate(tact, grid, Z).numpy()
    assert tpv.pair_gate.launches == 0          # the plain version
    assert ws[0] == len(cells)
    np.testing.assert_array_equal(ws[tpv.GATE_HDR:tpv.GATE_HDR + len(cells)],
                                  cells)
    flags = ws[tpv.gate_flags(grid):].reshape(grid.npx, grid.np_, -1)
    sc_on = (act.reshape(flags.shape + (Z * grid.cap,)) > 0.5).any(-1)
    sc_on[[0, -1]] = False
    sc_on[:, [0, -1]] = False
    np.testing.assert_array_equal(flags, sc_on)
