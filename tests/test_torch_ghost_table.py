"""The host-side table of the ghost refresh kernel (K1, and K1z with
refresh_z=False) against the JAX package's make_ghost_refresh.

csrc/ghost_refresh.cu reads one int4 a ghost cell, built by
ops/pair_ve._ghost_maps: {destination cell, source cell, code, 0}, code
= (sx+1) | (sy+1) << 2 | (sz+1) << 4 | open << 6, s the cell's side on
each periodic axis whose shift applies. Here the table is decoded and
applied to a seeded stack as the kernel applies it (in numpy), and the
result is held bit for bit against make_ghost_refresh run in interpret
mode on the same stack: with coordinate rows (the +-L shifts and the
FILL_POS of open axes) and without (a plain copy, which shows every
source cell). The refresh reads the cell id off a stack whose first row
holds it, so the source cells are also compared as integers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.ops import cellmajor as jcm
from sphexa_tpu.ops import pallas_ve as jpv
from sphexa_tpu.sfc.box import Box as JBox, Boundary as JB
from sphexa_tpu_torch.interop import box_from_numpy
from sphexa_tpu_torch.ops import cellmajor as tcm
from sphexa_tpu_torch.ops import pair_ve as tpv
from torch_threads import one_torch_thread  # noqa: F401

BOXES = {"periodic": (JB.periodic,) * 3, "open": (JB.open,) * 3,
         "mixed": (JB.periodic, JB.open, JB.periodic)}
GRID = jcm.CMGrid(n=3, cap=4, nzi=2, nxi=4)


def _apply_table(table, stack, cap, box, xyz_rows):
    """The kernel's arithmetic, in numpy float32."""
    out = stack.copy()
    lengths = np.float32([box.lx, box.ly, box.lz])
    for dst, src, code, _ in table:
        d = slice(dst * cap, (dst + 1) * cap)
        s = slice(src * cap, (src + 1) * cap)
        if xyz_rows is not None and code & 64:
            out[:, d] = 0.0
            out[list(xyz_rows), d] = np.float32(tpv.FILL_POS)
            continue
        out[:, d] = stack[:, s]
        if xyz_rows is None:
            continue
        for k, r in enumerate(xyz_rows):
            side = ((code >> (2 * k)) & 3) - 1
            if box.periodic[k]:
                out[r, d] = out[r, d] + side * lengths[k]
    return out


@pytest.mark.parametrize("refresh_z", [True, False], ids=["K1", "K1z"])
@pytest.mark.parametrize("boxname", sorted(BOXES))
def test_ghost_table_matches_jax(boxname, refresh_z):
    bx, by, bz = BOXES[boxname]
    if not refresh_z:
        bz = JB.open                 # the sharded engines' local box
    jb = JBox(-0.5, 0.5, -0.5, 0.5, -0.5, 0.5, bx, by, bz)
    tb = box_from_numpy([-0.5, 0.5] * 3, [b.value for b in (bx, by, bz)])
    tg = tcm.CMGrid(n=GRID.n, cap=GRID.cap, nzi=GRID.nzi, nxi=GRID.nxi)
    table = tpv._ghost_maps(tg, tb, refresh_z)["table"]
    cap = GRID.cap

    # sources: row 0 holds each slot's cell id; a plain copy shows them
    ids = np.repeat(np.arange(GRID.n_cells, dtype=np.float32), cap)[None]
    got = np.asarray(jpv.make_ghost_refresh(
        GRID, jb, 1, interpret=True, refresh_z=refresh_z)(jnp.asarray(ids)))
    moved = (got[0] != ids[0]).reshape(-1, cap).any(1)
    src = got[0].reshape(-1, cap)[:, 0].astype(np.int64)
    np.testing.assert_array_equal(table[:, 1], src[table[:, 0]])
    assert not moved[np.setdiff1d(np.arange(GRID.n_cells), table[:, 0])].any()
    assert len(np.unique(table[:, 0])) == len(table)

    # the whole refresh, with and without coordinate rows
    r = np.random.default_rng(7)
    for nrows, xyz_rows in ((5, (0, 1, 2)), (4, (3, 1, 0)), (3, None)):
        stack = r.normal(0, 1, (nrows, GRID.n_slots)).astype(np.float32)
        want = np.asarray(jpv.make_ghost_refresh(
            GRID, jb, nrows, xyz_rows=xyz_rows, interpret=True,
            refresh_z=refresh_z)(jnp.asarray(stack)))
        np.testing.assert_array_equal(
            _apply_table(table, stack, cap, tb, xyz_rows), want)
        plain = tpv.GhostRefresh(refresh_z).plain(
            torch.from_numpy(stack.copy()), tg, tb, xyz_rows)
        np.testing.assert_array_equal(plain.numpy(), want)
