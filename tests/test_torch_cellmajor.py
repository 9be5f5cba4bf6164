"""The port's cell-major layout against the JAX package.

The planners must return the same (cap, grid), and the layout the same
slots, exactly: slot order inside a cell follows the stable sort of
both packages, so src, valid, slot_of and overflow are equal integers,
and the gathers built on them are equal floats.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.init.sedov import init_sedov as j_init_sedov
from sphexa_tpu.ops import cellmajor as jcm
from sphexa_tpu.sfc.box import Box as JBox, Boundary as JBoundary
from sphexa_tpu_torch.interop import box_from_numpy
from sphexa_tpu_torch.ops import cellmajor as tcm
from torch_threads import one_torch_thread  # noqa: F401


def _tbox(jb):
    return box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                           jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])


def _tgrid(g):
    return tcm.CMGrid(n=g.n, cap=g.cap, nzi=g.nzi, nxi=g.nxi)


def _sedov_xyz(side):
    st, box, _ = j_init_sedov(side, JCfg(), dt0=1e-5)
    xyz = [np.asarray(getattr(st.p, c)) for c in "xyz"]
    return st, box, xyz


@pytest.mark.parametrize("side", [10, 12])
def test_planners_match(side):
    st, jb, xyz = _sedov_xyz(side)
    tb = _tbox(jb)
    h0 = float(st.p.h[0])
    n = side ** 3
    for h_eff in (h0 * 1.2, h0 * 0.6):
        jc, jg = jcm.choose_cap_and_grid(jb, h_eff, n, *xyz)
        tc, tg = tcm.choose_cap_and_grid(tb, h_eff, n, *xyz)
        assert (tc, tg) == (jc, _tgrid(jg))
        jc, jg = jcm.choose_cap_and_grid(jb, h_eff, n, *xyz, headroom=8)
        tc, tg = tcm.choose_cap_and_grid(tb, h_eff, n, *xyz, headroom=8)
        assert (tc, tg) == (jc, _tgrid(jg))
    a = jcm.choose_grid_with_hcap(jb, n, *xyz)
    b = tcm.choose_grid_with_hcap(tb, n, *xyz)
    assert (b[0], b[1], b[2]) == (a[0], _tgrid(a[1]), a[2])
    for cap in (64, 128, 256):
        assert _tgrid(jcm.choose_cm_grid(jb, h0 * 1.3, n, cap=cap)) == \
            tcm.choose_cm_grid(tb, h0 * 1.3, n, cap=cap)
    for npz in range(3, 40):
        for cap in (64, 128, 192, 256):
            assert tcm.legal_zgroup(npz, cap) == jcm.legal_zgroup(npz, cap)
    g = jcm.CMGrid(n=4, cap=64)
    assert tcm.max_cell_count(_tgrid(g), tb, *xyz) == \
        jcm.max_cell_count(g, jb, *xyz)


def _layout_pair(jb, grid, xyz, alive):
    tb = _tbox(jb)
    jl = jcm.build_layout(grid, jb, *map(jnp.asarray, xyz),
                          alive=None if alive is None else jnp.asarray(alive))
    tl = tcm.build_layout(_tgrid(grid), tb, *map(torch.from_numpy, xyz),
                          alive=None if alive is None
                          else torch.from_numpy(alive))
    return jl, tl


CASES = {
    # Sedov 10^3 jittered off the lattice, a few dead rows, periodic box
    "sedov_dead_rows": dict(boundary=JBoundary.periodic, cap=128, n=2,
                            dead=7),
    # overflowing cap: dropped particles park on the sentinel slot
    "overflow": dict(boundary=JBoundary.periodic, cap=64, n=2, dead=0),
    # open box: ghost cells stay empty
    "open_box": dict(boundary=JBoundary.open, cap=64, n=4, dead=3),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def layouts(request):
    c = CASES[request.param]
    st, _, xyz = _sedov_xyz(10)
    jb = JBox.cube(-0.5, 0.5, c["boundary"])
    r = np.random.default_rng(11)
    xyz = [(a + r.normal(0, 0.02, a.shape)).astype(np.float32) for a in xyz]
    alive = None
    if c["dead"]:
        alive = np.ones(xyz[0].shape, bool)
        alive[r.choice(alive.size, c["dead"], replace=False)] = False
    grid = jcm.CMGrid(n=c["n"], cap=c["cap"])
    jl, tl = _layout_pair(jb, grid, xyz, alive)
    fields = {k: r.normal(0, 1, xyz[0].shape).astype(np.float32)
              for k in ("h", "v")}
    return request.param, grid, xyz, jl, tl, fields


def test_build_layout_equal(layouts):
    name, grid, _, jl, tl, _ = layouts
    for f in ("src", "valid", "slot_of", "interior", "ghost_pull"):
        np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                      np.asarray(getattr(jl, f)), err_msg=f)
    for a, b in zip(jl.shift, tl.shift):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert int(tl.overflow) == int(jl.overflow)
    if name == "overflow":
        assert int(tl.overflow) > 0


def test_gathers_equal(layouts):
    _, grid, xyz, jl, tl, fields = layouts
    for fill in (0.0, 1.0):
        np.testing.assert_array_equal(
            tcm.to_cm(tl, torch.from_numpy(fields["h"]), fill).numpy(),
            np.asarray(jcm.to_cm(jl, jnp.asarray(fields["h"]), fill)))
    for a, b in zip(jcm.positions_cm(jl, *map(jnp.asarray, xyz)),
                    tcm.positions_cm(tl, *map(torch.from_numpy, xyz))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    cm = np.random.default_rng(3).normal(0, 1, grid.n_slots).astype(
        np.float32)
    n = xyz[0].shape[0]
    np.testing.assert_array_equal(
        tcm.from_cm(tl, torch.from_numpy(cm), n, 2.5).numpy(),
        np.asarray(jcm.from_cm(jl, jnp.asarray(cm), n, 2.5)))


def test_ghost_static_and_interior_mask():
    for boundary in (JBoundary.periodic, JBoundary.open):
        jb = JBox.cube(-0.5, 0.5, boundary)
        grid = jcm.CMGrid(n=3, cap=32, nzi=4)
        a = jcm.ghost_static(grid, jb)
        b = tcm.ghost_static(_tgrid(grid), _tbox(jb))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
        np.testing.assert_array_equal(
            tcm.interior_mask(_tgrid(grid), "cpu").numpy(),
            np.asarray(jcm.interior_mask(grid)))
