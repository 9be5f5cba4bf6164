"""Slot caps past 1024: the port's planners against the JAX package on a
clustered field, the pair kernels' one ceiling (pair_ve.MAX_CAP, 4096,
the JAX tile adapter's cap_max off the TPU), and the plain versions
taking a cell's i-slots in slices at large caps.

The field: 12,000 seeded points in the open cube [-1, 1]^3, an eighth of
them in a clump of sigma 0.01, h_max 0.05. Its densest cell holds
about 1,500 points at every grid the 2 h_max bound allows, so the JAX
slab rule's cap is 2048 and the JAX tile rule's 1920, both past the
former ceiling of 1024 (where plan_slab raised "too clustered"). The
plans are integers and are held exactly. The stages themselves at cap
1152 are held against PallasVE in tests/test_torch_bigcap_stages.py
and test_torch_bigcap_momentum.py.
"""

import jax
import numpy as np
import pytest
import torch

from sphexa_tpu.ops import cellmajor as jcm
from sphexa_tpu.propagator import multichip as jmc
from sphexa_tpu.sfc.box import Box as JBox, Boundary as JB
from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.interop import box_from_numpy
from sphexa_tpu_torch.ops import _cuda
from sphexa_tpu_torch.ops import pair_ve as tpv
from sphexa_tpu_torch.ops.cellmajor import CMGrid
from sphexa_tpu_torch.propagator.ve_pallas_tiles import plan_tile_domain
from sphexa_tpu_torch.propagator.ve_sharded import plan_slab
from torch_threads import one_torch_thread  # noqa: F401

H_MAX = 0.05


@pytest.fixture(scope="module")
def field():
    r = np.random.default_rng(19)
    n = 12000
    core = r.random(n) < 0.125
    host = {c: np.where(core, r.normal(0.3, 0.01, n), r.uniform(-1, 1, n))
            .clip(-0.999, 0.999).astype(np.float32) for c in "xyz"}
    jb = JBox(-1.0, 1.0, -1.0, 1.0, -1.0, 1.0, JB.open, JB.open, JB.open)
    return host, jb, box_from_numpy([-1, 1, -1, 1, -1, 1], [0, 0, 0])


def test_plan_slab_is_the_jax_plan_past_1024(field):
    """(a) plan_slab returns MultiChipAdapter._slab_setup's grid and
    SlabConfig where the JAX cap is past 1024; with the former ceiling
    as cap_max it still takes the finer-grid search, which finds none
    here."""
    host, jb, tb = field
    ad = jmc.MultiChipAdapter.__new__(jmc.MultiChipAdapter)
    ad.D, ad.n_global = 2, len(host["x"])
    jg, jsc, _, _ = ad._slab_setup(host, jb, H_MAX, list(jax.devices()[:2]),
                                   quiet=True)
    assert 1024 < jg.cap <= tpv.MAX_CAP
    tg, tsc = plan_slab(host, tb, H_MAX, 2)
    assert (tg.n, tg.cap, tg.nzi, tg.nxi) == (jg.n, jg.cap, jg.nzi, jg.nxi)
    assert (tsc.n_slabs, tsc.cap, tsc.halo_cap, tsc.mig_cap) == (
        jsc.n_slabs, jsc.cap, jsc.halo_cap, jsc.mig_cap)
    with pytest.raises(RuntimeError, match="too clustered"):
        plan_slab(host, tb, H_MAX, 2, cap_max=1024)


def test_plan_tile_domain_is_the_jax_grid_past_1024(field):
    """(b) plan_tile_domain's grid is the JAX tile adapter's
    choose_cap_and_grid(h_max * 1.25, cap_max=4096, headroom=16) off the
    TPU (multichip.py:210-216)."""
    host, jb, tb = field
    n = len(host["x"])
    _, jg = jcm.choose_cap_and_grid(jb, H_MAX * 1.25, n, host["x"],
                                    host["y"], host["z"], cap_max=4096,
                                    headroom=16)
    assert jg.cap > 1024
    tg, td = plan_tile_domain(tb, host, H_MAX, n, 4)
    assert (tg.n, tg.cap, tg.nzi, tg.nxi) == (jg.n, jg.cap, jg.nzi, jg.nxi)
    assert (td.n_rows, td.n_cols, td.n) == (2, 2, jg.n)


@pytest.mark.parametrize("cap", [4128, 1040, 0])
def test_pair_ve_refuses_caps(cap):
    """(d) PairVE refuses a cap past the ceiling or not a multiple of
    32, naming the ceiling; so does a pair kernel's launch, before any
    library is built or loaded."""
    cfg = SphConfig()
    grid = CMGrid(n=2, cap=cap)
    with pytest.raises(ValueError, match=f"at most {tpv.MAX_CAP}"):
        tpv.PairVE(grid, cfg)
    J = torch.zeros((tpv.pair_xh.fj, 1))
    with pytest.raises(ValueError, match=f"at most {tpv.MAX_CAP}"):
        tpv.pair_xh._launch(J, None, grid, cfg)


def test_one_ceiling_for_kernels_and_wrappers():
    """The kernels' launch check reads the wrappers' ceiling: the header
    that csrc/cell_pair.cu includes is generated from pair_ve.MAX_CAP,
    and bad_launch tests the header's constant."""
    assert tpv.MAX_CAP == 4096
    assert f"#define SPH_MAX_CAP {tpv.MAX_CAP}\n" in _cuda._consts_header()
    src = (_cuda._CSRC / "cell_pair.cu").read_text()
    assert "g.cap > SPH_MAX_CAP" in src
    tpv.PairVE(CMGrid(n=2, cap=tpv.MAX_CAP), SphConfig())


def _frame(cap, seed):
    """A 2 x 2 x 2 open frame at `cap`: every row of every slot random
    (x, y, z in the cell's neighbourhood, h so that pairs are in
    support), a quarter of the slots invalid."""
    from sphexa_tpu_torch.ops.pair_ve import FILL_POS
    r = np.random.default_rng(seed)
    grid = CMGrid(n=2, cap=cap)
    J = r.uniform(0.5, 1.5, (tpv.NBASE + 22, grid.n_slots))
    J[:3] = r.uniform(-1, 1, (3, grid.n_slots))
    J[tpv.RH] = r.uniform(0.2, 0.4, grid.n_slots)
    J[tpv.RGID] = np.arange(grid.n_slots)
    bad = r.random(grid.n_slots) < 0.25
    J[:3, bad] = FILL_POS
    J[tpv.RGID, bad] = -1.0
    I2 = r.uniform(0.5, 1.5, (8, grid.n_slots))
    return (torch.from_numpy(J.astype(np.float32)),
            torch.from_numpy(I2.astype(np.float32)), grid)


@pytest.mark.parametrize("name", ["pair_xh", "pair_gradh", "pair_iad",
                                  "pair_av", "pair_momentum",
                                  "pair_momentum_avclean", "pair_iad_mm",
                                  "pair_av_mm", "pair_momentum_mm"])
def test_plain_slices_equal_whole_cells(name, monkeypatch):
    """Past cap 384 a plain version takes a cell's i-slots in slices, so
    that its temporaries stay within _PAIR_BUDGET at caps to 4096; the
    moment bodies take their origin from the whole cell. On a random
    frame at cap 96 with the budget cut to 16-row slices, each stage is
    within 1e-6 of its whole-cell evaluation at each output row's scale,
    K3's counts exactly: each slot's sums are the same operations, but
    PyTorch's CPU kernels round differently by the shape they are given
    (K3's torch.pow in the last place; the moment bodies' matmul is
    blocked by its row count)."""
    k = getattr(tpv, name)
    J, I2, grid = _frame(96, 3)
    J = J[:k.fj].contiguous()
    I2 = I2 if k.fi2 else None
    cfg = SphConfig()
    whole = k.plain(J, I2, grid, cfg)
    monkeypatch.setattr(tpv, "_PAIR_BUDGET", 27 * 96 * 16)
    sliced = k.plain(J, I2, grid, cfg)
    scale = whole.abs().amax(1, keepdim=True).clamp_min(1e-30)
    assert float(((sliced - whole).abs() / scale).max()) <= 1e-6
    if name == "pair_xh":
        assert torch.equal(sliced[2:], whole[2:])      # nc, nonconv
    assert torch.isfinite(whole).all()
