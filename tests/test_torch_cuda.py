"""The port's CUDA kernels against their plain PyTorch versions, on the
card. CUDA kernels have no CPU mode, so these tests skip without a GPU;
run them on a GPU host with

    python -m pytest tests/test_torch_cuda.py -q -m gpu --noconftest

(--noconftest: tests/conftest.py imports JAX, which this file does not
need and a GPU host may lack.)

Inputs: one resident step of a perturbed Sedov 12^3 frame on a cap-64
grid, recorded on the CPU. Tolerances as tests/test_torch_pair_ve.py
(nc and nonconv exact; rtol 1e-5 on h, xm, kx, gradh, alpha and
maxvsignal; 1e-4 of the row's scale on the cancelling sums), and K1
bit-equal. The gated stages (K2g) take the same inputs with a seeded
activity pattern: the slots of active z-supercells hold those
tolerances, and the interior slots of inactive ones equal prev bit for
bit.
"""

import numpy as np
import pytest
import torch

from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.init.sedov import init_sedov
from sphexa_tpu_torch.ops import pair_ve as pv
from sphexa_tpu_torch.ops.cellmajor import CMGrid, _interior_cells_np
from sphexa_tpu_torch.propagator.ve_cellmajor import ResidentVE
from sphexa_tpu_torch.sfc.box import Box, Boundary

pytestmark = pytest.mark.gpu

EXACT = {"pair_xh": (2, 3)}
RELATIVE = {"pair_xh": (0, 1), "pair_gradh": (0, 1), "pair_av": (0,),
            "pair_momentum": (4,)}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module")
def recorded(cuda):
    """(kernel, J, I2) of every pair stage of one step, on the CPU."""
    state, box, cfg = init_sedov(12, SphConfig(), dt0=3e-5, device="cpu")
    r = np.random.default_rng(0)
    n = 12 ** 3
    h0 = float(state.p.h[0])
    upd = {c: getattr(state.p, c) + torch.from_numpy(
        r.normal(0, 0.03 * h0, n).astype(np.float32)) for c in "xyz"}
    upd.update({c: torch.from_numpy(r.normal(0, 0.3, n).astype(np.float32))
                for c in ("vx", "vy", "vz")})
    state = state.replace(p=state.p.replace(**upd))
    grid = CMGrid(n=4, cap=64)
    eng = ResidentVE(box, grid, cfg, device="cpu")
    calls = []
    for k in pv.KERNELS[1:]:
        def plain(J, I2, g, c, k=k, orig=k.plain):
            calls.append((k, J.clone(), None if I2 is None else I2.clone()))
            return orig(J, I2, g, c)
        k.plain = plain
    try:
        eng.step(eng.bind(state))
    finally:
        for k in pv.KERNELS[1:]:
            del k.plain
    return calls, grid, cfg, eng.intmask


@pytest.mark.parametrize("name", ["pair_xh", "pair_gradh", "pair_iad",
                                  "pair_av", "pair_momentum"])
def test_pair_kernel_matches_plain(recorded, cuda, name):
    calls, grid, cfg, intmask = recorded
    k, J, I2 = next(c for c in calls if c[0].name == name)
    J = J.to(cuda)
    I2 = None if I2 is None else I2.to(cuda)
    before = k.launches
    out = k(J, I2, grid, cfg)
    assert k.launches == before + 1
    ref = k.plain(J, I2, grid, cfg)
    mask = (intmask.to(cuda) & (J[0] < 0.5 * pv.FILL_POS))
    _check_rows(name, ref, out, mask)


def _check_rows(name, ref, out, mask):
    a, b = ref[:, mask].cpu().numpy(), out[:, mask].cpu().numpy()
    for r in range(a.shape[0]):
        if r in EXACT.get(name, ()):
            np.testing.assert_array_equal(b[r], a[r])
        elif r in RELATIVE.get(name, ()):
            np.testing.assert_allclose(b[r], a[r], rtol=1e-5)
        else:
            assert np.abs(b[r] - a[r]).max() <= 1e-4 * max(
                np.abs(a[r]).max(), 1e-30), r


@pytest.mark.parametrize("zgroup", [0, 1], ids=["Z6", "Z1"])
@pytest.mark.parametrize("name", ["pair_xh", "pair_gradh", "pair_iad",
                                  "pair_av", "pair_momentum"])
def test_gated_kernel_matches_plain(recorded, cuda, name, zgroup):
    calls, grid, cfg, intmask = recorded
    k, J, I2 = next(c for c in calls if c[0].name == name)
    kg = next(g for g in pv.GATED_KERNELS if g.name == name + "_gated")
    J = J.to(cuda)
    I2 = None if I2 is None else I2.to(cuda)
    r = np.random.default_rng(2)
    # per z-cell of the interior: active (all slots), mixed (one slot)
    # or inactive, and every third column wholly inactive, so supercells
    # of every kind occur
    kind = r.integers(0, 3, (grid.npx, grid.np_, grid.npz))
    kind[~_interior_cells_np(grid).reshape(kind.shape)] = 0
    cx, cy = np.meshgrid(np.arange(grid.npx), np.arange(grid.np_),
                         indexing="ij")
    kind[(cx + cy) % 3 == 0] = 0
    act = np.zeros((grid.npx, grid.np_, grid.npz, grid.cap), np.float32)
    act[kind == 2] = 1.0
    act[..., 0][kind == 1] = 1.0
    act = torch.from_numpy(act.reshape(-1)).to(cuda)
    prev = torch.from_numpy(r.normal(0, 1, (kg.fo, grid.n_slots)).astype(
        np.float32)).to(cuda)
    before = kg.launches
    out = kg(J, I2, grid, cfg, (act, prev), zgroup)
    assert kg.launches == before + 1
    ref = kg.plain(J, I2, grid, cfg, (act, prev), zgroup)
    on = pv.supercell_active(act, grid, pv.resolve_zgroup(grid, zgroup))
    on = on.repeat_interleave(grid.cap)
    keep = intmask.to(cuda) & ~on
    assert keep.any() and on.any()
    assert torch.equal(out[:, keep], prev[:, keep])
    assert torch.equal(ref[:, keep], prev[:, keep])
    _check_rows(name, ref, out, on & intmask.to(cuda)
                & (J[0] < 0.5 * pv.FILL_POS))


@pytest.mark.parametrize("boundary", ["periodic", "open"])
def test_ghost_refresh_matches_plain(cuda, boundary):
    grid = CMGrid(n=4, cap=64, nzi=6)
    box = Box.cube(-0.5, 0.5, Boundary[boundary])
    r = np.random.default_rng(1)
    for rows in ((0, 1, 2), None):
        st = torch.from_numpy(r.normal(0, 1, (12, grid.n_slots)).astype(
            np.float32)).to(cuda)
        ref = pv.ghost_refresh.plain(st.clone(), grid, box, rows)
        out = pv.ghost_refresh(st.clone(), grid, box, rows)
        assert torch.equal(ref, out)
