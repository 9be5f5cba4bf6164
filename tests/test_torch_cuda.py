"""The port's CUDA kernels against their plain PyTorch versions, on the
card. CUDA kernels have no CPU mode, so these tests skip without a GPU;
run them on a GPU host with

    python -m pytest tests/test_torch_cuda.py -q -m gpu --noconftest

(--noconftest: tests/conftest.py imports JAX, which this file does not
need and a GPU host may lack.)

Inputs: one resident step of a perturbed Sedov 12^3 frame on a cap-64
grid, recorded on the CPU under each body configuration (direct, the
moment-matmul bodies K8-K10, avClean K7c); K10 with mxu_bf16 takes the
float32 run's inputs. Tolerances as tests/test_torch_pair_ve.py (nc and
nonconv exact; rtol 1e-5 on h, xm, kx, gradh, alpha and maxvsignal;
1e-4 of the row's scale on the cancelling sums), and K1 bit-equal. K10
under mxu_bf16 is held against its plain version at a quarter of the
plain version's own bf16-to-float32 distance per row, and must lie at
least half that distance from float32: an operand one float32 ulp
apart (FMA contraction, the cell-mean summation order) can round to
the neighbouring bf16 value, and where a moment sum cancels one such
flip moves it by a share of bf16's own error (on the card: 1.4e-3 of
the row's scale against a bf16-to-float32 distance of 2.5e-2 at Sedov
30^3 on CMGrid(n=8, cap=64), 9% of it at the 100^3 main-path inputs;
2.3e-5 against 4.9e-3 here). The gated stages (K2g) take the same inputs
with a seeded activity pattern: the slots of active z-supercells hold
those tolerances, and the interior slots of inactive ones equal prev
bit for bit. The column launch (K11) takes the same inputs and equals
the cell launch bit for bit on interior slots in every form, zero
elsewhere. K3-K7 and K7c are also held on synthetic frames at caps 64,
128 and 256 (empty, partial and full cells; at cap 256 a partial cell
of fewer than 128 particles leaves its second i-tile empty), with their
K2g and K11 forms; K3's nc, h and nonconv bit-equal to plain on every
interior slot, under controllers whose h moves in the first round, a
later one or never; invalid interior slots exactly 1.0 for K4 (kx and
gradh) and 0 for the others. K8 (tile::IadMmStage) and K10 (the
tensor-core form, float32 and mxu_bf16) are held on the same synthetic
frames at caps 64, 128 and 256 with their K2g and K11 forms: K8's 14
rows and K10's ax, ay, az, du at 1e-4 of their row's scale, K10's
maxvsignal at rtol 1e-5, K10 under mxu_bf16 as above against its plain
version (its K2g form bit-equal to the cell launch on active slots).
K9 (tile::AvMmStage) is held on K6's synthetic frames at caps 64, 128
and 256 with its K2g and K11 forms. Each gated stage is also launched
as the engines launch it (the gate pass, then the stage's blocks over
its list) with no active supercell, all active and chip_smoke.py's
seeded activity pattern: the device count and list equal gate_plan's,
inactive interior slots equal prev and active ones the ungated launch,
bit for bit, and the slots outside the interior cells hold 0.
The probe kernels (P1-P5) are held against their
plain versions: P1-P4 rtol 1e-6 (the same float32 operations), P5 1e-5 of the
output's scale (TF32: 5e-3), each design (mma_sync, wgmma and wgmma with
its overlap off) at 1 cell, 64 and past the persistent grid. K1z (the ghost refresh with refresh_z=False)
is bit-equal to its plain version, and the slab-sharded resident step
(two shards on the one card) holds the CPU run's diagnostics at the
tolerances of chip_smoke.py's engine check (dt rtol 1e-5, eint 1e-6,
ecin 1e-3) after two Sedov 12^3 steps.
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
            "pair_momentum": (4,), "pair_av_mm": (0,),
            "pair_momentum_mm": (4,), "pair_momentum_avclean": (4,)}
CONFIGS = (dict(), dict(mxu_moments=True, mxu_momentum=True),
           dict(av_clean=True))
STAGES = ["pair_xh", "pair_gradh", "pair_iad", "pair_av", "pair_momentum",
          "pair_iad_mm", "pair_av_mm", "pair_momentum_mm",
          "pair_momentum_mm_bf16", "pair_momentum_avclean"]
GATED = ["pair_xh", "pair_gradh", "pair_iad", "pair_av", "pair_momentum",
         "pair_iad_mm", "pair_av_mm", "pair_momentum_mm"]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module")
def recorded(cuda):
    """{stage name: (kernel, J, I2, cfg)} of every pair stage of one step
    under each configuration, on the CPU."""
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
    kerns = [k for k in pv.PAIR_KERNELS if not k.gated]
    calls = {}
    for flags in CONFIGS:
        eng = ResidentVE(box, grid, cfg.replace(**flags), device="cpu")
        for k in kerns:
            def plain(J, I2, g, c, k=k, orig=k.plain):
                calls[k.name] = (k, J.clone(),
                                 None if I2 is None else I2.clone(), c)
                return orig(J, I2, g, c)
            k.plain = plain
        try:
            eng.step(eng.bind(state))
        finally:
            for k in kerns:
                del k.plain
    k, J, I2, c = calls["pair_momentum_mm"]
    calls["pair_momentum_mm_bf16"] = (k, J, I2, c.replace(mxu_bf16=True))
    return calls, grid, eng.intmask


@pytest.mark.parametrize("name", STAGES)
def test_pair_kernel_matches_plain(recorded, cuda, name):
    calls, grid, intmask = recorded
    k, J, I2, cfg = calls[name]
    J = J.to(cuda)
    I2 = None if I2 is None else I2.to(cuda)
    before = k.launches
    out = k(J, I2, grid, cfg)
    assert k.launches == before + 1
    ref = k.plain(J, I2, grid, cfg)
    mask = (intmask.to(cuda) & (J[0] < 0.5 * pv.FILL_POS))
    if name.endswith("_bf16"):
        _check_bf16(ref, out, k.plain(J, I2, grid,
                                      cfg.replace(mxu_bf16=False)), mask)
    else:
        _check_rows(name, ref, out, mask)


def _check_bf16(ref, out, ref32, mask):
    a, b, f = (x[:, mask].cpu().double().numpy() for x in (ref, out, ref32))
    assert np.isfinite(b).all()
    for r in range(4):
        scale = np.abs(f[r]).max()
        d_ref = np.abs(a[r] - f[r]).max() / scale
        assert np.abs(b[r] - a[r]).max() / scale <= 0.25 * d_ref, r
        assert np.abs(b[r] - f[r]).max() / scale >= 0.5 * d_ref, r
    np.testing.assert_allclose(b[4], a[4], rtol=1e-5)


def _check_rows(name, ref, out, mask, scaled=()):
    """Per row: exact, rtol 1e-5, or (the cancelling sums, and the rows
    in `scaled`) 1e-4 of the row's scale."""
    a, b = ref[:, mask].cpu().numpy(), out[:, mask].cpu().numpy()
    assert np.isfinite(b).all()
    for r in range(a.shape[0]):
        if r in EXACT.get(name, ()):
            np.testing.assert_array_equal(b[r], a[r])
        elif r in RELATIVE.get(name, ()) and r not in scaled:
            np.testing.assert_allclose(b[r], a[r], rtol=1e-5)
        else:
            assert np.abs(b[r] - a[r]).max() <= 1e-4 * max(
                np.abs(a[r]).max(), 1e-30), r


@pytest.mark.parametrize("zgroup", [0, 1], ids=["Z6", "Z1"])
@pytest.mark.parametrize("name", GATED)
def test_gated_kernel_matches_plain(recorded, cuda, name, zgroup):
    calls, grid, intmask = recorded
    k, J, I2, cfg = calls[name]
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


@pytest.mark.parametrize("bxy", ["periodic", "open"])
@pytest.mark.parametrize("grid", [CMGrid(n=4, cap=64, nzi=2),
                                  CMGrid(n=22, cap=256, nzi=11)],
                         ids=["12cube_D2", "100cube_D2"])
def test_k1z_matches_plain(cuda, bxy, grid):
    """K1z on the sharded engines' box (z open), random stacks of 1 to
    15 rows, with and without coordinate rows: bit-equal, and the
    interior columns untouched."""
    b = Boundary[bxy]
    box = Box(-0.5, 0.5, -0.5, 0.5, -0.5, 0.5, b, b, Boundary.open)
    r = np.random.default_rng(2)
    for nrows, rows in ((1, None), (5, None), (12, (0, 1, 2)),
                        (15, (0, 1, 2))):
        st = torch.from_numpy(r.normal(0, 1, (nrows, grid.n_slots)).astype(
            np.float32)).to(cuda)
        ref = pv.ghost_refresh_xy.plain(st.clone(), grid, box, rows)
        before = pv.ghost_refresh_xy.launches
        out = pv.ghost_refresh_xy(st.clone(), grid, box, rows)
        assert pv.ghost_refresh_xy.launches == before + 1
        assert torch.equal(ref, out)
        assert not torch.equal(out, st)


# K1 and K1z in each form of csrc/ghost_refresh.cu: float4 (cap % 4 == 0,
# 16-byte aligned stack), scalar by shape (cap 6) and scalar by pointer
# (a contiguous stack 4 bytes past an aligned allocation)
GHOST_FORMS = {"float4": (CMGrid(n=4, cap=64, nzi=3, nxi=5), 0),
               "scalar_cap": (CMGrid(n=3, cap=6, nzi=4, nxi=2), 0),
               "scalar_ptr": (CMGrid(n=4, cap=64, nzi=3, nxi=5), 1)}


@pytest.mark.parametrize("form", sorted(GHOST_FORMS))
@pytest.mark.parametrize("boundary", ["periodic", "open", "mixed"])
@pytest.mark.parametrize("refresh_z", [True, False], ids=["K1", "K1z"])
def test_ghost_refresh_forms_match_plain(cuda, form, boundary, refresh_z):
    """1 to 15 rows, with and without coordinate rows: bit-equal to the
    plain version, one launch counted each."""
    grid, skew = GHOST_FORMS[form]
    bx = {"periodic": Boundary.periodic, "open": Boundary.open,
          "mixed": Boundary.periodic}[boundary]
    by = Boundary.open if boundary == "mixed" else bx
    bz = Boundary.open if not refresh_z else bx
    box = Box(-0.5, 0.5, -0.5, 0.4, -0.5, 0.7, bx, by, bz)
    kern = pv.ghost_refresh if refresh_z else pv.ghost_refresh_xy
    r = np.random.default_rng(9)
    for nrows in range(1, 16):
        for rows in ((None, (0, 1, 2), (2, 0, 1)) if nrows >= 3
                     else (None,)):
            st = torch.from_numpy(r.normal(0, 1, (nrows, grid.n_slots))
                                  .astype(np.float32))
            buf = torch.empty(st.numel() + skew, device=cuda)
            dev = buf[skew:].view(st.shape)
            dev.copy_(st)
            assert (dev.data_ptr() % 16 == 0) == (skew == 0)
            ref = kern.plain(st.clone(), grid, box, rows)
            before = kern.launches
            out = kern(dev, grid, box, rows)
            assert kern.launches == before + 1 and out is dev
            assert torch.equal(out.cpu(), ref), (nrows, rows)


# K3, K5, K7, K7c, their K2g forms and K11's forms on synthetic frames at
# caps 64, 128 and 256: every padded cell empty, partly filled or full
# (valid slots a prefix, as build_layout fills them)
MOMENTUM_CAPS = (64, 128, 256)


def _base_frame(grid, r, h_lo, h_hi):
    """Rows x, y, z, h, gid on `grid` from the generator r: particles
    uniform in their padded cell, h uniform in [h_lo, h_hi) of a cell;
    invalid slots carry FILL_POS positions and the engine's fills. Also
    returns the validity row and a uniform sampler over the slots."""
    cap, nc = grid.cap, grid.n_cells
    kind = np.arange(nc) % 3
    r.shuffle(kind)
    count = np.where(kind == 0, 0, np.where(kind == 2, cap,
                                            r.integers(1, cap, nc)))
    valid = (np.arange(cap)[None] < count[:, None]).reshape(-1)
    dx = 1.0 / grid.n
    cx, cy, cz = (np.repeat(c, cap) for c in
                  np.unravel_index(np.arange(nc),
                                   (grid.npx, grid.np_, grid.npz)))
    ns = grid.n_slots
    u = lambda lo, hi: r.uniform(lo, hi, ns)          # noqa: E731
    pos = [-0.5 + (c - 1 + u(0, 1)) * dx for c in (cx, cy, cz)]
    fill = np.where(valid, 0.0, pv.FILL_POS)
    rows = [np.where(valid, p, 0.0) + fill for p in pos]
    rows += [np.where(valid, u(h_lo, h_hi) * dx, 1.0),
             np.where(valid, np.arange(ns), -1.0)]            # h, gid
    return rows, valid, u, dx


def _momentum_frame(grid, av_clean, seed):
    """J rows of the momentum stage (PairVE.momentum's order) on `grid`,
    seeded: h 0.35-0.45 of a cell, the other rows in ranges the step
    produces."""
    r = np.random.default_rng(seed)
    rows, valid, u, dx = _base_frame(grid, r, 0.35, 0.45)
    ns = grid.n_slots
    rows += [r.normal(0, 1, ns) for _ in range(3)]            # v
    rows += [np.where(valid, u(0.5, 1.5), 1.0),               # c
             np.where(valid, u(0.1, 1.0), 0.0),               # prho
             np.where(valid, u(0.5, 2.0), 1.0),               # rho
             u(0.5, 1.5) * dx ** 3,                           # xm
             u(0.05, 1.0), u(0.5, 1.5) * dx ** 3]             # alpha, m
    rows += [r.normal(0, 1, ns) for _ in range(6)]            # cij
    if av_clean:
        rows += [r.normal(0, 1, ns) for _ in range(6)]        # gradv
        rows += [u(0.5, 1.5)]                                 # eta_crit
    J = np.stack(rows).astype(np.float32)
    return J, valid


def _check_forms(k, J, grid, cfg, out, intmask, mask, seed, gated=True,
                 I2=None, scaled=(), plain=True):
    """K11 at zseg 1-3 bit-equal to the cell launch `out` on interior
    slots and zero elsewhere; K2g (gated) against its gated plain
    version (plain=False: not held against it, as K10 under mxu_bf16,
    whose cell launch the caller has held), inactive slots equal to
    prev, active valid slots bit-equal to the cell launch."""
    kc = next(c for c in pv.COLUMN_KERNELS if c.name == k.name + "_column")
    saved = kc.zseg
    try:
        for zseg in (1, 2, 3):
            kc.zseg = zseg
            col = kc(J, I2, grid, cfg)
            assert torch.equal(col[:, intmask], out[:, intmask]), zseg
            assert not col[:, ~intmask].any()
    finally:
        kc.zseg = saved
    if not gated:
        return
    kg = next(g for g in pv.GATED_KERNELS if g.name == k.name + "_gated")
    cap = grid.cap
    r = np.random.default_rng(seed)
    act = torch.from_numpy((r.uniform(0, 1, (grid.npx, grid.np_, grid.npz,
                                              1)) < 0.5).repeat(cap, -1)
                           .reshape(-1).astype(np.float32)).to(J.device)
    prev = torch.from_numpy(r.normal(0, 1, (kg.fo, grid.n_slots)).astype(
        np.float32)).to(J.device)
    gout = kg(J, I2, grid, cfg, (act, prev), 1)
    gref = kg.plain(J, I2, grid, cfg, (act, prev), 1)
    on = pv.supercell_active(act, grid, 1).repeat_interleave(cap)
    assert (intmask & on).any() and (intmask & ~on).any()
    assert torch.equal(gout[:, intmask & ~on], prev[:, intmask & ~on])
    if plain:
        _check_rows(k.name, gref, gout, mask & on, scaled)
    assert torch.equal(gout[:, mask & on], out[:, mask & on])


@pytest.mark.parametrize("cap", MOMENTUM_CAPS)
@pytest.mark.parametrize("av_clean", [False, True], ids=["K7", "K7c"])
def test_momentum_forms_match_plain(cuda, cap, av_clean):
    """K7 (K7c) against plain on full, partial and empty cells; K2g/K7
    against its gated plain version (inactive slots equal prev); K11's
    stream form bit-equal to the cell launch on interior slots."""
    grid = CMGrid(n=3, cap=cap)
    cfg = SphConfig(av_clean=av_clean)
    k = pv.pair_momentum_avclean if av_clean else pv.pair_momentum
    J, valid = _momentum_frame(grid, av_clean, seed=cap + av_clean)
    J = torch.from_numpy(J).to(cuda)
    intmask = torch.tensor(np.repeat(_interior_cells_np(grid), cap),
                           device=cuda)
    mask = intmask & torch.from_numpy(valid).to(cuda)
    before = k.launches
    out = k(J, None, grid, cfg)
    assert k.launches == before + 1
    ref = k.plain(J, None, grid, cfg)
    _check_rows(k.name, ref, out, mask)
    assert not out[:, intmask & ~mask].any()
    _check_forms(k, J, grid, cfg, out, intmask, mask, seed=cap,
                 gated=not av_clean)


@pytest.mark.parametrize("cap", MOMENTUM_CAPS)
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_momentum_mm_forms_match_plain(cuda, cap, bf16):
    """K10 (float32: 3xTF32 on the tensor cores; mxu_bf16: bf16) on full,
    partial and empty cells against plain: ax, ay, az, du at 1e-4 of
    their row's scale and maxvsignal at rtol 1e-5 in float32, under
    mxu_bf16 as _check_bf16; zero on invalid interior slots; K11 and
    K2g as in _check_forms. Its inputs are K7's frame (the same J
    rows)."""
    grid = CMGrid(n=3, cap=cap)
    cfg = SphConfig(mxu_moments=True, mxu_momentum=True, mxu_bf16=bf16)
    k = pv.pair_momentum_mm
    J, valid = _momentum_frame(grid, False, seed=cap + 7)
    J = torch.from_numpy(J).to(cuda)
    intmask = torch.tensor(np.repeat(_interior_cells_np(grid), cap),
                           device=cuda)
    mask = intmask & torch.from_numpy(valid).to(cuda)
    before = k.launches
    out = k(J, None, grid, cfg)
    assert k.launches == before + 1
    ref = k.plain(J, None, grid, cfg)
    if bf16:
        _check_bf16(ref, out, k.plain(J, None, grid,
                                      cfg.replace(mxu_bf16=False)), mask)
    else:
        _check_rows(k.name, ref, out, mask)
    assert not out[:, intmask & ~mask].any()
    _check_forms(k, J, grid, cfg, out, intmask, mask, seed=cap,
                 plain=not bf16)


def _xh_iad_frame(grid, stage, seed):
    """J rows of K3 (x y z h gid m; h 0.15-0.6 of a cell, so that some
    slots' h moves in the controller's first round, some in a later one
    and some never) or K5 (x y z h gid kx xm vx vy vz; h 0.35-0.45)."""
    r = np.random.default_rng(seed)
    lo, hi = (0.15, 0.6) if stage == "pair_xh" else (0.35, 0.45)
    rows, valid, u, dx = _base_frame(grid, r, lo, hi)
    ns = grid.n_slots
    if stage == "pair_xh":
        rows += [np.where(valid, u(0.5, 1.5) * dx ** 3, 0.0)]     # m
    else:
        rows += [np.where(valid, u(0.5, 2.0), 1.0),               # kx
                 u(0.5, 1.5) * dx ** 3]                           # xm
        rows += [r.normal(0, 1, ns) for _ in range(3)]            # v
    return np.stack(rows).astype(np.float32), valid


# K3 under three controllers: h_iter 2 (the default), 3, and 3 with h
# capped (h_cap a quarter of a cell: the cap binds on some slots)
XH_CASES = {"it2": dict(), "it3": dict(h_iter=3),
            "it3_hcap": dict(h_iter=3, h_cap=0.25 / 3)}


@pytest.mark.parametrize("cap", MOMENTUM_CAPS)
@pytest.mark.parametrize("case", sorted(XH_CASES))
def test_xh_forms_match_plain(cuda, cap, case):
    """K3 on full, partial and empty cells against plain: nc, h and
    nonconv bit-equal on every interior slot (on invalid slots too: the
    kernel counts their candidates without walking them), xm at rtol
    1e-5; the inputs hold slots whose h moves in round 0 only, in a
    later round, and never. K11 and K2g as in _check_forms."""
    grid = CMGrid(n=3, cap=cap)
    cfg = SphConfig(**XH_CASES[case])
    k = pv.pair_xh
    J, valid = _xh_iad_frame(grid, k.name, seed=cap)
    J = torch.from_numpy(J).to(cuda)
    intmask = torch.tensor(np.repeat(_interior_cells_np(grid), cap),
                           device=cuda)
    mask = intmask & torch.from_numpy(valid).to(cuda)
    before = k.launches
    out = k(J, None, grid, cfg)
    assert k.launches == before + 1
    ref = k.plain(J, None, grid, cfg)
    assert torch.equal(out[1:, intmask], ref[1:, intmask])
    np.testing.assert_allclose(out[0, mask].cpu().numpy(),
                               ref[0, mask].cpu().numpy(), rtol=1e-5)
    assert torch.equal(out[0, intmask & ~mask],
                       torch.ones_like(out[0, intmask & ~mask]))
    hs = [J[3]] + [k.plain(J, None, grid, cfg.replace(h_iter=t))[1]
                   for t in range(1, cfg.h_iter + 1)]
    moved = torch.stack([a != b for a, b in zip(hs, hs[1:])])[:, mask]
    assert (moved[0] & ~moved[1:].any(0)).any()      # round 0 only
    assert moved[1:].any(0).any()                    # a later round
    assert (~moved.any(0)).any()                     # never
    _check_forms(k, J, grid, cfg, out, intmask, mask, seed=cap)


@pytest.mark.parametrize("cap", MOMENTUM_CAPS)
def test_iad_forms_match_plain(cuda, cap):
    """K5 on full, partial and empty cells against plain (the cancelling
    sums at 1e-4 of their row's scale), zero on invalid interior slots;
    K11 and K2g as in _check_forms."""
    grid = CMGrid(n=3, cap=cap)
    cfg = SphConfig()
    k = pv.pair_iad
    J, valid = _xh_iad_frame(grid, k.name, seed=cap + 1)
    J = torch.from_numpy(J).to(cuda)
    intmask = torch.tensor(np.repeat(_interior_cells_np(grid), cap),
                           device=cuda)
    mask = intmask & torch.from_numpy(valid).to(cuda)
    before = k.launches
    out = k(J, None, grid, cfg)
    assert k.launches == before + 1
    ref = k.plain(J, None, grid, cfg)
    _check_rows(k.name, ref, out, mask)
    assert not out[:, intmask & ~mask].any()
    _check_forms(k, J, grid, cfg, out, intmask, mask, seed=cap)


@pytest.mark.parametrize("cap", MOMENTUM_CAPS)
def test_iad_mm_forms_match_plain(cuda, cap):
    """K8 (tile::IadMmStage) on full, partial and empty cells (empty
    second i-tiles at cap 256) against plain, its 14 rows at 1e-4 of
    their scale, zero on invalid interior slots; K11 and K2g as in
    _check_forms. Its inputs are K5's frame (the same J rows)."""
    grid = CMGrid(n=3, cap=cap)
    cfg = SphConfig(mxu_moments=True)
    k = pv.pair_iad_mm
    J, valid = _xh_iad_frame(grid, "pair_iad", seed=cap + 5)
    J = torch.from_numpy(J).to(cuda)
    intmask = torch.tensor(np.repeat(_interior_cells_np(grid), cap),
                           device=cuda)
    mask = intmask & torch.from_numpy(valid).to(cuda)
    before = k.launches
    out = k(J, None, grid, cfg)
    assert k.launches == before + 1
    ref = k.plain(J, None, grid, cfg)
    _check_rows(k.name, ref, out, mask)
    assert not out[:, intmask & ~mask].any()
    _check_forms(k, J, grid, cfg, out, intmask, mask, seed=cap)


def _gradh_frame(grid, seed):
    """J rows of K4 (x y z h gid m xm) on `grid`, seeded: positions and m
    of _xh_iad_frame, h and xm as K3 leaves them there (its plain
    version, on the interior cells); the ghost cells' xm, read only as
    j, is m times the interior's median xm / m."""
    J3, valid = _xh_iad_frame(grid, "pair_xh", seed)
    xh = pv.pair_xh.plain(torch.from_numpy(J3), None, grid,
                          SphConfig()).numpy()
    inside = np.repeat(_interior_cells_np(grid), grid.cap)
    m = J3[5]
    ratio = np.median(xh[0][inside & valid] / m[inside & valid])
    xm = np.where(inside, xh[0], np.where(valid, ratio * m, 1.0))
    J = np.concatenate([J3[:3], np.where(inside, xh[1], J3[3])[None],
                        J3[4:6], xm[None]])
    return J.astype(np.float32), valid


def _av_frame(grid, seed):
    """J rows of K6 (x y z h gid c kx xm divv vx vy vz) and its I2 rows
    (c11..c33, alpha, dt) on `grid`, seeded, h 0.35-0.45 of a cell; dt
    0.02 moves alpha by a few hundredths where alphaloc is below
    alpha_i, so the whole alpha update is held."""
    r = np.random.default_rng(seed)
    rows, valid, u, dx = _base_frame(grid, r, 0.35, 0.45)
    ns = grid.n_slots
    rows += [np.where(valid, u(0.5, 1.5), 1.0),                   # c
             np.where(valid, u(0.5, 2.0), 1.0),                   # kx
             u(0.5, 1.5) * dx ** 3,                               # xm
             r.normal(0, 1, ns)]                                  # divv
    rows += [r.normal(0, 1, ns) for _ in range(3)]                # v
    i2 = [r.normal(0, 1, ns) for _ in range(6)]                   # cij
    i2 += [u(0.05, 1.0), np.full(ns, 0.02)]                       # alpha, dt
    return (np.stack(rows).astype(np.float32),
            np.stack(i2).astype(np.float32), valid)


def k9_noise_floor(J, I2, grid, cfg):
    """chip_smoke.k9_noise_floor: K9's float64 alpha, its relative
    float32 noise floor and the slots at that floor."""
    import chip_smoke
    return chip_smoke.k9_noise_floor(J, I2, grid, cfg)


@pytest.mark.parametrize("cap", MOMENTUM_CAPS)
def test_gradh_forms_match_plain(cuda, cap):
    """K4 on full, partial and empty cells (empty second i-tiles at cap
    256) against plain: kx at rtol 1e-5; gradh = 1 + X at 1e-4 of its
    row's scale, as the cancelling sums: next to the frame's empty cells
    X nears -1 (gradh spans about -0.45 to 1.65), and X is itself a
    difference of pair sums, so an order change alone moves gradh there
    by up to 1.3e-4 of itself, 4e-7 of the row's scale (the kernel's
    order emulated on the CPU by tests/test_torch_tile_schedule.py's
    tile_schedule); on the Sedov frame of test_pair_kernel_matches_plain
    both rows hold rtol 1e-5.
    Invalid interior slots exactly 1.0; K11 and K2g as in
    _check_forms."""
    grid = CMGrid(n=3, cap=cap)
    cfg = SphConfig()
    k = pv.pair_gradh
    J, valid = _gradh_frame(grid, seed=cap + 2)
    J = torch.from_numpy(J).to(cuda)
    intmask = torch.tensor(np.repeat(_interior_cells_np(grid), cap),
                           device=cuda)
    mask = intmask & torch.from_numpy(valid).to(cuda)
    before = k.launches
    out = k(J, None, grid, cfg)
    assert k.launches == before + 1
    ref = k.plain(J, None, grid, cfg)
    _check_rows(k.name, ref, out, mask, scaled=(1,))
    assert (out[:, intmask & ~mask] == 1.0).all()
    assert torch.equal(out[:, intmask & ~mask], ref[:, intmask & ~mask])
    _check_forms(k, J, grid, cfg, out, intmask, mask, seed=cap,
                 scaled=(1,))


@pytest.mark.parametrize("cap", MOMENTUM_CAPS)
def test_av_forms_match_plain(cuda, cap):
    """K6 on full, partial and empty cells (empty second i-tiles at cap
    256) against plain, alpha at rtol 1e-5, zero on invalid interior
    slots; K11 and K2g (with I2) as in _check_forms."""
    grid = CMGrid(n=3, cap=cap)
    cfg = SphConfig()
    k = pv.pair_av
    J, I2, valid = _av_frame(grid, seed=cap + 3)
    J, I2 = torch.from_numpy(J).to(cuda), torch.from_numpy(I2).to(cuda)
    intmask = torch.tensor(np.repeat(_interior_cells_np(grid), cap),
                           device=cuda)
    mask = intmask & torch.from_numpy(valid).to(cuda)
    before = k.launches
    out = k(J, I2, grid, cfg)
    assert k.launches == before + 1
    ref = k.plain(J, I2, grid, cfg)
    _check_rows(k.name, ref, out, mask)
    assert not out[:, intmask & ~mask].any()
    _check_forms(k, J, grid, cfg, out, intmask, mask, seed=cap, I2=I2)


@pytest.mark.parametrize("cap", MOMENTUM_CAPS)
def test_av_mm_forms_match_plain(cuda, cap):
    """K9 (tile::pair_cell<AvMmStage>) on K6's frame: full, partial and
    empty cells (empty second i-tiles at cap 256) against plain, alpha
    at rtol 1e-5. At cap 256 the slots at K9's noise floor
    (k9_noise_floor: 92 of 3036 valid interior slots) are held within 8
    times their noise of the float64 alpha instead: graddivv is a
    difference of centred moment sums, and the kernel's order alone
    (tests/test_torch_tile_schedule.py's tile_schedule on this frame, on
    the CPU) moves alpha from plain by up to 3.2e-5 of itself at 2 of
    those slots, against 2.1e-6 and 5.9e-6 at caps 64 and 128 (ROADMAP
    Queue 3). Zero on invalid interior slots; K11 bit-equal to the cell
    launch, K2g (with I2) as in _check_forms on the other slots."""
    grid = CMGrid(n=3, cap=cap)
    cfg = SphConfig().replace(mxu_moments=True)
    k = pv.pair_av_mm
    J, I2, valid = _av_frame(grid, seed=cap + 3)
    J, I2 = torch.from_numpy(J).to(cuda), torch.from_numpy(I2).to(cuda)
    intmask = torch.tensor(np.repeat(_interior_cells_np(grid), cap),
                           device=cuda)
    mask = intmask & torch.from_numpy(valid).to(cuda)
    held = mask
    before = k.launches
    out = k(J, I2, grid, cfg)
    assert k.launches == before + 1
    if cap > 128:
        ref64, noise, named = k9_noise_floor(J, I2, grid, cfg)
        assert int((mask & named).sum()) == 92
        held = mask & ~named
        err = (out[0, mask & named].double() - ref64[mask & named]).abs()
        assert (err <= 8.0 * noise[mask & named]
                * ref64[mask & named].abs()).all()
    ref = k.plain(J, I2, grid, cfg)
    _check_rows(k.name, ref, out, held)
    assert not out[:, intmask & ~mask].any()
    _check_forms(k, J, grid, cfg, out, intmask, held, seed=cap, I2=I2)


GATE_CASES = ("none", "all", "pattern")


@pytest.mark.parametrize("case", GATE_CASES)
@pytest.mark.parametrize("name", GATED)
def test_gated_launch_cases(recorded, cuda, name, case):
    """K2g as launched: the gate pass (pair_gate), then the stage's
    blocks over its list and the copy, at the gate unit Z of
    resolve_zgroup. No active supercell: the device count is 0, out
    equals prev on interior slots and 0 elsewhere. All valid interior
    slots active: every interior cell listed, out bit-equal to the
    ungated launch on interior slots. chip_smoke.activity_pattern's
    seeded pattern: active supercells bit-equal to the ungated launch,
    inactive ones to prev. In every case the count, the sorted list and
    the supercell flags equal the plain version's (gate_plan), and the
    slots outside the interior cells hold 0."""
    import chip_smoke

    calls, grid, intmask = recorded
    k, J, I2, cfg = calls[name]
    kg = next(g for g in pv.GATED_KERNELS if g.name == name + "_gated")
    J = J.to(cuda)
    I2 = None if I2 is None else I2.to(cuda)
    intmask = intmask.to(cuda)
    Z = pv.resolve_zgroup(grid)
    valid = J[0] < 0.5 * pv.FILL_POS
    if case == "none":
        act = torch.zeros(grid.n_slots, device=cuda)
    elif case == "all":
        act = (valid & intmask).float()
    else:
        act, kinds = chip_smoke.activity_pattern(grid, valid, seed=3)
        assert min(kinds.values()) > 0, kinds
    prev = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (kg.fo, grid.n_slots)).astype(np.float32)).to(cuda)
    cells, _ = pv.gate_plan(act.cpu(), grid, Z)
    ws = pv.pair_gate(act, grid, Z)
    count = int(ws[0])
    assert count == len(cells)
    listed = ws[pv.GATE_HDR:pv.GATE_HDR + count].sort().values.cpu()
    assert torch.equal(listed.long(), cells)
    flags = pv.pair_gate.plain(act.cpu(), grid, Z)[pv.gate_flags(grid):]
    assert torch.equal(ws[pv.gate_flags(grid):].cpu(), flags)
    if case == "none":
        assert count == 0
    elif case == "all":
        assert count == len(pv.interior_cells(grid))
    before = (kg.launches, pv.pair_gate.launches)
    out = kg(J, I2, grid, cfg, (act, prev))
    assert (kg.launches, pv.pair_gate.launches) == (before[0] + 1,
                                                     before[1] + 1)
    ungated = k(J, I2, grid, cfg)
    on = pv.supercell_active(act, grid, Z).repeat_interleave(grid.cap)
    assert torch.equal(out[:, intmask & ~on], prev[:, intmask & ~on])
    assert torch.equal(out[:, intmask & on], ungated[:, intmask & on])
    assert not out[:, ~intmask].any()


def test_sharded_step_matches_cpu(cuda):
    """make_ve_step_pallas_sharded with two shards on the card against
    the same run on the CPU (plain versions), Sedov 12^3, 2 steps."""
    from sphexa_tpu_torch.domain.mesh import SlabMesh
    from sphexa_tpu_torch.domain.slab import SlabConfig
    from sphexa_tpu_torch.propagator.ve_pallas_sharded import (
        make_ve_step_pallas_sharded)
    from sphexa_tpu_torch.propagator.ve_sharded import distribute
    from sphexa_tpu_torch.state import _FIELDS

    diags = {}
    for dev in (cuda, torch.device("cpu")):
        state, box, cfg = init_sedov(12, SphConfig(cell_cap=256, ngpad=256),
                                     dt0=2e-4, device=dev)
        host = {f: getattr(state.p, f).cpu().numpy() for f in _FIELDS[:-1]}
        mesh = SlabMesh(2, devices=[dev])
        sc = SlabConfig(n_slabs=2, cap=2224, halo_cap=64, mig_cap=256)
        states = [state.replace(p=p) for p in distribute(host, box, sc, mesh)]
        step = make_ve_step_pallas_sharded(box, CMGrid(n=4, cap=64, nzi=2),
                                           cfg, sc, mesh)
        for _ in range(2):
            states, d = step(states)
        diags[dev.type] = {k: float(v) for k, v in d._asdict().items()}
    a, b = diags["cpu"], diags["cuda"]
    assert b["lost"] == a["lost"] == 0 and b["overflow"] == 0
    assert b["n_owned"] == a["n_owned"] == 12 ** 3
    assert b["max_nc"] == a["max_nc"]
    np.testing.assert_allclose(b["dt"], a["dt"], rtol=1e-5)
    np.testing.assert_allclose(b["eint"], a["eint"], rtol=1e-6)
    np.testing.assert_allclose(b["ecin"], a["ecin"], rtol=1e-3)


# K11: every column stage against the cell launch on the same inputs, at
# z-segments of 1, 3 (not a divisor of nz) and 4 (one segment a column):
# interior slots bit-equal, others zero
COLUMN_CASES = [(name, zseg) for name in STAGES for zseg in (1, 3, 4)]


@pytest.mark.parametrize("name,zseg", COLUMN_CASES,
                         ids=[f"{n}-S{z}" for n, z in COLUMN_CASES])
def test_column_launch_bit_equal_to_cell(recorded, cuda, name, zseg):
    calls, grid, intmask = recorded
    k, J, I2, cfg = calls[name]
    kc = next(c for c in pv.COLUMN_KERNELS if c.name == k.name + "_column")
    J = J.to(cuda)
    I2 = None if I2 is None else I2.to(cuda)
    cell = k._launch(J, I2, grid, cfg)
    saved = kc.zseg
    kc.zseg = zseg
    try:
        before = kc.launches
        col = kc(J, I2, grid, cfg)
        assert kc.launches == before + 1
    finally:
        kc.zseg = saved
    inside = intmask.to(cuda)
    assert torch.equal(col[:, inside], cell[:, inside])
    assert not col[:, ~inside].any()


def test_column_resident_step_matches_cell(cuda):
    """The resident step with K11 against the cell launch, 2 steps."""
    state, box, cfg = init_sedov(12, SphConfig(), dt0=3e-5, device=cuda)
    grid = CMGrid(n=4, cap=64)
    out = {}
    for mode in ("cell", "column"):
        eng = ResidentVE(box, grid, cfg, device=cuda)
        eng.pve = pv.PairVE(grid, cfg, kernel_mode=mode)
        rst = eng.bind(state)
        for _ in range(2):
            rst, d = eng.step(rst)
        out[mode] = (rst, d)
    (a, da), (b, db) = out["cell"], out["column"]
    assert float(da.dt) == float(db.dt) and float(da.eint) == float(db.eint)
    for f in ("x", "vx", "h", "alpha", "temp"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("nchain", [1, 8, 32])
def test_p1_kernel_matches_plain(cuda, nchain):
    from sphexa_tpu_torch.probes import fma_ceiling as p1
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0.5, 2.0, (64, p1.W)).astype(np.float32)).to(cuda)
    length = p1.STEPS // nchain
    out = p1.fma_chains(x, nchain, length)
    ref = p1.fma_chains.plain(x, nchain, length)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("design", ["loads", "many", "many_tma", "few_tma",
                                    "pipe"])
def test_p2_p4_kernels_match_plain(cuda, design):
    from sphexa_tpu_torch.probes import staging_lab as st
    k, f, ns, nprog = 9, 24, 1 << 16, 64
    src, starts = (t.to(cuda) for t in st.inputs(k, f, ns, nprog))
    probe = st.PROBES[design]
    before = probe.launches
    out = torch.zeros((nprog * 8, 128), dtype=torch.float32, device=cuda)
    for _ in range(4):
        probe(src, starts, out, k)
    assert probe.launches == before + 4
    ref = torch.zeros_like(out)
    for _ in range(4):
        probe.plain(src, starts, ref, k)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("ncell", ["1", "64", "grid+5"])
@pytest.mark.parametrize("vf", [0, 30])
@pytest.mark.parametrize("mode,tol", [("none", 1e-5), ("f32", 5e-3),
                                      ("f32_highest", 1e-5),
                                      ("bf16", 1e-5)])
@pytest.mark.parametrize("design", ["mma_sync", "wgmma", "wgmma_serial"])
def test_p5_kernel_matches_plain(cuda, design, mode, tol, vf, ncell):
    """Each P5 design against its plain version at 1 cell, 64 and the
    persistent grid plus 5 (a cell count that is no multiple of the
    grid: 5 blocks walk one cell more); mode "none" runs mma_sync's loop
    under every design."""
    from sphexa_tpu_torch.probes import mma_micro as p5
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1.0, 1.0, (p5.FJ, p5.RUNW)).astype(np.float32)).to(cuda)
    grid = p5.info(mode, design)["grid"] or 132
    n = {"1": 1, "64": 64, "grid+5": grid + 5}[ncell]
    kd = p5.kernel_design(mode, design)
    before = p5.mma_cells.launches[kd]
    out = p5.mma_cells(x, mode, vf, n, design)
    assert p5.mma_cells.launches[kd] == before + 1
    ref = p5.mma_cells.plain(x, mode, vf, n)
    assert not out[:, p5.K:].any()
    err = float((out - ref).abs().max())
    assert err <= tol * float(ref.abs().max()), (design, mode, vf, n, err)
