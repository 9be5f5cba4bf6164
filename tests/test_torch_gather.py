"""The port's gather path (sfc/morton, neighbors/, ops/pair, sph/hydro_ve,
propagator/ve) against the JAX package on the same seeded inputs.

Frames: Sedov 10^3 perturbed, periodic, with padding rows and rows
marked dead (grid level 1: two cells a side, so the duplicate-cell rule
of periodic grids under 3 cells applies), Sedov 16^3 perturbed (level 2,
four cells a side) and Evrard 10 (open box). Bounds: morton keys, the
cell list and the neighbour list (idx, nc, nc_sph, max_nc,
max_cell_count) bit-equal, h at 1 ulp; each pair stage at rtol 1e-5 of
each output's scale (its largest magnitude over the alive rows), on the
JAX package's inputs, and non-finite on the same rows; the step's dt,
etot, eint and ecin at rtol 1e-5 (its fields at 1e-4 of their scale);
the golden-99 values of tests/test_golden_ve.py through the port's
stages in float64 at that file's tolerances (divv, curlv and the
velocity gradient against its oracle: see test_golden_iad_divv_curlv).
"""

import dataclasses
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.init.evrard import init_evrard as j_init_evrard
from sphexa_tpu.init.sedov import init_sedov as j_init_sedov
from sphexa_tpu.neighbors import CellGrid as JGrid
from sphexa_tpu.neighbors import build_cell_list as j_cell_list
from sphexa_tpu.neighbors import build_neighbor_list as j_nbr_list
from sphexa_tpu.neighbors import choose_level as j_choose_level
from sphexa_tpu.propagator.common import finish_step as j_finish_step
from sphexa_tpu.propagator.ve import make_ve_step as j_make_ve_step
from sphexa_tpu.sfc.morton import morton_decode as j_decode
from sphexa_tpu.sfc.morton import morton_encode as j_encode
from sphexa_tpu.sph import hydro_ve as jh
from sphexa_tpu.sph.eos import eos_ve as j_eos_ve
from sphexa_tpu.state import _FIELDS
from sphexa_tpu_torch.interop import (box_from_numpy, config_from_dict,
                                      state_from_numpy)
from sphexa_tpu_torch.neighbors import (CellGrid, build_cell_list,
                                        build_neighbor_list, choose_level)
from sphexa_tpu_torch.propagator.common import finish_step
from sphexa_tpu_torch.propagator.ve import make_ve_step
from sphexa_tpu_torch.sfc.box import Box
from sphexa_tpu_torch.sfc.morton import morton_decode, morton_encode
from sphexa_tpu_torch.sph import hydro_ve as th
from torch_threads import one_torch_thread  # noqa: F401

FRAMES = ("sedov10", "sedov16", "evrard10")


def t(a):
    """A torch CPU tensor of a JAX or numpy array (same dtype)."""
    return torch.from_numpy(np.array(a))


def tbox(jb) -> Box:
    return box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                           jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])


def tstate(js):
    return state_from_numpy({f: np.asarray(getattr(js.p, f))
                             for f in _FIELDS}, float(js.ttot), float(js.dt),
                            float(js.dt_m1), int(js.iteration), device="cpu")


def close(what, got, want, rtol=1e-5):
    """|got - want| <= rtol * the largest |want| (the output's scale)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rtol, f"{what}: {err:.3e} of scale > {rtol}"


def _perturbed(state, seed, frac=0.2):
    """Seeded position jitter (a fraction of the lattice step), random
    velocities and a few alive rows marked dead."""
    rng = np.random.default_rng(seed)
    p = state.p
    alive = np.asarray(p.alive)
    n = p.x.shape[0]
    dx = float(np.ptp(np.asarray(p.x)[alive])) / round(alive.sum() ** (1 / 3))
    kw = {c: np.where(alive, np.asarray(getattr(p, c))
                      + frac * dx * rng.uniform(-1, 1, n), 0.0)
          .astype(np.float32) for c in "xyz"}
    for c in ("vx", "vy", "vz"):
        kw[c] = (0.05 * rng.standard_normal(n) * alive).astype(np.float32)
    dead = rng.choice(np.flatnonzero(alive), size=7, replace=False)
    alive = alive.copy()
    alive[dead] = False
    return state.replace(p=p.replace(
        **{k: jnp.asarray(v) for k, v in kw.items()},
        alive=jnp.asarray(alive)))


@functools.lru_cache(maxsize=None)
def frame(name):
    """JAX inputs of every stage on one frame: the sorted particles, the
    neighbour list and each stage's outputs."""
    if name.startswith("sedov"):
        side = int(name[5:])
        state, box, cfg = j_init_sedov(side, JCfg(),
                                       capacity=side ** 3 + 24, dt0=1e-4)
        state = _perturbed(state, seed=side)
    else:
        state, box, cfg = j_init_evrard(10, JCfg())
        state = _perturbed(state, seed=3, frac=0.05)
    cfg = cfg.replace(cell_cap=128, ngpad=256)
    p = state.p
    alive = np.asarray(p.alive)
    h_max = float(np.max(np.asarray(p.h)[alive]))
    grid = JGrid(j_choose_level(box, h_max * 1.25))
    cl = j_cell_list(grid, box, p.x, p.y, p.z, alive=p.alive)
    ps = p.permute(cl.perm)
    nl = j_nbr_list(grid, box, cl, ps.x, ps.y, ps.z, ps.h, cfg,
                    adapt_h=True, alive=ps.alive)
    ps = ps.replace(h=nl.h)
    f = dict(state=state, box=box, cfg=cfg, grid=grid, cl=cl, nl=nl, ps=ps)
    x, y, z, h, m = ps.x, ps.y, ps.z, ps.h, ps.m
    idx, nc = nl.idx, nl.nc
    f["xm"] = jh.compute_xmass(box, x, y, z, h, m, idx, nc, cfg)
    f["kx"], f["gradh"] = jh.compute_ve_def_gradh(box, x, y, z, h, m,
                                                  f["xm"], idx, nc, cfg)
    f["rho"], _, f["c"], f["prho"] = j_eos_ve(ps.temp, m, f["kx"], f["xm"],
                                              f["gradh"], cfg.mui, cfg.gamma)
    f["iad"] = jh.compute_iad_divv_curlv(box, x, y, z, ps.vx, ps.vy, ps.vz,
                                         h, f["kx"], f["xm"], idx, nc, cfg)
    f["cij"] = tuple(f["iad"][:6])
    f["alpha"] = jh.compute_av_switches(
        box, x, y, z, ps.vx, ps.vy, ps.vz, h, f["c"], f["kx"], f["xm"],
        f["iad"].divv, f["cij"], ps.alpha, 1e-4, idx, nc, cfg)
    return f


def test_morton_roundtrip():
    rng = np.random.default_rng(0)
    ix, iy, iz = (rng.integers(0, 1024, 4096, dtype=np.int32)
                  for _ in range(3))
    keys = j_encode(jnp.asarray(ix), jnp.asarray(iy), jnp.asarray(iz))
    got = morton_encode(t(ix), t(iy), t(iz))
    np.testing.assert_array_equal(got.numpy(), np.asarray(keys, np.int64))
    for a, b in zip(morton_decode(got), j_decode(keys)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b, np.int64))


@pytest.mark.parametrize("name", FRAMES)
def test_cell_list_bit_equal(name):
    f = frame(name)
    p, box = f["state"].p, f["box"]
    assert choose_level(tbox(box), float(np.max(
        np.asarray(p.h)[np.asarray(p.alive)])) * 1.25) == f["grid"].level
    cl = build_cell_list(CellGrid(f["grid"].level), tbox(box), t(p.x),
                         t(p.y), t(p.z), alive=t(p.alive))
    want = f["cl"]
    for got, ref in ((cl.perm, want.perm), (cl.cid, want.cid),
                     (cl.cell_start, want.cell_start),
                     *zip(cl.coords, want.coords)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref, np.int64))


@pytest.mark.parametrize("name", FRAMES)
def test_neighbor_list(name):
    f = frame(name)
    ps, want = f["ps"], f["nl"]
    grid = CellGrid(f["grid"].level)
    cl = build_cell_list(grid, tbox(f["box"]), *(t(getattr(f["state"].p, c))
                                                 for c in "xyz"),
                         alive=t(f["state"].p.alive))
    perm = cl.perm
    x, y, z, h = (t(getattr(f["state"].p, c))[perm] for c in "xyzh")
    nl = build_neighbor_list(grid, tbox(f["box"]), cl, x, y, z, h,
                             config_from_dict(dataclasses.asdict(f["cfg"])),
                             adapt_h=True, alive=t(f["state"].p.alive)[perm])
    np.testing.assert_array_equal(nl.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(nl.nc.numpy(), np.asarray(want.nc))
    np.testing.assert_array_equal(nl.nc_sph.numpy(), np.asarray(want.nc_sph))
    assert int(nl.max_nc) == int(want.max_nc)
    assert int(nl.max_cell_count) == int(want.max_cell_count)
    np.testing.assert_array_max_ulp(nl.h.numpy(), np.asarray(want.h), 1)
    assert int(nl.max_cell_count) <= f["cfg"].cell_cap


STAGES = ("xmass", "gradh", "iad", "av", "momentum", "momentum_uniform",
          "momentum_avclean")


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("name", FRAMES)
def test_stage(name, stage):
    """One stage of both packages on the JAX package's inputs."""
    f = frame(name)
    box, cfg, ps, nl = f["box"], f["cfg"], f["ps"], f["nl"]
    uniform = stage == "momentum_uniform"
    cfg = cfg.replace(uniform_mass=uniform,
                      av_clean=stage == "momentum_avclean")
    tb, tcfg = tbox(box), config_from_dict(dataclasses.asdict(cfg))
    x, y, z, h, m = (t(getattr(ps, c)) for c in ("x", "y", "z", "h", "m"))
    vx, vy, vz = (t(getattr(ps, c)) for c in ("vx", "vy", "vz"))
    idx, nc = t(nl.idx), t(nl.nc)
    xm, kx = t(f["xm"]), t(f["kx"])
    cij = tuple(t(c) for c in f["cij"])
    if stage == "xmass":
        outs = {"xm": (th.compute_xmass(tb, x, y, z, h, m, idx, nc, tcfg),
                       f["xm"])}
    elif stage == "gradh":
        kx_t, gradh_t = th.compute_ve_def_gradh(tb, x, y, z, h, m, xm, idx,
                                                nc, tcfg)
        outs = {"kx": (kx_t, f["kx"]), "gradh": (gradh_t, f["gradh"])}
    elif stage == "iad":
        got = th.compute_iad_divv_curlv(tb, x, y, z, vx, vy, vz, h, kx, xm,
                                        idx, nc, tcfg)
        outs = {k: (getattr(got, k), getattr(f["iad"], k))
                for k in got._fields}
    elif stage == "av":
        got = th.compute_av_switches(tb, x, y, z, vx, vy, vz, h, t(f["c"]),
                                     kx, xm, t(f["iad"].divv), cij,
                                     t(ps.alpha), 1e-4, idx, nc, tcfg)
        outs = {"alpha": (got, f["alpha"])}
    else:
        if stage == "momentum_uniform":
            # equal masses: the clamp-form ramp is exact there
            assert np.ptp(np.asarray(ps.m)[np.asarray(ps.alive)]) == 0.0
        gradv = tuple(f["iad"][8:]) if cfg.av_clean else None
        want = jh.compute_momentum_energy(
            box, ps.x, ps.y, ps.z, ps.vx, ps.vy, ps.vz, ps.h, ps.m,
            f["prho"], f["c"], f["cij"], f["kx"], f["xm"], f["alpha"],
            nl.idx, nl.nc, cfg, gradv=gradv)
        got = th.compute_momentum_energy(
            tb, x, y, z, vx, vy, vz, h, m, t(f["prho"]), t(f["c"]), cij, kx,
            xm, t(f["alpha"]), idx, nc, tcfg,
            gradv=None if gradv is None else tuple(t(g) for g in gradv))
        outs = {k: (getattr(got, k), getattr(want, k)) for k in got._fields}
    alive = np.asarray(ps.alive)
    for k, (got, want) in outs.items():
        assert got.dtype == torch.float32, k
        got, want = got.numpy(), np.asarray(want)
        # padding rows (m = 0) give NaN volume elements in both packages
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        close(f"{name} {stage} {k}", got[alive], want[alive])


@pytest.mark.parametrize("rows", [1, 97])
def test_pair_stage_chunking(rows, monkeypatch):
    """run_pair_stage's chunks of CHUNK_ELEMS // K rows (here 1 and 97,
    the last chunk short) give each row the sums of one whole chunk,
    bit for bit."""
    from sphexa_tpu_torch.ops import pair
    f = frame("sedov10")
    ps, nl = f["ps"], f["nl"]
    tb, tcfg = tbox(f["box"]), config_from_dict(dataclasses.asdict(f["cfg"]))
    x, y, z, h, m = (t(getattr(ps, c)) for c in ("x", "y", "z", "h", "m"))
    idx, nc = t(nl.idx), t(nl.nc)
    assert x.shape[0] % rows != 0 or rows == 1
    whole = th.compute_ve_def_gradh(tb, x, y, z, h, m, t(f["xm"]), idx, nc,
                                    tcfg)
    monkeypatch.setattr(pair, "CHUNK_ELEMS", rows * idx.shape[1])
    chunked = th.compute_ve_def_gradh(tb, x, y, z, h, m, t(f["xm"]), idx,
                                      nc, tcfg)
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(b, a, rtol=0, atol=0, equal_nan=True)


def test_finish_step_without_divv():
    """divv None (the std pipeline) leaves out the rho limit, as the
    JAX finish_step does: dt is the Courant limit alone."""
    f = frame("sedov16")
    js, box, cfg = f["state"], f["box"], f["cfg"]
    p = js.p
    n = p.x.shape[0]
    rng = np.random.default_rng(1)
    ax, ay, az, du = (jnp.asarray(rng.standard_normal(n), jnp.float32)
                      for _ in range(4))
    mvs = jnp.asarray(rng.uniform(1.0, 2.0, n), jnp.float32)
    c = jnp.ones(n, jnp.float32)
    nc_sph = jnp.full(n, 100, jnp.int32)
    kw = dict(max_nc=jnp.int32(99), max_cell_count=jnp.int32(0))
    want, wd = j_finish_step(js, p, ax, ay, az, du, mvs, c, None, nc_sph,
                             box, cfg, **kw)
    got, gd = finish_step(tstate(js), tstate(js).p, t(ax), t(ay), t(az),
                          t(du), t(mvs), t(c), None, t(nc_sph), tbox(box),
                          config_from_dict(dataclasses.asdict(cfg)),
                          **{k: t(v) for k, v in kw.items()})
    assert float(gd.dt) == float(wd.dt)
    with_divv = finish_step(tstate(js), tstate(js).p, t(ax), t(ay), t(az),
                            t(du), t(mvs), t(c), torch.full((n,), 1e3),
                            t(nc_sph), tbox(box),
                            config_from_dict(dataclasses.asdict(cfg)),
                            **{k: t(v) for k, v in kw.items()})[1]
    assert float(with_divv.dt) < float(gd.dt)
    np.testing.assert_array_equal(got.p.x.numpy(), np.asarray(want.p.x))


@pytest.mark.parametrize("case,steps", [("sedov", 3), ("evrard", 1)])
def test_ve_step(case, steps):
    """make_ve_step against the JAX make_ve_step: Sedov 10^3 (cell_cap
    128 holds its 125-row cells) and Evrard 10 with the direct sum."""
    if case == "sedov":
        js, box, cfg = j_init_sedov(10, JCfg(), dt0=1e-4)
        cfg = cfg.replace(cell_cap=128)
    else:
        js, box, cfg = j_init_evrard(10, JCfg())
    alive = np.asarray(js.p.alive)
    level = j_choose_level(box, float(np.max(np.asarray(js.p.h)[alive]))
                           * 1.25)
    jstep = j_make_ve_step(box, JGrid(level), cfg)
    tstep = make_ve_step(tbox(box), CellGrid(level),
                         config_from_dict(dataclasses.asdict(cfg)),
                         device="cpu")
    ts = tstate(js)
    for i in range(steps):
        js, jd = jstep(js)
        ts, td = tstep(ts)
        assert int(td.max_nc) == int(jd.max_nc), i
        assert int(td.max_cell_count) == int(jd.max_cell_count), i
        for k in ("dt", "etot", "eint", "ecin", "egrav"):
            np.testing.assert_allclose(float(getattr(td, k)),
                                       float(getattr(jd, k)), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
    for c in ("x", "y", "z", "vx", "temp", "h", "alpha"):
        close(f"{case} {c}", getattr(ts.p, c).numpy(), getattr(js.p, c),
              rtol=1e-4)


# ---- golden-99 (tests/test_golden_ve.py:60-131) through the port ----

MPART = 3.781038064465603e26
GOLDEN_COLS = ("x", "y", "z", "vx", "vy", "vz", "h", "c",
               "c11", "c12", "c13", "c22", "c23", "c33",
               "p", "gradh", "rho0", "sumwhrho0", "sumwh",
               "dvxdx", "dvxdy", "dvxdz", "dvydx", "dvydy", "dvydz",
               "dvzdx", "dvzdy", "dvzdz", "alpha", "u", "divv")


@pytest.fixture(scope="module")
def golden():
    """The reference's 99-particle fixture in float64: particle 0 is the
    target, every other particle its neighbour (no other cut)."""
    from sphexa_tpu_torch.sph.kernels import kernel_3d_k
    raw = np.loadtxt(os.path.join(os.path.dirname(__file__), "data",
                                  "ve_golden_99.txt"))
    d = {k: torch.from_numpy(raw[:, i].copy())
         for i, k in enumerate(GOLDEN_COLS)}
    d["m"] = torch.full((99,), MPART, dtype=torch.float64)
    K = kernel_3d_k(6.0)
    d["xm"] = d["m"] / d["rho0"]
    d["kx"] = K * d["xm"] / d["h"] ** 3
    d["prho"] = d["p"] / (d["kx"] * d["m"] ** 2 * d["gradh"])
    d["cij"] = tuple(d[k] for k in ("c11", "c12", "c13", "c22", "c23",
                                    "c33"))
    d["idx"] = torch.tensor([[j for j in range(99) if j != i]
                             for i in range(99)])
    d["nc"] = torch.full((99,), 98)
    d["box"] = Box.cube(-1e9, 1e9)
    d["cfg"] = config_from_dict(dict(sinc_index=6.0))
    d["pos"] = (d["x"], d["y"], d["z"])
    d["vel"] = (d["vx"], d["vy"], d["vz"])
    return d


def test_golden_xmass_gradh(golden):
    g = golden
    xm = th.compute_xmass(g["box"], *g["pos"], g["h"], g["m"], g["idx"],
                          g["nc"], g["cfg"])
    np.testing.assert_allclose(MPART / float(xm[0]), 34.515038498081417,
                               rtol=2e-5)
    kx, gradh = th.compute_ve_def_gradh(g["box"], *g["pos"], g["h"], g["m"],
                                        g["xm"], g["idx"], g["nc"], g["cfg"])
    np.testing.assert_allclose(float(kx[0]), 1.0042661134076782, rtol=2e-5)
    np.testing.assert_allclose(float(gradh[0]), 0.98699067585409861,
                               rtol=2e-5)
    np.testing.assert_allclose(float(kx[0]) * MPART / float(g["xm"][0]),
                               3.4662283566584293e1, rtol=2e-5)


def test_golden_iad_divv_curlv(golden):
    """cij at the golden values. The fused stage computes divv, curlv
    and the velocity gradient from its own cij, while
    test_golden_ve.py's values for them take the fixture's c11-c33
    columns, which are not the IAD matrix (about 30 times it): so they
    are held against the float64 oracle fed with the stage's cij."""
    import oracle
    from sphexa_tpu.sfc.box import Box as JBox
    from sphexa_tpu_torch.sph.kernels import kernel_3d_k

    g = golden
    r = th.compute_iad_divv_curlv(g["box"], *g["pos"], *g["vel"], g["h"],
                                  g["kx"], g["xm"], g["idx"], g["nc"],
                                  g["cfg"])
    for got, want in zip(r[:6], (1.9296619855715329e-18,
                                 -1.7838691836843698e-20,
                                 -1.2892885646884301e-20,
                                 1.9482845913025683e-18,
                                 1.635410357476855e-20,
                                 1.9246939006338132e-18)):
        np.testing.assert_allclose(float(got[0]), want, rtol=2e-5)
    n = [g[k].numpy() for k in ("x", "y", "z", "vx", "vy", "vz", "h")]
    divv, curlv, gradv = oracle.divv_curlv(
        *n, kernel_3d_k(6.0), JBox.cube(-1e9, 1e9), g["kx"].numpy(),
        g["xm"].numpy(), tuple(c.numpy() for c in r[:6]),
        within=~np.eye(99, dtype=bool))
    for got, want, rtol in ((r.divv, divv, 1e-5), (r.curlv, curlv, 1e-5),
                            *zip(r[8:], gradv, (2e-5,) * 6)):
        np.testing.assert_allclose(float(got[0]), want[0], rtol=rtol)


def test_golden_av_switches(golden):
    g = golden
    alpha = th.compute_av_switches(g["box"], *g["pos"], *g["vel"], g["h"],
                                   g["c"], g["kx"], g["xm"], g["divv"],
                                   g["cij"], g["alpha"], 0.3, g["idx"],
                                   g["nc"], g["cfg"])
    np.testing.assert_allclose(float(alpha[0]), 0.93941905320351171,
                               rtol=1e-6)


@pytest.mark.parametrize("avclean,want", [
    (False, (-521261.07791667967, -74471.016515749841, -1730426.827721074,
             7.1838438980436924e12, 26490876.319252387)),
    (True, (-505548.68073726865, 303384.91384746187, -1767463.9739728321,
            None, None))])
def test_golden_momentum_energy(golden, avclean, want):
    g = golden
    gradv = None
    if avclean:
        gradv = (g["dvxdx"], g["dvxdy"] + g["dvydx"],
                 g["dvxdz"] + g["dvzdx"], g["dvydy"],
                 g["dvydz"] + g["dvzdy"], g["dvzdz"])
    me = th.compute_momentum_energy(g["box"], *g["pos"], *g["vel"], g["h"],
                                    g["m"], g["prho"], g["c"], g["cij"],
                                    g["kx"], g["xm"], g["alpha"], g["idx"],
                                    g["nc"], g["cfg"], gradv=gradv)
    rtols = (2e-5, 2e-4, 2e-5, 2e-5, 1e-7)
    for got, w, rtol in zip(me, want, rtols):
        if w is not None:
            np.testing.assert_allclose(float(got[0]), w, rtol=rtol)
