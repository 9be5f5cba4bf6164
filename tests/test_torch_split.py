"""The port's upsampled restart, h equilibration, viz hook, stage timer
and --profile against the JAX package (or on their own where the JAX
package has no counterpart to run here).

- io/hdf5.load_split_checkpoint bit-equal to the JAX loader at S = 2, 3
  and 8 on a Sedov 6^3 dump written by the JAX package (every field,
  dt, dt_m1, ttot, iteration, box and config), and split_state on the
  loaded state equal to it;
- init/relax_h.equilibrate_h bit-equal on Evrard 10 and 20 with h
  scaled by a seeded factor in [0.4, 1.6] (the initial h already sits
  in the controller's window), on a periodic Sedov frame, and the same
  ValueError when it cannot converge;
- io/viz.VizHook: the same PNG paths as the JAX hook (render
  iterations only, extra fields), and None without matplotlib;
- util/timer.StageTimer on a patched clock: the same stages, totals and
  report as the JAX timer;
- `main --profile` on the CPU: ./sphexa-trace/trace.json written, the
  table of top-level ops printed with its calls.
"""

import dataclasses
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.init.evrard import init_evrard as j_init_evrard
from sphexa_tpu.init.relax_h import equilibrate_h as j_equilibrate
from sphexa_tpu.init.sedov import init_sedov as j_init_sedov
from sphexa_tpu.io import hdf5 as j_hdf5
from sphexa_tpu.io.viz import VizHook as JViz
from sphexa_tpu.state import _FIELDS
from sphexa_tpu.util import timer as j_timer
from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.init.relax_h import equilibrate_h
from sphexa_tpu_torch.interop import box_from_numpy, state_from_numpy
from sphexa_tpu_torch.io import hdf5 as t_hdf5
from sphexa_tpu_torch.io.viz import VizHook
from sphexa_tpu_torch.main import main
from sphexa_tpu_torch.util import timer as t_timer
from torch_threads import one_torch_thread  # noqa: F401


def tbox(jb):
    return box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                           jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    """A Sedov 6^3 checkpoint with seeded velocities, written by the JAX
    package."""
    js, jb, jc = j_init_sedov(6, JCfg(), dt0=3e-4)
    rng = np.random.default_rng(12)
    n = js.p.x.shape[0]
    js = js.replace(p=js.p.replace(**{
        c: jnp.asarray((0.2 * rng.standard_normal(n)).astype(np.float32))
        for c in ("vx", "vy", "vz")}), ttot=np.float32(2.5e-3))
    path = str(tmp_path_factory.mktemp("split") / "ck.h5")
    j_hdf5.save_checkpoint(path, js, jc, jb)
    return path, js


@pytest.mark.parametrize("S", [2, 3, 8])
def test_load_split_checkpoint_bit_equal(dump, S):
    path, js = dump
    jst, jb, jc = j_hdf5.load_split_checkpoint(path, JCfg(), S)
    tst, tb, tc = t_hdf5.load_split_checkpoint(path, SphConfig(), S,
                                               device="cpu")
    n = int(np.asarray(js.p.alive).sum())
    assert tst.p.n == jst.p.x.shape[0] == S * n
    for f in _FIELDS:
        np.testing.assert_array_equal(getattr(tst.p, f).numpy(),
                                      np.asarray(getattr(jst.p, f)), f)
    for f in ("ttot", "dt", "dt_m1", "iteration"):
        assert getattr(tst, f).dtype == (torch.int32 if f == "iteration"
                                         else torch.float32), f
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)), f)
    assert tb == tbox(jb)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    # the host split of the loaded state, without the HDF5 read
    st, box, _ = t_hdf5.load_checkpoint(path, SphConfig(), device="cpu")
    again = t_hdf5.split_state(st, box, S)
    for f in _FIELDS:
        assert torch.equal(getattr(again.p, f), getattr(tst.p, f)), f


def test_split_one_keeps_the_particles(dump):
    """S = 1: the rows in Hilbert order, m and h as they were, the
    Press-2 history reset (as the JAX loader does at S = 1)."""
    path, _ = dump
    jst, _, _ = j_hdf5.load_split_checkpoint(path, JCfg(), 1)
    tst, _, _ = t_hdf5.load_split_checkpoint(path, SphConfig(), 1,
                                             device="cpu")
    for f in _FIELDS:
        np.testing.assert_array_equal(getattr(tst.p, f).numpy(),
                                      np.asarray(getattr(jst.p, f)), f)


def evrard_frame(side):
    js, jb, jc = j_init_evrard(side, JCfg())
    p = js.p
    x, y, z, h = (np.asarray(getattr(p, c)) for c in "xyzh")
    h = h * np.random.default_rng(side).uniform(0.4, 1.6, h.shape)
    return jb, (x, y, z, h.astype(np.float32)), np.asarray(p.alive), jc


@pytest.mark.parametrize("side", [10, 20])
def test_equilibrate_h_bit_equal(side):
    jb, (x, y, z, h), alive, jc = evrard_frame(side)
    want = j_equilibrate(jb, x, y, z, h, alive=alive, ng0=jc.ng0,
                         ngmax=jc.ngmax)
    got = equilibrate_h(tbox(jb), *(torch.from_numpy(np.array(a)) for a in
                                    (x, y, z, h)),
                        alive=torch.from_numpy(np.array(alive)), ng0=jc.ng0,
                        ngmax=jc.ngmax)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, h.astype(np.float64))


def test_equilibrate_h_periodic_and_dead_rows():
    """A periodic Sedov frame with every tenth row dead: the wrap
    (cKDTree boxsize) and the dead rows' h kept, bit-equal."""
    js, jb, jc = j_init_sedov(8, JCfg())
    p = js.p
    x, y, z = (np.asarray(getattr(p, c)) for c in "xyz")
    h = np.asarray(p.h) * np.float32(0.6)
    alive = np.asarray(p.alive).copy()
    alive[::10] = False
    want = j_equilibrate(jb, x, y, z, h, alive=alive)
    got = equilibrate_h(tbox(jb), x, y, z, h, alive=alive)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[~alive], h[~alive])


def test_equilibrate_h_raises_alike():
    jb, (x, y, z, h), alive, _ = evrard_frame(10)
    msgs = []
    for fn, box in ((j_equilibrate, jb), (equilibrate_h, tbox(jb))):
        with pytest.raises(ValueError, match="did not converge in 1 sweeps") \
                as e:
            fn(box, x, y, z, h, alive=alive, max_sweeps=1)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def sedov_pair(side=6):
    js, jb, jc = j_init_sedov(side, JCfg(), dt0=1e-4)
    ts = state_from_numpy({f: np.asarray(getattr(js.p, f)) for f in _FIELDS},
                          float(js.ttot), float(js.dt), float(js.dt_m1),
                          int(js.iteration), device="cpu")
    return js, jb, ts, tbox(jb)


def test_viz_hook(tmp_path):
    js, jb, ts, tb = sedov_pair()
    rho = np.linspace(1.0, 2.0, ts.p.n).astype(np.float32)
    jh = JViz(out_prefix=str(tmp_path / "j"), every=2)
    th = VizHook(out_prefix=str(tmp_path / "t"), every=2)
    assert jh.execute(js, jb, 3) is None and th.execute(ts, tb, 3) is None
    for it, extra in ((4, None), (6, {"rho": rho})):
        jp = jh.execute(js, jb, it, extra_fields=extra)
        textra = None if extra is None else {"rho": torch.from_numpy(rho)}
        tp = th.execute(ts, tb, it, extra_fields=textra)
        assert tp == str(tmp_path / f"t_{it:06d}.png")
        assert jp == str(tmp_path / f"j_{it:06d}.png")
        with open(tp, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    th_rho = VizHook(out_prefix=str(tmp_path / "r"), every=1, field="rho")
    assert th_rho.execute(ts, tb, 1, extra_fields={
        "rho": torch.from_numpy(rho)}).endswith("r_000001.png")


def test_viz_hook_without_matplotlib(tmp_path, monkeypatch):
    js, jb, ts, tb = sedov_pair()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert JViz(out_prefix=str(tmp_path / "j"), every=1) \
        .execute(js, jb, 1) is None
    assert VizHook(out_prefix=str(tmp_path / "t"), every=1) \
        .execute(ts, tb, 1) is None
    assert not list(tmp_path.iterdir())


def test_stage_timer_on_a_patched_clock(monkeypatch):
    ticks = [10.0, 10.25, 10.75, 11.0, 20.0, 20.5, 21.5]
    timers = []
    for mod in (j_timer, t_timer):
        clock = iter(ticks)
        monkeypatch.setattr(mod.time, "perf_counter", lambda c=clock: next(c))
        tm = mod.StageTimer()
        tm.start()
        tm.step("density")
        tm.step("iad")
        tm.step("density")
        first = (dict(tm.current), tm.iteration_report())
        tm.start()
        tm.step("iad")
        tm.step("momentum")
        timers.append((first, dict(tm.current), tm.iteration_report(),
                       tm.summary()))
        off = mod.StageTimer(enabled=False)
        off.start()
        off.step("density")
        assert off.summary() == {} and off.iteration_report() == ""
    assert timers[0] == timers[1]
    first, current, report, summary = timers[1]
    assert first[0] == {"density": 0.5, "iad": 0.5}
    assert report == "iad: 500.0ms momentum: 1000.0ms"
    assert summary == {"density": 0.5, "iad": 1.0, "momentum": 1.0}


def test_profile_writes_trace_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SPHEXA_PLATFORM", "cpu")
    main(["--init", "sedov", "-n", "6", "--dt0", "1e-4", "-s", "2",
          "--profile", "--constants", ""])
    out = capsys.readouterr().out.splitlines()
    trace = tmp_path / "sphexa-trace" / "trace.json"
    with open(trace) as f:
        assert json.load(f)["traceEvents"]
    assert "# profile trace written to ./sphexa-trace" in out
    head = out.index("# profile trace written to ./sphexa-trace") + 1
    assert out[head].split()[1:] == ["cpu", "op", "ms/step", "calls"]
    rows = {ln[2:58].strip(): ln[58:].split() for ln in out[head + 1:]
            if ln.startswith("# aten::")}
    assert "aten::index" in rows and int(rows["aten::index"][1]) > 0
    total = [ln for ln in out if ln.startswith("# TOTAL cpu (top-level ops)")]
    assert len(total) == 1 and float(total[0].split()[-1]) > 0
