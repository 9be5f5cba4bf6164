"""The port's command line (sphexa_tpu_torch/main.py) and its I/O
(io/ascii.py, io/hdf5.py) on the CPU (SPHEXA_PLATFORM=cpu).

- `main` against the JAX CLI at Sedov 6^3, --prop ve, 3 steps (the size
  of the JAX package's fast CLI tests, tests/test_io_cli.py:147): the
  constants files' columns at rtol 1e-5 (the momenta, which are round-off
  around 0, at 1e-5 of their scale sqrt(2 M ecin), times the box's half
  diagonal for the angular one), and the `### Check` fields at rtol 1e-5;
- --prop ve-pallas and ve-bdt bit-equal to make_ve_step_cellmajor and
  BdtVE driven by hand;
- HDF5 dumps written by either package read by the other (fields and
  attributes equal); an HDF5 restart equal to a continued run; ASCII
  dumps byte-equal to the JAX writer's and read by both readers;
- output on steps, times and --wextra, --duration, --debug-nans, the
  tiered props run, std-cooling, evrard-cooling, --profile, --viz-every
  and --split 2 run, and the six multi-device props run on 2 shards.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.init.sedov import init_sedov as j_init_sedov
from sphexa_tpu.io import ascii as j_ascii
from sphexa_tpu.io import hdf5 as j_hdf5
from sphexa_tpu.state import _FIELDS
from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.init.factory import make_initializer
from sphexa_tpu_torch.interop import (box_from_numpy, config_from_dict,
                                      state_from_numpy)
from sphexa_tpu_torch.io import ascii as t_ascii
from sphexa_tpu_torch.io import hdf5 as t_hdf5
from sphexa_tpu_torch.main import main
from sphexa_tpu_torch.ops.cellmajor import choose_cap_and_grid
from sphexa_tpu_torch.propagator.ve_bdt import BdtVE
from sphexa_tpu_torch.propagator.ve_cellmajor import make_ve_step_cellmajor
from torch_threads import one_torch_thread  # noqa: F401

SEDOV6 = ["--init", "sedov", "-n", "6", "--dt0", "1e-4"]


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("SPHEXA_PLATFORM", "cpu")


def run(*argv):
    return main(list(SEDOV6) + [str(a) for a in argv])


def assert_states_equal(a, b):
    for f in _FIELDS:
        assert torch.equal(getattr(a.p, f), getattr(b.p, f)), f
    for f in ("ttot", "dt", "dt_m1", "iteration"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def check_fields(out: str) -> list:
    """The numbers of each `### Check` line but its wall time."""
    rows = []
    for ln in out.splitlines():
        if ln.startswith("### Check ###"):
            rows.append([float(v) for k, v in
                         re.findall(r"(\w+)[=~]([-+0-9.e]+)", ln)
                         if k != "wall"])
    return rows


def test_constants_match_jax_cli(tmp_path, capsys, monkeypatch):
    from sphexa_tpu.main import main as j_main
    jc, tc = tmp_path / "j.txt", tmp_path / "t.txt"
    j_main(list(SEDOV6) + ["-s", "3", "--constants", str(jc)])
    j_check = check_fields(capsys.readouterr().out)
    monkeypatch.setenv("SPHEXA_PLATFORM", "cpu")
    run("-s", "3", "--constants", tc)
    t_check = check_fields(capsys.readouterr().out)

    assert jc.read_text().splitlines()[0] == tc.read_text().splitlines()[0]
    a, b = np.loadtxt(jc), np.loadtxt(tc)
    assert a.shape == b.shape == (3, 9)
    np.testing.assert_array_equal(b[:, 0], a[:, 0])
    np.testing.assert_allclose(b[:, 1:7], a[:, 1:7], rtol=1e-5)
    p_scale = np.sqrt(2.0 * 1.0 * a[:, 4])     # total mass 1
    for col, scale in ((7, p_scale), (8, p_scale * np.sqrt(3.0) / 2)):
        assert np.all(np.abs(b[:, col] - a[:, col]) <= 1e-5 * scale), col
    assert len(j_check) == len(t_check) == 3
    np.testing.assert_allclose(np.array(t_check), np.array(j_check),
                               rtol=1e-5)


@pytest.mark.parametrize("prop", ["ve-pallas", "ve-bdt"])
def test_slot_frame_props_match_engines(cpu, prop):
    """The CLI's slot-frame props run the engines: the same state as the
    engine driven by hand on the planner's grid (2 steps; 1 BdtVE cycle
    of 8 substeps)."""
    got = run("-s", 1 if prop == "ve-bdt" else 2, "--prop", prop,
              "--quiet", "--constants", "")
    state, box, cfg = make_initializer("sedov")(6, SphConfig(), dt0=1e-4,
                                                device="cpu")
    alive = state.p.alive.numpy()
    h_max = float(state.p.h[state.p.alive].max())
    _, grid = choose_cap_and_grid(box, h_max * 1.25, int(alive.sum()),
                                  *(getattr(state.p, c).numpy()[alive]
                                    for c in "xyz"), headroom=8)
    if prop == "ve-pallas":
        step = make_ve_step_cellmajor(box, grid, cfg, device="cpu")
        for _ in range(2):
            state, _ = step(state)
    else:
        eng = BdtVE(box, grid, cfg, device="cpu")
        bst, _ = eng.run_cycle(eng.bind_bdt(state))
        state = eng.unbind(bst.rv, state.p.n)
    assert_states_equal(got, state)


def test_bdt_rung_checkpoint_and_restart(cpu, tmp_path):
    """--prop ve-bdt writes the rung state of its cycle (equal to
    BdtVE.checkpoint_rungs driven by hand), and a restart resumes it."""
    dump = str(tmp_path / "b.h5")
    run("-s", 1, "--prop", "ve-bdt", "-w", 1, "-o", dump, "--quiet",
        "--constants", "")
    state, box, cfg = make_initializer("sedov")(6, SphConfig(), dt0=1e-4,
                                                device="cpu")
    alive = state.p.alive.numpy()
    h_max = float(state.p.h[state.p.alive].max())
    _, grid = choose_cap_and_grid(box, h_max * 1.25, int(alive.sum()),
                                  *(getattr(state.p, c).numpy()[alive]
                                    for c in "xyz"), headroom=8)
    eng = BdtVE(box, grid, cfg, device="cpu")
    bst, _ = eng.run_cycle(eng.bind_bdt(state))
    want = eng.checkpoint_rungs(bst, state.p.n)
    got = t_hdf5.load_bdt_state(dump)
    assert got["num_rungs"] == 4
    assert got["dt_min"] == want["attrs"]["bdt_dt_min"]
    fields, _ = t_hdf5.HDF5Reader(dump).read_step(-1)
    np.testing.assert_array_equal(fields["bdt_rung"],
                                  want["fields"]["bdt_rung"].numpy()[alive])
    np.testing.assert_array_equal(got["dt_m1k"],
                                  want["fields"]["bdt_dt_m1k"].numpy()[alive])
    st = main(["--init", dump, "--prop", "ve-bdt", "-s", "1", "--quiet",
               "--constants", ""])
    assert int(st.iteration) == 17
    assert all(bool(torch.isfinite(getattr(st.p, f)).all())
               for f in _FIELDS[:-1])


def _jax_state():
    js, jb, jc = j_init_sedov(6, JCfg(), dt0=1e-4)
    rng = np.random.default_rng(5)
    n = js.p.x.shape[0]
    js = js.replace(p=js.p.replace(
        vx=np.float32(0.1) * rng.standard_normal(n).astype(np.float32)),
        iteration=np.int32(7), ttot=np.float32(3.25e-3))
    ts = state_from_numpy({f: np.asarray(getattr(js.p, f)) for f in _FIELDS},
                          float(js.ttot), float(js.dt), float(js.dt_m1),
                          int(js.iteration), device="cpu")
    tb = box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                         jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])
    return js, jb, jc, ts, tb, config_from_dict(dataclasses.asdict(jc))


def test_hdf5_cross_read(tmp_path):
    js, jb, jc, ts, tb, tc = _jax_state()
    rho = np.linspace(1.0, 2.0, js.p.x.shape[0]).astype(np.float32)
    jp, tp = str(tmp_path / "j.h5"), str(tmp_path / "t.h5")
    w = j_hdf5.HDF5Writer(jp)
    w.write_step(js, jc, jb, fields={"rho": rho})
    w.close()
    w = t_hdf5.HDF5Writer(tp)
    w.write_step(ts, tc, tb, fields={"rho": torch.from_numpy(rho)})
    w.close()
    for reader in (j_hdf5.HDF5Reader, t_hdf5.HDF5Reader):
        (fj, aj), (ft, at) = (r.read_step(-1) for r in (reader(jp),
                                                         reader(tp)))
        assert sorted(fj) == sorted(ft)
        for k in fj:
            np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)
        assert sorted(aj) == sorted(at)
        for k in aj:
            np.testing.assert_array_equal(np.asarray(at[k]),
                                          np.asarray(aj[k]), err_msg=k)
    # each package restarts from the other's dump
    s1, b1, c1 = t_hdf5.load_checkpoint(jp, SphConfig(), device="cpu")
    s2, b2, c2 = j_hdf5.load_checkpoint(tp, JCfg())
    assert b1 == tb and c1 == config_from_dict(dataclasses.asdict(c2))
    assert (b2.xmin, b2.bx.value) == (jb.xmin, jb.bx.value)
    for f in _FIELDS:
        np.testing.assert_array_equal(getattr(s1.p, f).numpy(),
                                      np.asarray(getattr(s2.p, f)))
    for f in ("ttot", "dt", "dt_m1", "iteration"):
        assert float(getattr(s1, f)) == float(getattr(s2, f)), f


def test_hdf5_step_order(tmp_path):
    """Rung state is read from the same step as the particles, also past
    ten steps (the JAX package orders the groups as strings)."""
    _, _, _, ts, tb, tc = _jax_state()
    path = str(tmp_path / "d.h5")
    w = t_hdf5.HDF5Writer(path)
    n = ts.p.n
    for i in range(11):
        w.write_step(ts.replace(iteration=torch.tensor(i, dtype=torch.int32)),
                     tc, tb, bdt_state={
                         "fields": {"bdt_rung": torch.full((n,), float(i)),
                                    "bdt_dt_m1k": torch.zeros(n)},
                         "attrs": {"bdt_dt_min": 1e-6, "bdt_num_rungs": 4}})
    w.close()
    state, _, _ = t_hdf5.load_checkpoint(path, SphConfig(), device="cpu")
    assert int(state.iteration) == 10
    assert t_hdf5.load_bdt_state(path)["rung"][0] == 10.0
    assert t_hdf5.load_bdt_state(path, 2)["rung"][0] == 2.0
    # the JAX package's reads "Step#9" ("Step#10" sorts before it)
    assert j_hdf5.load_bdt_state(path)["rung"][0] == 9.0


def test_hdf5_restart_equals_continued_run(cpu, tmp_path):
    dump = str(tmp_path / "d.h5")
    whole = run("-s", 4, "--quiet", "--constants", "")
    run("-s", 2, "-w", 2, "-o", dump, "--quiet", "--constants", "")
    restarted = main(["--init", dump, "-s", "2", "--quiet", "--constants",
                      ""])
    assert int(restarted.iteration) == 5
    assert_states_equal(restarted, whole)


def test_ascii_byte_equal_and_cross_read(tmp_path):
    js, jb, jc, ts, tb, tc = _jax_state()
    jp, tp = tmp_path / "j.txt", tmp_path / "t.txt"
    for writer, st, box, cfg, path in ((j_ascii.AsciiWriter, js, jb, jc, jp),
                                       (t_ascii.AsciiWriter, ts, tb, tc, tp)):
        w = writer(str(path))
        w.write_step(st, cfg, box)
        w.write_step(st, cfg, box, fields={"rho": st.p.h})
    assert tp.read_bytes() == jp.read_bytes()
    for reader in (j_ascii.AsciiReader, t_ascii.AsciiReader):
        (fj, aj), (ft, at) = (reader(str(p)).read_step(0) for p in (jp, tp))
        assert aj == at and sorted(fj) == sorted(ft)
        for k in fj:
            np.testing.assert_array_equal(ft[k], fj[k])
    s1, b1 = t_ascii.load_ascii_checkpoint(str(jp), tc, dt0=1e-4,
                                           device="cpu")
    s2, _ = j_ascii.load_ascii_checkpoint(str(tp), jc, dt0=1e-4)
    assert b1 == tb
    for f in _FIELDS:
        np.testing.assert_array_equal(getattr(s1.p, f).numpy(),
                                      np.asarray(getattr(s2.p, f)), f)


def test_ascii_restart(cpu, tmp_path):
    dump = str(tmp_path / "d.txt")
    run("-s", 2, "-w", 2, "--ascii", "-o", dump, "--quiet", "--constants",
        "")
    st = main(["--init", dump, "-s", "1", "--dt0", "1e-6", "--quiet",
               "--constants", ""])
    assert int(st.iteration) == 4
    assert all(bool(torch.isfinite(getattr(st.p, f)).all())
               for f in _FIELDS[:-1])
    assert float(st.p.vx.abs().max()) > 0.0   # x_m1 = v dt keeps v


def test_output_triggers(cpu, tmp_path):
    """Float -w = sim-time interval, --wextra steps, integer -w, as
    tests/test_io_cli.py:137-160 checks the JAX CLI."""
    def steps_written(*argv):
        out = str(tmp_path / "o.h5")
        run(*argv, "-o", out, "--quiet", "--constants", "")
        r = t_hdf5.HDF5Reader(out)
        try:
            return [int(r.read_step(i)[1]["iteration"][0])
                    for i in range(r.num_steps())]
        finally:
            r.close()

    assert 2 <= len(steps_written("-s", 5, "-w", "0.0002")) <= 4
    assert steps_written("-s", 4, "--wextra", "2,3") == [3, 4]
    assert steps_written("-s", 4, "-w", 2) == [3, 5]


def test_wall_clock_stop(cpu, tmp_path):
    st = run("-s", 50, "--duration", 0, "--quiet", "--constants",
             tmp_path / "c.txt")
    assert int(st.iteration) <= 3


def test_debug_nans(cpu, tmp_path):
    run("-s", 1, "--debug-nans", "--quiet", "--constants", "")
    js, jb, jc, ts, tb, tc = _jax_state()
    temp = ts.p.temp.clone()
    temp[17] = float("nan")
    path = str(tmp_path / "nan.h5")
    t_hdf5.save_checkpoint(path, ts.replace(p=ts.p.replace(temp=temp)), tc,
                           tb)
    with pytest.raises(FloatingPointError, match="non-finite values in "
                                                 "field 'x'"):
        main(["--init", path, "-s", "1", "--debug-nans", "--quiet",
              "--constants", ""])


@pytest.mark.parametrize("prop", ["ve-tiered", "ve-tiered-resident",
                                  "ve-tiered-bdt"])
def test_tiered_props_run(cpu, monkeypatch, prop):
    """The tiered props (refused until the tiers were ported) run at
    Sedov 8^3: one step (one 2-rung cycle), its tiers planned from the
    state, rows finite, the iteration advanced. (At Sedov 6^3 the
    planner's coarsest grid, n = 2, cannot serve h = 0.24: every row
    rides the support-bound clamp and the step folds, in both
    packages.)"""
    monkeypatch.setenv("SPHEXA_BDT_RUNGS", "2")
    st = main(["--init", "sedov", "-n", "8", "--dt0", "1e-4", "-s", "1",
               "--prop", prop, "--quiet", "--constants", ""])
    for f in _FIELDS[:-1]:
        assert torch.isfinite(getattr(st.p, f)).all(), f
    assert int(st.iteration) == (3 if prop == "ve-tiered-bdt" else 2)


@pytest.mark.parametrize("argv,rows", [
    (["--prop", "std-cooling"], 216),
    (["--profile"], 216),
    (["--viz-every", "1"], 216),
    (["--init", "evrard-cooling"], 136)])
def test_lifted_refusals_run(cpu, tmp_path, monkeypatch, argv, rows):
    """The cooling prop and case, --profile and --viz-every (refused
    until the slice that ported them) run one step at n = 6 in a scratch
    directory: rows finite, the iteration advanced, the trace or the PNG
    written. std-cooling on Sedov takes cgs units from a settings file
    (cooling::rho_to_cgs 1e-24): with the default CoolingParams, code
    density read as g/cm^3 overflows n_H^2 in float32 and the
    temperature is NaN after one step, in the JAX CLI too (ROADMAP
    Queue 3; tests/test_torch_cooling.py)."""
    import h5py
    monkeypatch.chdir(tmp_path)
    if "std-cooling" in argv:
        with h5py.File(tmp_path / "units.h5", "w") as f:
            f.attrs["cooling::rho_to_cgs"] = 1e-24
        argv = argv + ["--init", f"sedov:{tmp_path / 'units.h5'}"]
    st = run("-s", 1, "--quiet", "--constants", "", *argv)
    assert st.p.n == rows and int(st.iteration) == 2
    for f in _FIELDS[:-1]:
        assert torch.isfinite(getattr(st.p, f)).all(), f
    if "--profile" in argv:
        assert (tmp_path / "sphexa-trace" / "trace.json").is_file()
    if "--viz-every" in argv:
        assert (tmp_path / "viz_000001.png").is_file()


@pytest.mark.parametrize("argv,item", [
    (["--prop", "ve-pallas-sharded"], "item 10"),
    (["--prop", "ve-bdt-sharded"], "item 10"),
    (["--prop", "ve-hilbert"], "item 10"),
    (["--prop", "ve-tiered-sharded"], "item 10"),
    (["--prop", "turbulence-ve-bdt-sharded"], "item 10"),
    (["--prop", "ve-pallas-tiles"], "item 10")])
def test_refusals(cpu, monkeypatch, argv, item):
    """The six multi-device props, refused by the name of the same
    ROADMAP item until they were ported, now run a step (a BDT cycle)
    on 2 shards (SPHEXA_NUM_DEVICES=2) at Sedov 8^3 (at 6^3 a slab of
    half the box is thinner than 2 h_max): every row finite, every
    particle alive. ve-pallas-tiles runs there as 1 x 2 tiles."""
    monkeypatch.setenv("SPHEXA_NUM_DEVICES", "2")
    st = run("-s", 1, "--quiet", "--constants", "", "-n", 8, *argv)
    assert int(st.p.alive.sum()) == 8 ** 3
    for f in _FIELDS[:-1]:
        assert torch.isfinite(getattr(st.p, f)[st.p.alive]).all(), f


def test_refused_inputs(cpu, tmp_path):
    with pytest.raises(ValueError, match="unknown test case 'no-such-case'"):
        run("--init", "no-such-case", "-s", 1, "--constants", "")
    _, _, _, ts, tb, tc = _jax_state()
    path = str(tmp_path / "c.h5")
    t_hdf5.save_checkpoint(path, ts, tc, tb)
    # --split 2, refused until the Hilbert codecs were ported, now runs
    # (tests/test_torch_split.py holds the loader bit-equal to JAX)
    st = main(["--init", path, "--split", "2", "-s", "1", "--quiet",
               "--constants", ""])
    assert st.p.n == 2 * ts.p.n and int(st.iteration) == 2
    for f in _FIELDS[:-1]:
        assert torch.isfinite(getattr(st.p, f)).all(), f


def test_runs_on_the_gpu_by_default(monkeypatch):
    """Without SPHEXA_PLATFORM the CLI takes the GPU, and raises on a
    host with none rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default run would use it")
    monkeypatch.delenv("SPHEXA_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run("-s", 1, "--constants", "")
    monkeypatch.setenv("SPHEXA_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="SPHEXA_PLATFORM"):
        run("-s", 1, "--constants", "")
