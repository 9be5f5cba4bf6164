"""The port's turbulence-stirred block time-steps against the JAX
package: TurbBdtVE (Pallas in interpret mode), TurbShardedBdtVE (under
jax.shard_map, jitted, on two of the conftest's virtual CPU devices; the
port's shards are SlabMesh threads), and --prop turbulence-ve-bdt
through the port's main.

Frames:
  - TurbBdtVE: turbulence 8^3 on CMGrid(n=2, cap=128), the grid the JAX
    planner (choose_cm_grid) gives it: the smallest turbulence frame it
    plans at cap 128 (at 6^3 it plans a single cell a side); 2 rungs,
    one cycle from the same bound state. At the uniform start every slot
    sits on rung 0, so both substeps are fully active: the turbulence
    regime of the card's runs.
  - TurbShardedBdtVE: turbulence 12^3, local CMGrid(n=4, cap=64, nzi=2)
    (tests/test_torch_sharded_bdt.py's grid: the same box and h), D = 2,
    2 rungs, one cycle.
Tolerances, as tests/test_torch_bdt.py and test_torch_sharded_bdt.py
hold the unstirred engines: per substep dt rtol 1e-5, eint rtol 1e-6,
ecin rtol 1e-3 (the lattice's pressure forces are rounding noise, see
tests/test_torch_turbulence.py), rung_hist, active_frac and
active_cell_frac equal, overflow 0; the per-slot rungs equal; unbound x,
y, z, vx, vy, vz, temp, h within 2e-3 of their scale, alpha within
1e-4; the OU phases after the cycle bit-equal (both packages draw them
on the host, once a substep, with the same dt). Through main: the CLI's
cycle bit-equal to TurbBdtVE driven by hand on the planner's grid, and
a restart from an HDF5 dump (turbulence_phases, its RNG state and the
rung state) bit-equal to the continued run.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.domain.slab import AXIS, SlabConfig as JSlabConfig
from sphexa_tpu.init.turbulence import init_turbulence as j_init
from sphexa_tpu.io import hdf5 as j_hdf5
from sphexa_tpu.ops.cellmajor import CMGrid as JCMGrid
from sphexa_tpu.ops.cellmajor import choose_cm_grid as j_choose_cm_grid
from sphexa_tpu.propagator.ve_bdt import TurbBdtVE as JTurbBdtVE
from sphexa_tpu.propagator.ve_bdt_sharded import \
    TurbShardedBdtVE as JTurbSharded
from sphexa_tpu.state import _FIELDS
from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.domain.mesh import SlabMesh
from sphexa_tpu_torch.domain.slab import SlabConfig
from sphexa_tpu_torch.init.factory import make_initializer
from sphexa_tpu_torch.interop import (box_from_numpy, config_from_dict,
                                      state_from_numpy)
from sphexa_tpu_torch.io import hdf5 as t_hdf5
from sphexa_tpu_torch.main import main
from sphexa_tpu_torch.ops.cellmajor import CMGrid, choose_cap_and_grid
from sphexa_tpu_torch.propagator.ve_bdt import TurbBdtVE
from sphexa_tpu_torch.propagator.ve_bdt_sharded import TurbShardedBdtVE

RUNGS = 2
D = 2
UNBOUND_TOL = (("x", 2e-3), ("y", 2e-3), ("z", 2e-3), ("vx", 2e-3),
               ("vy", 2e-3), ("vz", 2e-3), ("temp", 2e-3), ("h", 2e-3),
               ("alpha", 1e-4))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads (tests/test_torch_bdt.py: the plain stages on
    these small frames are many small ops)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _np_tree(obj):
    """Dataclass of arrays (nested) -> dict of numpy copies."""
    return {f.name: (_np_tree(getattr(obj, f.name))
                     if dataclasses.is_dataclass(getattr(obj, f.name))
                     else np.array(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)}


def _split_tree(tree):
    """A JAX sharded state's numpy tree -> one tree per shard."""
    def cut(v, i):
        return v if v.ndim == 0 else np.split(v, D)[i]
    return [{k: ({kk: cut(vv, i) for kk, vv in v.items()}
                 if isinstance(v, dict) else cut(v, i))
             for k, v in tree.items()} for i in range(D)]


def _assert_tree_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_tree_equal(got[k], v)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def _diag_np(d):
    return {k: np.asarray(v) for k, v in d._asdict().items()}


def _assert_diag_close(b, a):
    assert int(b["overflow"]) == int(a["overflow"]) == 0
    np.testing.assert_allclose(b["dt"], a["dt"], rtol=1e-5)
    np.testing.assert_allclose(b["eint"], a["eint"], rtol=1e-6)
    np.testing.assert_allclose(b["ecin"], a["ecin"], rtol=1e-3, atol=1e-20)
    assert float(a["ecin"]) > 0                  # the stirring did work
    np.testing.assert_array_equal(b["rung_hist"], a["rung_hist"])
    assert float(b["active_frac"]) == float(a["active_frac"])
    assert float(b["active_cell_frac"]) == float(a["active_cell_frac"])


def _assert_unbound_close(tout, jout):
    np.testing.assert_array_equal(tout.p.alive.numpy(),
                                  np.asarray(jout.p.alive))
    for f, tol in UNBOUND_TOL:
        a = np.asarray(getattr(jout.p, f))
        b = getattr(tout.p, f).numpy()
        scale = max(np.abs(a).max(), 1e-30)
        assert np.abs(b - a).max() / scale < tol, f


def _host(js):
    return state_from_numpy({f: np.asarray(getattr(js.p, f))
                             for f in _FIELDS}, float(js.ttot),
                            float(js.dt), float(js.dt_m1),
                            int(js.iteration), device="cpu")


def _tbox(jb):
    return box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                           jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])


# ---------------------------------------------------------------------------
# TurbBdtVE
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def single():
    js, jb, jc = j_init(8, JCfg())
    jc = jc.replace(uniform_mass=True)
    n = js.p.n
    grid = j_choose_cm_grid(jb, float(np.max(np.asarray(js.p.h))) * 1.25, n)
    assert (grid.n, grid.cap) == (2, 128), grid
    jeng = JTurbBdtVE(jb, grid, jc, num_rungs=RUNGS, interpret=True)
    jb0 = jeng.bind_bdt(js)
    jbound = _np_tree(jb0)
    jbst, jds = jeng.run_cycle(jb0)

    teng = TurbBdtVE(_tbox(jb), CMGrid(n=grid.n, cap=grid.cap, nzi=grid.nzi,
                                       nxi=grid.nxi),
                     config_from_dict(dataclasses.asdict(jc)),
                     num_rungs=RUNGS, device="cpu")
    tb0 = teng.bind_bdt(_host(js))
    tbound = _np_tree(tb0)
    tbst, tds = teng.run_cycle(tb0)
    return dict(jbound=jbound, tbound=tbound,
                jd=[_diag_np(d) for d in jds], td=[_diag_np(d) for d in tds],
                jcyc=_np_tree(jbst), tcyc=_np_tree(tbst),
                jout=jeng.unbind(jbst.rv, n), tout=teng.unbind(tbst.rv, n),
                jturb=jeng.turb, tturb=teng.turb, teng=teng, tbst=tbst)


def test_bind_equal(single):
    _assert_tree_equal(single["tbound"], single["jbound"])


@pytest.mark.parametrize("sub", range(1 << (RUNGS - 1)))
def test_substep_diagnostics(single, sub):
    a, b = single["jd"][sub], single["td"][sub]
    _assert_diag_close(b, a)
    assert float(a["active_frac"]) == 1.0       # every slot on rung 0


def test_rungs_per_slot(single):
    a, b = single["jcyc"], single["tcyc"]
    np.testing.assert_array_equal(b["rung"], a["rung"])
    np.testing.assert_array_equal(b["rv"]["valid"], a["rv"]["valid"])
    assert int(b["substep"]) == int(a["substep"]) == 0


def test_unbound_fields(single):
    _assert_unbound_close(single["tout"], single["jout"])


def test_ou_state_equal(single):
    np.testing.assert_array_equal(single["tturb"].phases,
                                  single["jturb"].phases)
    assert single["tturb"].rng.bit_generator.state == \
        single["jturb"].rng.bit_generator.state


def test_stirring_only_on_valid_interior_slots(single):
    """The port's stirring sum runs over the index the resync built: the
    kick accelerations of the slots outside it are the gated stages'
    alone (0 outside the interior, prev elsewhere), equal to the JAX
    package's there, and the committed ones within 2e-3 of its scale."""
    a, b = single["jcyc"], single["tcyc"]
    teng = single["teng"]
    vi = (b["rv"]["valid"] & teng.intmask.numpy())
    idx = teng.gravity_index(single["tbst"].rv.valid).numpy()
    assert np.array_equal(np.flatnonzero(vi), idx)
    for k in ("axk", "ayk", "azk"):
        scale = np.abs(a[k][vi]).max()
        assert np.abs(b[k][vi] - a[k][vi]).max() / scale < 2e-3, k
        np.testing.assert_array_equal(b[k][~vi], a[k][~vi], err_msg=k)


def test_phases_need_stirring_modes(single):
    """The unstirred BdtVE refuses phases rather than ignoring them."""
    from sphexa_tpu_torch.propagator.ve_bdt import BdtVE
    teng = single["teng"]
    eng = BdtVE(teng.box, teng.grid, teng.cfg, num_rungs=RUNGS,
                device="cpu")
    pr, pi = (torch.zeros(112, 3) for _ in range(2))
    with pytest.raises(ValueError, match="TurbBdtVE"):
        eng.substep(single["tbst"], pr, pi)


# ---------------------------------------------------------------------------
# TurbShardedBdtVE
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sharded():
    side = 12
    n = side ** 3
    js, jb, jc = j_init(side, JCfg(cell_cap=256, ngpad=256))
    jc = jc.replace(uniform_mass=True)
    grid = JCMGrid(n=4, cap=64, nzi=2)
    sc = JSlabConfig(n_slabs=D, cap=(n // D) * 2 + 64, halo_cap=8,
                     mig_cap=256)
    jmesh = Mesh(np.array(jax.devices()[:D]), (AXIS,))
    jeng = JTurbSharded(jb, grid, jc, sc, jmesh, num_rungs=RUNGS,
                        interpret=True)
    jbst, jds = jeng.run_cycle(jeng.distribute_bind(js))
    jout = jeng.unbind(jbst, n)

    mesh = SlabMesh(D, devices=["cpu"])
    teng = TurbShardedBdtVE(_tbox(jb), CMGrid(n=4, cap=64, nzi=2),
                            config_from_dict(dataclasses.asdict(jc)),
                            SlabConfig(**dataclasses.asdict(sc)), mesh,
                            num_rungs=RUNGS)
    tbst, tds = teng.run_cycle(teng.distribute_bind(_host(js)))
    return dict(jd=[_diag_np(d) for d in jds], td=[_diag_np(d) for d in tds],
                jcyc=_split_tree(_np_tree(jbst)),
                tcyc=[_np_tree(b) for b in tbst], jout=jout,
                tout=teng.unbind(tbst, n), jturb=jeng.turb, tturb=teng.turb)


@pytest.mark.parametrize("sub", range(1 << (RUNGS - 1)))
def test_sharded_substep_diagnostics(sharded, sub):
    _assert_diag_close(sharded["td"][sub], sharded["jd"][sub])


@pytest.mark.parametrize("shard", range(D))
def test_sharded_rungs_per_slot(sharded, shard):
    a, b = sharded["jcyc"][shard], sharded["tcyc"][shard]
    np.testing.assert_array_equal(b["rung"], a["rung"])
    np.testing.assert_array_equal(b["rv"]["valid"], a["rv"]["valid"])
    np.testing.assert_array_equal(b["rv"]["gid"], a["rv"]["gid"])


def test_sharded_unbound_fields(sharded):
    _assert_unbound_close(sharded["tout"], sharded["jout"])
    assert sharded["tout"].p.alive.all()


def test_sharded_ou_state_equal(sharded):
    """One draw a substep for all shards, as the JAX package."""
    np.testing.assert_array_equal(sharded["tturb"].phases,
                                  sharded["jturb"].phases)


# ---------------------------------------------------------------------------
# --prop turbulence-ve-bdt through main
# ---------------------------------------------------------------------------

TURB6 = ["--init", "turbulence", "-n", "6", "--prop", "turbulence-ve-bdt",
         "--quiet", "--constants", ""]


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("SPHEXA_PLATFORM", "cpu")


def _assert_states_equal(a, b):
    for f in _FIELDS:
        assert torch.equal(getattr(a.p, f), getattr(b.p, f)), f
    for f in ("ttot", "dt", "dt_m1", "iteration"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_cli_matches_engine(cpu):
    """One CLI cycle: the state of TurbBdtVE driven by hand on the
    planner's grid (4 rungs, 8 substeps)."""
    got = main(TURB6 + ["-s", "1"])
    state, box, cfg = make_initializer("turbulence")(6, SphConfig(),
                                                     device="cpu")
    alive = state.p.alive.numpy()
    h_max = float(state.p.h[state.p.alive].max())
    _, grid = choose_cap_and_grid(box, h_max * 1.25, int(alive.sum()),
                                  *(getattr(state.p, c).numpy()[alive]
                                    for c in "xyz"), headroom=8)
    eng = TurbBdtVE(box, grid, cfg, device="cpu")
    bst, _ = eng.run_cycle(eng.bind_bdt(state))
    _assert_states_equal(got, eng.unbind(bst.rv, state.p.n))


def test_cli_restart_equals_continued_run(cpu, tmp_path):
    """Two cycles in one run; one cycle dumped (turbulence_phases, the
    OU RNG state, the rungs), then a restart for one more: bit-equal.
    Both packages' readers give the dump's OU state."""
    dump = str(tmp_path / "t.h5")
    whole = main(TURB6 + ["-s", "2"])
    main(TURB6 + ["-s", "1", "-w", "1", "-o", dump])
    ts = t_hdf5.load_turbulence_state(dump)
    js = j_hdf5.load_turbulence_state(dump, -1)
    assert ts["phases"].shape == (112, 6) and np.abs(ts["phases"]).max() > 0
    np.testing.assert_array_equal(ts["phases"], js["phases"])
    assert ts["rng_state"] == js["rng_state"]
    restarted = main(["--init", dump] + TURB6[4:] + ["-s", "1"])
    _assert_states_equal(restarted, whole)
