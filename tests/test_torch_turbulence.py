"""The port's turbulence stirring (sphexa_tpu_torch/physics/turbulence.py,
init/turbulence.py, propagator/turb_ve.py, observables/case_observables
.turbulence_mach_rms) against the JAX package on the same inputs.

Tolerances, and why:
  - the modes, the amplitudes, the OU phases over 5 updates and the
    projected phases: bit-equal (both packages run the same numpy
    float64 code from the same seeded default_rng);
  - stir_accelerations: rtol 1e-5 of each component's scale (its largest
    magnitude) on the valid rows. The angles reach ~16 rad in float32
    and the port sums the 112 modes in another order (two products a
    chunk, not the elementwise sum); rows at FILL_POS (1e8) differ
    between the libraries' cos and sin and are never committed, so they
    are left out;
  - init_turbulence: every field equal, the config equal;
  - TurbVeProp for 2 steps at 10^3 on the gather path: dt, etot, eint,
    ecin at rtol 1e-5 and the fields at 1e-4 of their scale, as
    tests/test_torch_gather.py holds make_ve_step, on a perturbed frame;
    on the CLI's lattice, where the pressure forces are rounding noise
    8.7e-4 of the stirring's effect, ecin at 1e-3 and the velocities at
    2e-3 (see test_turb_ve_prop); the OU state after them bit-equal;
  - turbulence_mach_rms: rtol 1e-6 (one float32 sum in another order);
  - a checkpoint and restore of the OU state (the port's dict, the JAX
    package's dict and the port's through an HDF5 dump) gives phases
    bit-equal to an uninterrupted run.
The module runs on one torch thread (see tests/torch_threads.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.init.turbulence import init_turbulence as j_init
from sphexa_tpu.neighbors import CellGrid as JGrid
from sphexa_tpu.neighbors import choose_level as j_choose_level
from sphexa_tpu.observables.case_observables import \
    turbulence_mach_rms as j_mach
from sphexa_tpu.physics import turbulence as jt
from sphexa_tpu.propagator.turb_ve import TurbVeProp as JTurbVeProp
from sphexa_tpu.state import _FIELDS
from sphexa_tpu_torch.config import SphConfig
from sphexa_tpu_torch.init.turbulence import init_turbulence
from sphexa_tpu_torch.interop import (box_from_numpy, config_from_dict,
                                      state_from_numpy)
from sphexa_tpu_torch.io import hdf5 as t_hdf5
from sphexa_tpu_torch.neighbors import CellGrid
from sphexa_tpu_torch.observables.case_observables import turbulence_mach_rms
from sphexa_tpu_torch.physics import turbulence as tt
from sphexa_tpu_torch.propagator.turb_ve import TurbVeProp
from torch_threads import one_torch_thread  # noqa: F401

DTS = (1e-4, 2.5e-4, 3e-4, 1.7e-3, 4e-4)     # OU update steps


def tbox(jb):
    return box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                           jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])


def tstate(js):
    return state_from_numpy({f: np.asarray(getattr(js.p, f))
                             for f in _FIELDS}, float(js.ttot), float(js.dt),
                            float(js.dt_m1), int(js.iteration), device="cpu")


def close(what, got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rtol, f"{what}: {err:.3e} of scale > {rtol}"


@pytest.mark.parametrize("consts", [None, dict(solWeight=1.0),
                                    dict(stSpectForm=0, rngSeed=7)])
def test_modes_and_amplitudes(consts):
    a = jt.TurbulenceData.create(consts)
    b = tt.TurbulenceData.create(consts)
    np.testing.assert_array_equal(b.modes, a.modes)
    np.testing.assert_array_equal(b.amplitudes, a.amplitudes)
    for k in ("variance", "decay_time", "sol_weight", "sol_weight_norm"):
        assert getattr(b, k) == getattr(a, k), k
    assert len(tt.TurbulenceData.create().modes) == 112


def test_ou_phases_bit_equal():
    a, b = jt.TurbulenceData.create(), tt.TurbulenceData.create()
    for dt in DTS:
        a.update_noise(dt)
        b.update_noise(dt)
        np.testing.assert_array_equal(b.phases, a.phases)
        for x, y in zip(b.projected_phases(), a.projected_phases()):
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)
    assert np.abs(b.phases).max() > 0


@pytest.mark.parametrize("chunk", [1000, 65536])
def test_stir_accelerations(chunk):
    """On 5000 seeded rows (chunks of 1000, and one chunk), 100 more at
    FILL_POS that are left out of the comparison."""
    td = jt.TurbulenceData.create()
    for dt in DTS:
        td.update_noise(dt)
    pr, pi = td.projected_phases()
    rng = np.random.default_rng(11)
    xyz = [np.concatenate([rng.uniform(-0.6, 0.6, 5000),
                           np.full(100, 1e8)]).astype(np.float32)
           for _ in range(3)]
    want = jt.stir_accelerations(*(jnp.asarray(v) for v in xyz), td.modes,
                                 pr, pi, td.amplitudes, td.sol_weight_norm)
    got = tt.stir_accelerations(*(torch.from_numpy(v) for v in xyz),
                                td.modes, torch.from_numpy(pr),
                                torch.from_numpy(pi), td.amplitudes,
                                td.sol_weight_norm, chunk=chunk)
    for c, g, w in zip("xyz", got, want):
        close(f"a{c}", g.numpy()[:5000], np.asarray(w)[:5000], 1e-5)


@pytest.mark.parametrize("side", [6, 10])
def test_init_turbulence(side):
    js, jb, jc = j_init(side, JCfg())
    ts, tb, tc = init_turbulence(side, SphConfig(), device="cpu")
    for f in _FIELDS:
        np.testing.assert_array_equal(getattr(ts.p, f).numpy(),
                                      np.asarray(getattr(js.p, f)), f)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tb == tbox(jb)
    for k in ("ttot", "dt", "dt_m1", "iteration"):
        assert float(getattr(ts, k)) == float(getattr(js, k)), k


def _perturbed(js, seed):
    """Seeded position jitter (0.2 of the lattice step) and velocities,
    so that the pressure forces are real, not a cancelling sum."""
    rng = np.random.default_rng(seed)
    p = js.p
    n = p.x.shape[0]
    kw = {c: (np.asarray(getattr(p, c)) + rng.uniform(-0.02, 0.02, n))
          .astype(np.float32) for c in "xyz"}
    kw.update({c: np.float32(0.3) * rng.standard_normal(n).astype(np.float32)
               for c in ("vx", "vy", "vz")})
    return js.replace(p=p.replace(**{k: jnp.asarray(v)
                                     for k, v in kw.items()}))


@pytest.mark.parametrize("frame", ["lattice", "perturbed"])
def test_turb_ve_prop(frame):
    """TurbVeProp against the JAX TurbVeProp, 2 steps at turbulence 10^3
    (cell_cap 128 holds its 125-row cells at level 1): the lattice the
    CLI starts from, and the same perturbed.

    On the lattice the gas starts at rest and the pressure forces are a
    cancelling sum of rounding noise: the JAX make_ve_step alone moves
    it to |v| 1.7e-9 in these 2 steps, 8.7e-4 of the stirred velocities'
    1.9e-6, and another summation order gives another noise. So there
    ecin is held at rtol 1e-3 and the velocities at 2e-3 of their scale
    (measured: 4.8e-4, 7.6e-4, 8.5e-4); on the perturbed frame, every
    field at the gather tests' 1e-4 and the diagnostics at 1e-5."""
    js, jb, jc = j_init(10, JCfg())
    jc = jc.replace(cell_cap=128, uniform_mass=True)
    if frame == "perturbed":
        js = _perturbed(js, 5)
    alive = np.asarray(js.p.alive)
    level = j_choose_level(jb, float(np.max(np.asarray(js.p.h)[alive]))
                           * 1.25)
    jprop = JTurbVeProp(jb, JGrid(level), jc)
    tprop = TurbVeProp(tbox(jb), CellGrid(level),
                       config_from_dict(dataclasses.asdict(jc)),
                       device="cpu")
    noise = frame == "lattice"
    ts = tstate(js)
    for i in range(2):
        js, jd = jprop(js)
        ts, td = tprop(ts)
        assert int(td.max_nc) == int(jd.max_nc), i
        assert int(td.max_cell_count) == int(jd.max_cell_count), i
        for k in ("dt", "etot", "eint", "ecin"):
            rtol = 1e-3 if noise and k == "ecin" else 1e-5
            np.testing.assert_allclose(float(getattr(td, k)),
                                       float(getattr(jd, k)), rtol=rtol,
                                       err_msg=f"step {i} {k}")
    assert float(td.ecin) > 0
    for c in ("x", "y", "z", "vx", "vy", "vz", "temp", "h", "alpha"):
        rtol = 2e-3 if noise and c.startswith("v") else 1e-4
        close(f"{frame} {c}", getattr(ts.p, c).numpy(), getattr(js.p, c),
              rtol=rtol)
    np.testing.assert_array_equal(tprop.turb.phases, jprop.turb.phases)


def test_turbulence_mach_rms():
    js, jb, jc = j_init(8, JCfg())
    rng = np.random.default_rng(3)
    n = js.p.x.shape[0]
    v = [np.float32(0.2) * rng.standard_normal(n).astype(np.float32)
         for _ in range(3)]
    js = js.replace(p=js.p.replace(vx=jnp.asarray(v[0]),
                                   vy=jnp.asarray(v[1]),
                                   vz=jnp.asarray(v[2])))
    want = j_mach(js.p, jc)
    got = turbulence_mach_rms(tstate(js).p,
                              config_from_dict(dataclasses.asdict(jc)))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_checkpoint_restore(tmp_path):
    """Three OU updates, a checkpoint, two more: a fresh driver restored
    from the checkpoint (the port's dict, the JAX package's dict, and
    the port's through an HDF5 dump) and given the same two updates
    ends bit-equal to the uninterrupted one."""
    whole = tt.TurbulenceData.create()
    jax_td = jt.TurbulenceData.create()
    for dt in DTS[:3]:
        whole.update_noise(dt)
        jax_td.update_noise(dt)
    ck = whole.checkpoint_state()
    js, jb, jc = j_init(4, JCfg())
    path = str(tmp_path / "t.h5")
    t_hdf5.save_checkpoint(path, tstate(js),
                           config_from_dict(dataclasses.asdict(jc)),
                           tbox(jb), turb_state=ck)
    for dt in DTS[3:]:
        whole.update_noise(dt)
    for src in (ck, jax_td.checkpoint_state(),
                t_hdf5.load_turbulence_state(path)):
        td = tt.TurbulenceData.create()
        td.restore(src)
        for dt in DTS[3:]:
            td.update_noise(dt)
        np.testing.assert_array_equal(td.phases, whole.phases)
        for x, y in zip(td.projected_phases(), whole.projected_phases()):
            np.testing.assert_array_equal(x, y)
