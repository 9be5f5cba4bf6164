"""ShardedBdtVE with self-gravity (the direct sum) against the JAX
package's (Pallas in interpret mode, under jax.shard_map on two virtual
CPU devices; the port's shards are SlabMesh threads with the plain
kernel versions): one 2-rung cycle at Evrard 8 (280 particles) on the
slab plan of the CLI adapter (CMGrid(n=1, cap=256, nzi=1), D = 2). Per
substep dt and etot at rtol 1e-5, eint at 1e-6, ecin at 1e-3 (as
tests/test_torch_sharded_bdt.py holds the gravity-free engine), rung
histograms equal, overflow 0. The JAX engine sums gravity over the
valid slot frame, the port over the valid slots compacted to the slab
cap, in another order: the tolerances are float32 rounding's.
"""

import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.domain.slab import AXIS, SlabConfig as JSlabConfig
from sphexa_tpu.init.evrard import init_evrard as j_init_evrard
from sphexa_tpu.ops.cellmajor import CMGrid as JCMGrid
from sphexa_tpu.propagator.ve_bdt_sharded import ShardedBdtVE as JSharded
from sphexa_tpu.state import _FIELDS
from sphexa_tpu_torch.domain.mesh import SlabMesh
from sphexa_tpu_torch.domain.slab import SlabConfig
from sphexa_tpu_torch.interop import (box_from_numpy, config_from_dict,
                                      state_from_numpy)
from sphexa_tpu_torch.ops.cellmajor import CMGrid
from sphexa_tpu_torch.propagator.ve_bdt_sharded import ShardedBdtVE
from torch_threads import two_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def bdt_runs():
    D, rungs = 2, 2
    state, jb, cfg = j_init_evrard(8, JCfg(cell_cap=256, ngpad=256),
                                   dt0=1e-4)
    n = int(np.asarray(state.p.alive).sum())
    grid = JCMGrid(n=1, cap=256, nzi=1)
    sc = JSlabConfig(n_slabs=D, cap=n, halo_cap=152, mig_cap=128)
    jeng = JSharded(jb, grid, cfg, sc, Mesh(np.array(jax.devices()[:D]),
                                            (AXIS,)),
                    num_rungs=rungs, interpret=True)
    _, jds = jeng.run_cycle(jeng.distribute_bind(state))

    tbox = box_from_numpy([jb.xmin, jb.xmax, jb.ymin, jb.ymax, jb.zmin,
                           jb.zmax], [b.value for b in (jb.bx, jb.by, jb.bz)])
    teng = ShardedBdtVE(tbox, CMGrid(n=1, cap=256, nzi=1),
                        config_from_dict(dataclasses.asdict(cfg)),
                        SlabConfig(**dataclasses.asdict(sc)),
                        SlabMesh(D, devices=["cpu"]), num_rungs=rungs)
    tstate = state_from_numpy({f: np.asarray(getattr(state.p, f))
                               for f in _FIELDS}, float(state.ttot),
                              float(state.dt), float(state.dt_m1),
                              int(state.iteration), device="cpu")
    _, tds = teng.run_cycle(teng.distribute_bind(tstate))
    return cfg, [{k: np.asarray(v) for k, v in d._asdict().items()}
                 for d in jds], [{k: v.numpy() for k, v in d._asdict()
                                  .items()} for d in tds]


def test_sharded_bdt_direct_gravity(bdt_runs):
    cfg, jd, td = bdt_runs
    assert cfg.gravG != 0.0 and cfg.gravity_solver == "direct"
    for a, b in zip(jd, td):
        assert int(b["overflow"]) == int(a["overflow"]) == 0
        for k, rtol in (("dt", 1e-5), ("etot", 1e-5), ("eint", 1e-6)):
            np.testing.assert_allclose(b[k], a[k], rtol=rtol, err_msg=k)
        np.testing.assert_allclose(b["ecin"], a["ecin"], rtol=1e-3,
                                   atol=1e-12)
        np.testing.assert_array_equal(b["rung_hist"], a["rung_hist"])
        egrav = float(a["etot"]) - float(a["ecin"]) - float(a["eint"])
        assert egrav < -0.1         # the sphere is bound
