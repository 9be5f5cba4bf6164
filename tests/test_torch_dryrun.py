"""sphexa_tpu_torch.dryrun.dryrun_multichip, the counterpart of the JAX
package's __graft_entry__.dryrun_multichip, on the CPU at D = 2: the
slab-sharded cell-major step on Sedov 16^3, the Hilbert domain with the
generic sharded FMM on Evrard 20 and one ShardedBdtVE cycle whose rung
histograms equal BdtVE's, each leg with its fail-stops asserted inside.

The JAX dry run's first leg takes a global grid of D cells a side; at
D = 2 its 8 cells hold 512 Sedov 16^3 rows each, past its cap of 128
(the port's leg takes max(D, 4) cells): the second test shows that
overflow with the JAX package's own layout builder.
"""

import numpy as np

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.init.sedov import init_sedov as j_init_sedov
from sphexa_tpu.ops import cellmajor as jcm
from sphexa_tpu_torch.dryrun import dryrun_multichip
from torch_threads import two_torch_threads  # noqa: F401


def test_dryrun_two_shards():
    out = dryrun_multichip(2, device="cpu")
    assert set(out) == {"slab", "hilbert", "bdt"}
    assert out["slab"]["n"] == 16 ** 3
    assert 1.0 <= out["hilbert"]["imbalance"] < 1.15
    assert out["hilbert"]["etot"] < 0          # the sphere is bound
    hist = out["bdt"]["rung_hist"]
    assert len(hist) == 2 and all(sum(h) == 1000 for h in hist)


def test_jax_leg_one_overflows_at_two_devices():
    state, box, _ = j_init_sedov(16, JCfg(chunk=512, cell_cap=96,
                                          ngpad=160), dt0=1e-5)
    for D, over in ((2, True), (8, False)):
        grid = jcm.CMGrid(n=D, cap=128)
        lay = jcm.build_layout(grid, box, state.p.x, state.p.y, state.p.z,
                               alive=state.p.alive)
        assert (int(np.asarray(lay.overflow)) > 0) == over, D
