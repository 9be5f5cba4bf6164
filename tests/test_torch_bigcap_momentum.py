"""The port's momentum stage K7 at cap 1152, past the former ceiling of
1024, against the Pallas kernel of the JAX package in interpret mode
(PallasVE(interpret=True).momentum at the same cap).

The frame is tests/test_torch_bigcap_stages.py's clump (CMGrid(n=2,
cap=1152), 1,120 rows in the densest cell). The stage's other inputs
are seeded numpy fields of plausible size (velocities sigma 0.3, xm
and kx near m and 1/h^3, rho = m kx / xm, sound speeds in [0.5, 1.5],
prho = c^2 / (1.67 rho), alpha in [0.05, 0.5], a near-diagonal cij of
scale 1/h^2), mapped into the cell-major frame by the JAX layout with
the pipeline's fill values, and handed to both packages. Tolerances, as
tests/test_torch_pair_ve.py: ax, ay, az, du at atol 1e-4 x the row's
max |value| (cancelling sums); maxvsignal rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sphexa_tpu.config import SphConfig as JCfg
from sphexa_tpu.ops import cellmajor as jcm
from sphexa_tpu.ops import pallas_ve as jpv
from test_torch_bigcap_stages import clump_frame, port_stages, to_torch
from torch_threads import two_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def frame():
    (x, y, z), h, jb, grid = clump_frame()
    n = x.size
    r = np.random.default_rng(9)
    cfg = JCfg()
    J = jnp.asarray
    lay = jcm.build_layout(grid, jb, J(x), J(y), J(z))
    assert int(lay.overflow) == 0
    pve = jpv.PallasVE(grid, cfg, interpret=True)

    def cm(a, fill=0.0):
        return jcm.to_cm(lay, J(np.asarray(a, np.float32)), fill)

    m = np.full(n, 1.0 / n)
    v = [r.normal(0, 0.3, n) for _ in range(3)]
    xm = m * (1.0 + 0.02 * r.normal(size=n))
    kx = (1.0 + 0.05 * r.normal(size=n)) / h.astype(np.float64) ** 3
    rho = m * kx / xm
    c = r.uniform(0.5, 1.5, n)
    prho = c ** 2 / (1.67 * rho)
    alpha = r.uniform(0.05, 0.5, n)
    h2 = h.astype(np.float64) ** 2
    cij = [(1.0 + 0.1 * r.normal(size=n)) / h2 if k in (0, 3, 5)
           else 0.1 * r.normal(size=n) / h2 for k in range(6)]
    args = (list(pve.base_rows(lay, J(x), J(y), J(z), J(h))), cm(v[0]),
            cm(v[1]), cm(v[2]), cm(c, 1.0), cm(prho), cm(rho, 1.0),
            cm(xm, 1.0), cm(alpha), cm(m), tuple(cm(q) for q in cij))
    jout = pve.momentum(*args)
    mask = np.asarray(lay.valid & jcm.interior_mask(grid))
    tout = port_stages(grid, cfg).momentum(*to_torch(list(args)))
    return jout, tout, mask


def test_k7_momentum_cap1152(frame):
    jout, tout, mask = frame
    for a, b in zip(jout[:4], tout[:4]):
        a, b = np.asarray(a)[mask], np.asarray(b)[mask]
        scale = max(np.abs(a).max(), 1e-30)
        assert np.abs(b - a).max() <= 1e-4 * scale, (np.abs(b - a).max(),
                                                     scale)
    np.testing.assert_allclose(np.asarray(tout[4])[mask],
                               np.asarray(jout[4])[mask], rtol=1e-5)
    assert np.asarray(jout[4])[mask].max() > 0
