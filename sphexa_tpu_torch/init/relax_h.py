"""Host-side smoothing-length equilibration.

Counterpart of sphexa_tpu/init/relax_h.py, the same numpy and scipy
code. ICs with vacuum boundaries (Evrard, isolated spheres) start edge
particles far below the neighbor-count window: the pair kernels'
h-controller (K3, ops/pair_ve.py; the reference's coupled h loop,
sph/include/sph/find_neighbors.hpp:48-56) then grows their h every step
until nc >= ng0/4, which outruns the tier and grid support headroom.

`equilibrate_h` iterates the EXACT controller update on the host with
exact kd-tree neighbor counts until every particle sits inside the
[ng0/4, ngmax] window, so engines start from the controller's own
fixed point. O(N log N) per sweep via cKDTree. Nothing in the CLI calls
it (nor in the JAX package).
"""

from __future__ import annotations

import numpy as np

from sphexa_tpu_torch.util.device import host


def equilibrate_h(box, x, y, z, h, alive=None, ng0: int = 100,
                  ngmax: int = 150, max_sweeps: int = 200,
                  verbose: bool = False):
    """Return h (np.float64 [N]) iterated to the controller window.

    Matches the h controller of K3: nc_sph counts neighbors within 2h
    INCLUDING self; particles outside [ng0/4, ngmax] move by
    h <- h * 0.5 * (1 + 1023 * ng0 / nc_sph)^0.1. Dead slots keep
    their h. Periodic dims wrap when ALL dims are periodic (cKDTree
    boxsize contract); mixed-BC boxes count open, so callers with mixed
    periodicity should pass pre-wrapped coordinates. Tensors (on any
    device) and arrays are both taken. Raises ValueError when
    max_sweeps pass without convergence.
    """
    from scipy.spatial import cKDTree

    x = np.asarray(host(x), np.float64)
    y = np.asarray(host(y), np.float64)
    z = np.asarray(host(z), np.float64)
    h_all = np.asarray(host(h), np.float64).copy()
    if alive is not None:
        keep = host(alive)
    else:
        keep = np.ones(x.shape[0], bool)
    pts = np.c_[x[keep], y[keep], z[keep]]
    hv = h_all[keep]

    boxsize = None
    if all(box.periodic):
        boxsize = np.array([box.lx, box.ly, box.lz])
        pts = (pts - np.array([box.xmin, box.ymin, box.zmin])) % boxsize

    tree = cKDTree(pts, boxsize=boxsize)
    ngmin = float(ng0 // 4)
    for sweep in range(max_sweeps):
        counts = np.array([len(idx) for idx in
                           tree.query_ball_point(pts, 2.0 * hv)],
                          np.float64)
        need = (counts < ngmin) | (counts - 1.0 > float(ngmax))
        if not need.any():
            if verbose:
                print(f"# equilibrate_h: converged after {sweep} sweeps")
            break
        hv = np.where(need,
                      hv * 0.5 * (1.0 + 1023.0 * float(ng0)
                                  / np.maximum(counts, 1.0)) ** 0.1,
                      hv)
    else:
        raise ValueError(
            f"equilibrate_h did not converge in {max_sweeps} sweeps "
            f"({int(need.sum())} particles outside the window)")
    h_all[keep] = hv
    return h_all
