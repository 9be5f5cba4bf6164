"""SPH-relaxed glass template blocks.

Counterpart of sphexa_tpu/init/glass.py (reference: the pre-relaxed 50^3
glass block that main/src/init/grid.hpp:238 assembleCuboid tiles; the
reference downloads it, the JAX package generates it by damped SPH
relaxation of a jittered lattice, and so does this module, with numpy
and scipy's cKDTree only: the same steps, bit for bit).

Templates are cached on disk keyed by (side, seed, steps), in this
package's own directory under the checkout's build/ (never the JAX
package's ~/.cache/sphexa-glass, so neither package reads the other's
files). `glass_cuboid` checks that a cuboid can host whole template
blocks before it relaxes one (the JAX package relaxes first and then
refuses): the same result or the same refusal, without the relaxation a
refused cuboid would waste.
"""

from __future__ import annotations

import os

import numpy as np

from sphexa_tpu_torch.init.lattice import jittered_lattice
from sphexa_tpu_torch.sph.kernels import (wharmonic_derivative_np,
                                          wharmonic_np)

_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "sphexa_tpu_torch", "glass")

# user-supplied glass template (reference: the --glass CLI option
# pointing at a pre-relaxed 50^3 block file, sphexa.cpp:82)
_TEMPLATE_OVERRIDE = None   # (x, y, z, side)


def set_glass_template(path: str | None):
    """Install an external glass template for all subsequent tilings.
    Accepts HDF5 (datasets x, y, z, at the root or in Step#0: the
    reference's 50c.h5 layout) or .npz with x/y/z arrays; positions are
    normalized to [0, 1)^3. Pass None to clear."""
    global _TEMPLATE_OVERRIDE
    if path is None:
        _TEMPLATE_OVERRIDE = None
        return
    if path.endswith(".npz"):
        d = np.load(path)
        x, y, z = (np.asarray(d[k], np.float64) for k in ("x", "y", "z"))
    else:
        import h5py
        with h5py.File(path, "r") as f:
            g = f["Step#0"] if "Step#0" in f else f
            x = np.asarray(g["x"], np.float64)
            y = np.asarray(g["y"], np.float64)
            z = np.asarray(g["z"], np.float64)

    def norm(v):
        lo, hi = v.min(), v.max()
        n = round(len(v) ** (1.0 / 3.0))
        span = (hi - lo) * (n + 1.0) / max(n, 1)   # open upper edge
        return (v - lo) / max(span, 1e-30)

    side = round(len(x) ** (1.0 / 3.0))
    if side ** 3 != len(x):
        raise ValueError(f"glass template must be cubic; got N={len(x)}")
    _TEMPLATE_OVERRIDE = (norm(x), norm(y), norm(z), side)


def relax_glass_block(side: int, steps: int = 80, seed: int = 42,
                      jitter: float = 0.35, cache: bool = True,
                      verbose: bool = False):
    """Returns (x, y, z) in [0, 1)^3: an SPH-relaxed glass template.

    Each iteration displaces particles along the kernel-gradient density
    force dx_i ~ sum_j (r_i - r_j)/|r| |dW^6/dv|(|r|/h), normalized to a
    fixed step: the zero-inertia limit of damped SPH dynamics."""
    path = os.path.join(_CACHE_DIR, f"glass_{side}_{seed}_{steps}.npz")
    if cache and os.path.exists(path):
        d = np.load(path)
        return d["x"], d["y"], d["z"]

    from scipy.spatial import cKDTree

    x, y, z = jittered_lattice(side, jitter=jitter, seed=seed)
    pts = np.c_[x, y, z]
    spacing = 1.0 / side
    h = 1.2 * spacing
    step_len = 0.04 * spacing

    for it in range(steps):
        tree = cKDTree(pts, boxsize=1.0)
        pairs = tree.query_pairs(2.0 * h, output_type="ndarray")
        d = pts[pairs[:, 0]] - pts[pairs[:, 1]]
        d -= np.round(d)                       # minimum image
        r = np.linalg.norm(d, axis=1)
        v = np.clip(r / h, 1e-9, 2.0)
        w = -wharmonic_derivative_np(v) * wharmonic_np(v) ** 5  # |dW^6/dv|
        f = (w / np.maximum(r, 1e-9))[:, None] * d
        force = np.zeros_like(pts)
        np.add.at(force, pairs[:, 0], f)
        np.add.at(force, pairs[:, 1], -f)
        fmax = np.abs(force).max() + 1e-30
        pts = np.mod(pts + force * (step_len / fmax), 1.0)
        if verbose and it % 20 == 0:
            print(f"glass relax {it}: |f|max={fmax:.3e}")

    xr, yr, zr = pts[:, 0].copy(), pts[:, 1].copy(), pts[:, 2].copy()
    if cache:
        os.makedirs(_CACHE_DIR, exist_ok=True)
        np.savez(path, x=xr, y=yr, z=zr)
    return xr, yr, zr


def glass_cuboid(lo, hi, spacing: float, template_side: int = 24,
                 seed: int = 42):
    """assembleCuboid analog (reference: main/src/init/grid.hpp:238):
    tile the relaxed periodic glass template over the cuboid [lo, hi)
    at ~`spacing` interparticle distance, the per-dimension multiplicity
    rounded as the reference's. A dimension whose tiles would squeeze
    the template outside [0.7, 1.4] raises ValueError (callers fall back
    to a lattice). Returns float32 (x, y, z)."""
    if _TEMPLATE_OVERRIDE is not None:
        tx, ty, tz, template_side = _TEMPLATE_OVERRIDE
    lo = np.asarray(lo, float)
    ext = np.asarray(hi, float) - lo
    block = template_side * spacing
    reps = np.maximum(1, np.round(ext / block).astype(int))
    bs = ext / reps
    squeeze = bs / block
    if np.any(squeeze < 0.7) or np.any(squeeze > 1.4):
        # a dimension thinner than ~a template block would squeeze the
        # glass anisotropically (ruining the noise spectrum the glass
        # exists to provide)
        raise ValueError(
            f"cuboid {ext} cannot host {template_side}^3 glass blocks at "
            f"spacing {spacing:.4g} (per-dim squeeze {squeeze})")
    if _TEMPLATE_OVERRIDE is None:
        tx, ty, tz = relax_glass_block(template_side, seed=seed)
    out = []
    for i in range(reps[0]):
        for j in range(reps[1]):
            for k in range(reps[2]):
                out.append(np.c_[(tx + i) * bs[0] + lo[0],
                                 (ty + j) * bs[1] + lo[1],
                                 (tz + k) * bs[2] + lo[2]])
    pts = np.concatenate(out)
    return (pts[:, 0].astype(np.float32), pts[:, 1].astype(np.float32),
            pts[:, 2].astype(np.float32))


def density_noise(x, y, z, k: int = 32):
    """Relative scatter of the k-NN-ball density estimate: the quality
    metric of a glass (lower is more uniform)."""
    from scipy.spatial import cKDTree

    pts = np.c_[x, y, z]
    tree = cKDTree(pts, boxsize=1.0)
    d, _ = tree.query(pts, k=k + 1)
    rho_est = k / (4.0 / 3.0 * np.pi * d[:, -1] ** 3)
    return float(rho_est.std() / rho_est.mean())
