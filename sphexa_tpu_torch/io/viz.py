"""In-situ visualization hook
(reference: main/src/{insitu_viz.h,ascent_adaptor.h,catalyst_adaptor.h}:
optional per-step render callbacks).

Counterpart of sphexa_tpu/io/viz.py: renders a midplane slice and a
radial profile to PNG every N iterations with matplotlib's Agg backend
(no display needed), the fields copied to the host. matplotlib is
imported at the first render; without it the hook returns None, as the
reference adaptors are optional."""

from __future__ import annotations

import numpy as np

from sphexa_tpu_torch.util.device import host


class VizHook:
    def __init__(self, out_prefix: str = "viz", every: int = 10,
                 field: str = "temp"):
        self.out_prefix = out_prefix
        self.every = every
        self.field = field

    def execute(self, state, box, iteration: int, extra_fields=None):
        """The PNG's path, or None (not a render iteration, or no
        matplotlib)."""
        if iteration % self.every:
            return None
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:  # viz is optional, like the reference adaptors
            return None

        ps = state.p
        alive = host(ps.alive)
        x = host(ps.x)[alive]
        y = host(ps.y)[alive]
        z = host(ps.z)[alive]
        if extra_fields and self.field in extra_fields:
            v = host(extra_fields[self.field])[alive]
        else:
            v = host(getattr(ps, self.field))[alive]

        zmid = 0.5 * (box.zmin + box.zmax)
        dz = 0.05 * (box.zmax - box.zmin)
        sl = np.abs(z - zmid) < dz

        fig, (a1, a2) = plt.subplots(1, 2, figsize=(10, 4.2))
        sc = a1.scatter(x[sl], y[sl], c=v[sl], s=2, cmap="inferno")
        a1.set_title(f"{self.field} midplane, iter {iteration}")
        a1.set_aspect("equal")
        fig.colorbar(sc, ax=a1)

        r = np.sqrt(x ** 2 + y ** 2 + z ** 2)
        a2.plot(r, v, ".", ms=1, alpha=0.3)
        a2.set_xlabel("r")
        a2.set_ylabel(self.field)
        a2.set_title("radial profile")
        path = f"{self.out_prefix}_{iteration:06d}.png"
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return path
