"""Plain-text column dumps (reference: main/src/io/ifile_io_ascii.cpp).

Counterpart of sphexa_tpu/io/ascii.py, byte for byte: the same step,
box and column-name headers and the same "%.9g" rows, so each package
reads the other's dumps."""

from __future__ import annotations

import numpy as np
import torch

from sphexa_tpu_torch.util.device import host

_COLUMNS = ("x", "y", "z", "vx", "vy", "vz", "h", "temp", "m")


class AsciiWriter:
    def __init__(self, path: str):
        self.path = path

    def write_step(self, state, cfg, box, fields=None, turb_state=None,
                   bdt_state=None):
        ps = state.p
        alive = host(ps.alive)
        cols = {n: host(getattr(ps, n))[alive] for n in _COLUMNS}
        cols.update({k: host(v)[alive] for k, v in (fields or {}).items()})
        names = list(cols)
        data = np.column_stack([cols[n] for n in names])
        with open(self.path, "a") as f:
            f.write("# step iteration=%d time=%.9g\n"
                    % (int(state.iteration), float(state.ttot)))
            f.write("# box %.9g %.9g %.9g %.9g %.9g %.9g %d %d %d\n"
                    % (box.xmin, box.xmax, box.ymin, box.ymax,
                       box.zmin, box.zmax, box.bx.value, box.by.value,
                       box.bz.value))
            f.write("# %s\n" % " ".join(names))
            np.savetxt(f, data, fmt="%.9g")

    def close(self):
        pass


class AsciiReader:
    """Reader for AsciiWriter dumps. Each step block is
    `# step iteration=I time=T`, an optional `# box ...` line, a
    `# <names>` header, then one row per particle."""

    def __init__(self, path: str):
        self.path = path
        self._steps = []     # (iteration, time, names, row-start, row-end, box)
        with open(path) as f:
            lines = f.readlines()
        i = 0
        while i < len(lines):
            ln = lines[i]
            if ln.startswith("# step "):
                kv = dict(tok.split("=") for tok in ln[7:].split())
                boxvals = None
                if lines[i + 1].startswith("# box "):
                    boxvals = [float(v) for v in lines[i + 1][6:].split()]
                    i += 1
                names = lines[i + 1].lstrip("# ").split()
                j = i + 2
                while j < len(lines) and not lines[j].startswith("#"):
                    j += 1
                self._steps.append((int(kv["iteration"]),
                                    float(kv["time"]), names, i + 2, j,
                                    boxvals))
                i = j
            else:
                i += 1
        self._lines = lines

    def num_steps(self) -> int:
        return len(self._steps)

    def read_step(self, idx: int = -1):
        it, t, names, lo, hi, boxvals = self._steps[idx]
        data = np.loadtxt(self._lines[lo:hi], ndmin=2)
        fields = {n: data[:, k].astype(np.float32)
                  for k, n in enumerate(names)}
        attrs = {"iteration": it, "time": t}
        if boxvals is not None:
            attrs["box"] = boxvals[:6]
            attrs["boundary"] = [int(v) for v in boxvals[6:9]]
        return fields, attrs


def load_ascii_checkpoint(path: str, cfg, step: int = -1,
                          dt0: float | None = None, device=None):
    """Rebuild a SimState on `device` (default: the GPU) from an ASCII
    dump. The columns carry no Press-2 history (_m1) and no dt, so the
    integrator history restarts: x_m1 = v dt (the reference's
    scripts/add_m1.py workflow; zero _m1 would zero the velocities).
    Returns (state, box or None for a dump without a box header)."""
    from sphexa_tpu_torch.sfc.box import Boundary, Box
    from sphexa_tpu_torch.state import make_particles, make_state

    fields, attrs = AsciiReader(path).read_step(step)
    n = len(fields["x"])
    kw = {k: v for k, v in fields.items() if k in _COLUMNS}
    kw.setdefault("m", np.full(n, 1.0 / n, np.float32))
    dt = np.float32(dt0 or 1e-6)
    for a in ("x", "y", "z"):
        kw[f"{a}_m1"] = np.asarray(kw.get(f"v{a}", np.zeros(n)),
                                   np.float32) * dt
    ps = make_particles(n, n, device=device,
                        alpha=np.full(n, cfg.alphamin, np.float32), **kw)
    state = make_state(ps, dt0=float(dt), ttot=attrs["time"])
    state = state.replace(iteration=torch.tensor(
        attrs["iteration"], dtype=torch.int32, device=ps.device))
    box = None
    if "box" in attrs:
        b = attrs["box"]
        bd = [Boundary(v) for v in attrs["boundary"]]
        box = Box(b[0], b[1], b[2], b[3], b[4], b[5], *bd)
    return state, box
