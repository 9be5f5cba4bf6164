"""Global coordinate bounding box with periodic / open / fixed boundaries.

Counterpart of sphexa_tpu/sfc/box.py (reference: cstone::Box, putInBox
at box.hpp:210-230). The box is a static, hashable dataclass, so
boundary branches are plain Python `if`s.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch


class Boundary(enum.Enum):
    open = 0
    periodic = 1
    fixed = 2


@dataclasses.dataclass(frozen=True)
class Box:
    xmin: float
    xmax: float
    ymin: float
    ymax: float
    zmin: float
    zmax: float
    bx: Boundary = Boundary.open
    by: Boundary = Boundary.open
    bz: Boundary = Boundary.open

    @staticmethod
    def cube(lo: float, hi: float, boundary: Boundary = Boundary.open) -> "Box":
        return Box(lo, hi, lo, hi, lo, hi, boundary, boundary, boundary)

    @property
    def lx(self) -> float:
        return self.xmax - self.xmin

    @property
    def ly(self) -> float:
        return self.ymax - self.ymin

    @property
    def lz(self) -> float:
        return self.zmax - self.zmin

    @property
    def lengths(self):
        return (self.lx, self.ly, self.lz)

    @property
    def periodic(self):
        return (self.bx == Boundary.periodic,
                self.by == Boundary.periodic,
                self.bz == Boundary.periodic)

    @property
    def any_fixed(self) -> bool:
        return Boundary.fixed in (self.bx, self.by, self.bz)

    def with_bounds(self, xmin, xmax, ymin, ymax, zmin, zmax) -> "Box":
        return dataclasses.replace(self, xmin=xmin, xmax=xmax, ymin=ymin,
                                   ymax=ymax, zmin=zmin, zmax=zmax)


def _wrap(x, lo, length, is_periodic: bool):
    if not is_periodic:
        return x
    return x - length * torch.floor((x - lo) / length)


def fold(r, length, is_periodic: bool):
    """Minimum-image fold of a displacement component."""
    if not is_periodic:
        return r
    return r - length * torch.round(r / length)


def apply_pbc(box: Box, rx, ry, rz):
    """Minimum-image convention for displacement vectors: the reference
    applyPBC (box.hpp:235) for interaction distances < L/2, branch-free."""
    px, py, pz = box.periodic
    return (fold(rx, box.lx, px), fold(ry, box.ly, py),
            fold(rz, box.lz, pz))


def distance_pbc(box: Box, x1, y1, z1, x2, y2, z2):
    """Minimum-image distance between two sets of points."""
    rx, ry, rz = apply_pbc(box, x1 - x2, y1 - y2, z1 - z2)
    return torch.sqrt(rx * rx + ry * ry + rz * rz)


def put_in_box(box: Box, x, y, z):
    """Wrap coordinates back into the box along periodic dimensions."""
    px, py, pz = box.periodic
    return (_wrap(x, box.xmin, box.lx, px),
            _wrap(y, box.ymin, box.ly, py),
            _wrap(z, box.zmin, box.lz, pz))


# the largest float32 below 1: normalized coordinates stay in [0, 1)
_BELOW_ONE = float(np.float32(1.0 - 1e-7))


def normalize_coords(box: Box, x, y, z):
    """Map coordinates to [0, 1)^3."""
    nx = (x - box.xmin) / box.lx
    ny = (y - box.ymin) / box.ly
    nz = (z - box.zmin) / box.lz
    return (torch.clamp(nx, 0.0, _BELOW_ONE), torch.clamp(ny, 0.0, _BELOW_ONE),
            torch.clamp(nz, 0.0, _BELOW_ONE))


def extend_to_coords(box: Box, x, y, z, pad_rel: float = 1e-6) -> Box:
    """The box grown (on the host) to hold the given coordinates along its
    open dimensions, padded by pad_rel of the extent plus float32's
    epsilon: makeGlobalBox (box_mpi.hpp:84) for one process."""
    def pad(c):
        lo, hi = float(torch.min(c)), float(torch.max(c))
        d = (hi - lo) * pad_rel + float(np.finfo(np.float32).eps)
        return lo - d, hi + d

    bx = pad(x) if box.bx == Boundary.open else (box.xmin, box.xmax)
    by = pad(y) if box.by == Boundary.open else (box.ymin, box.ymax)
    bz = pad(z) if box.bz == Boundary.open else (box.zmin, box.zmax)
    return box.with_bounds(bx[0], bx[1], by[0], by[1], bz[0], bz[1])
