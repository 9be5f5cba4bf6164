"""The cases of tests/test_torch_mm_schedule.py on its cap-128 frame
(Sedov 10^3 on CMGrid(n=4, cap=128)): K10's 3xTF32 and bf16 schedules
and K8's per-lane order against the JAX bodies in interpret mode and
the port's plain versions, with that file's checks and tolerances. A
file of its own, so that a run spread over workers by file builds each
frame and its JAX bodies on its own worker.
"""

import pytest

import test_torch_mm_schedule as ms
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("frame", ["cap128"])
def test_k10_schedule_float32(frame):
    """check_k10_float32 on the cap-128 frame."""
    ms.check_k10_float32(frame)


@pytest.mark.parametrize("frame", ["cap128"])
def test_k10_schedule_bf16(frame):
    """check_k10_bf16 on the cap-128 frame."""
    ms.check_k10_bf16(frame)


@pytest.mark.parametrize("frame", ["cap128"])
def test_k8_schedule(frame):
    """check_k8 on the cap-128 frame."""
    ms.check_k8(frame)
