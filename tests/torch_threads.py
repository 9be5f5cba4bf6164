"""The torch thread counts of the port's test modules, as autouse
module fixtures; a test module takes one by importing it by name:

    from torch_threads import one_torch_thread  # noqa: F401

The tier-1 run puts six test processes on the host's cores, and torch's
default of a thread a core oversubscribes them: a module's own run
slowed many times under that load. With several intra-op threads,
PyTorch's CPU backend here has also been seen to compute a whole
32768-element chunk of an elementwise op's first use in a process from
stale data (about 1 process in 7 at 8 threads, none in 40 at 1), which
moves a stage's output by ~1e-4 of its scale at random rows. The
modules whose own work is large and threads well take two.
"""

import pytest
import torch


def _threads(k: int):
    n = torch.get_num_threads()
    torch.set_num_threads(k)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    yield from _threads(1)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    yield from _threads(2)
