"""The port's tile step against the JAX package's at D = 4 (2 x 2 tiles:
x and z both windowed), on the Sedov frame and with the checks of
tests/test_torch_pallas_tiles.py (its run_tiles, check_diag and
check_rows), in a file of its own so that `--dist loadfile` runs its
interpret-mode JAX program beside that file's.

Sedov 12^3 on the global CMGrid(n=4, cap=64), 2 steps: each band and
each z-range is two cells, so every shard's 4 x 4 x 4 window holds its
cells and the halo cells of either side, one of them through the
wrapped span (a = -1 or b = n + 1 on the periodic axes).
"""

import pytest

from test_torch_pallas_tiles import STEPS, check_diag, check_rows, run_tiles
from torch_threads import two_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def d4():
    return run_tiles(2, 2)


@pytest.mark.parametrize("step", range(STEPS))
def test_d4_diagnostics(d4, step):
    check_diag(d4, step)


@pytest.mark.parametrize("shard", range(4))
def test_d4_shard_rows(d4, shard):
    check_rows(d4, shard)
