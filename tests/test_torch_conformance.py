"""The port's conformance grid against the reference's, cell by cell.

Both runners measure the quick grid at ``n_log = n_man = 256`` on the same
seeded corpora (``eval/ulp.py``, ``eval/consumers.py``), the port on the CPU
(its kernel modes through the kernels' plain versions). This file holds the
recip and div cells; ``test_torch_conformance_consumers.py`` the rsqrt and
consumer cells, so that the reference's grid (~40 s each half here) is split
over two files. What each cell must show is ``expected`` in
``_conformance_common.py``.
"""
import pytest

from _conformance_common import check_cell, grid_keys, reports
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

OPS = ("recip", "div")


@pytest.fixture(scope="module")
def both():
    return reports(OPS)


@pytest.mark.parametrize("key", grid_keys(OPS))
def test_cell_matches_the_reference(both, key):
    check_cell(both, key)
