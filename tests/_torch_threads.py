"""One intra-op torch thread for a test module's CPU work.

The suite runs several pytest workers on the host's cores, and each torch
process's own intra-op pool then oversubscribes them: under the suite's
``-n 6 --dist loadfile`` on eight cores, test_torch_attention.py took 1114
s of worker time with torch's default pool and 44 s on one thread. A test
module imports ``one_torch_thread`` to run its tests on one thread; the
count is restored after the module.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
