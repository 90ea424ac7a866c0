import pytest

from portbench.tests import _smoke


@pytest.fixture(scope="session")
def smoke_root(tmp_path_factory):
    """A checkout for the smoke runs: this ``BENCHMARK.json`` with the
    waiting cells added, beside this ``portbench/``."""
    return _smoke.checkout(tmp_path_factory.mktemp("checkout"))
