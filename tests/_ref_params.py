"""The reference's parameters, the same in every test process (ROADMAP F13).

The reference's ``init_params`` folds ``hash(path)`` into each leaf's key
(``src/repro/models/params.py``), and Python salts ``hash`` per process, so
each pytest worker (and each run) would hold the port to the reference on
other random weights. :func:`ref_init` calls it with ``hash`` replaced by the
path's crc32 for the duration of the call; nothing else of the reference
changes. Every ``tests/test_torch_*.py`` that draws the reference's
parameters draws them here.
"""
import zlib
from unittest import mock

import jax

from repro.models import init_params as _init_params
from repro.models import params as _params_module


def ref_init(cfg, seed: int = 0):
    """``repro.models.init_params(cfg, PRNGKey(seed))`` with a stable hash."""
    stable = lambda s: zlib.crc32(s.encode())
    with mock.patch.object(_params_module, "hash", stable, create=True):
        return _init_params(cfg, jax.random.PRNGKey(seed))
