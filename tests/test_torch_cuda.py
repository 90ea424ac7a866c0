"""The port's CUDA kernels on the card (marker ``cuda``; skipped without one).

Run on the machine with the card:
    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
This file imports no jax, so it runs where only torch is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import division_modes as dm
from repro_torch.core.seeds import compute_segments, rsqrt_seed_table
from repro_torch.kernels import common, ops, tsdiv
from repro_torch.workloads import kmeans

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _bits(seed, n=1 << 16):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.float32)


def _same(got, want):
    eq = (got.view(torch.int32) == want.view(torch.int32)) | (got.isnan() & want.isnan())
    return bool(eq.all())


@pytest.mark.parametrize("schedule", ["paper", "factored", "goldschmidt"])
def test_kernels_match_plain_versions_bit_for_bit(cuda, schedule):
    x = torch.from_numpy(_bits(1)).to(cuda)
    a = torch.from_numpy(_bits(2)).to(cuda)
    table = compute_segments(2, 24)
    assert _same(tsdiv.recip(x, 2, 24, schedule),
                 common.recip_f32_bits(x, table, 2, schedule))
    assert _same(tsdiv.divide(a, x, 2, 24, schedule),
                 common.divide_f32_bits(a, x, table, 2, schedule))
    assert _same(tsdiv.rsqrt(x, 2, 16),
                 common.rsqrt_f32_bits(x, rsqrt_seed_table(16), 2))


def test_each_wrapper_counts_its_launches(cuda):
    tsdiv.reset_launches()
    x = torch.ones(1000, device=cuda)
    ops.tsdiv_divide(x, x)
    ops.tsdiv_recip(x)
    ops.tsdiv_rsqrt(x)
    ops.tsdiv_recip(torch.ones(0, device=cuda))   # nothing to launch
    assert tsdiv.LAUNCHES == {"tsdiv_recip": 1, "tsdiv_divide": 1, "tsdiv_rsqrt": 1}


def test_kernel_mode_on_a_cuda_tensor_without_a_kernel_dtype_raises(cuda):
    with pytest.raises(TypeError):
        dm.recip(torch.ones(4, device=cuda, dtype=torch.float16),
                 dm.DivisionConfig(mode="taylor_pallas"))


def test_kmeans_divides_through_the_kernel(cuda):
    x = kmeans.make_blobs(torch.Generator().manual_seed(0), 4096, 8, 4)
    tsdiv.reset_launches()
    res = kmeans.kmeans(x, 4, n_iters=5, device=cuda,
                        cfg=dm.DivisionConfig(mode="taylor_pallas"))
    assert tsdiv.LAUNCHES["tsdiv_divide"] == 3 * 5 + 2
    assert res.centroids.is_cuda and torch.isfinite(res.centroids).all()
