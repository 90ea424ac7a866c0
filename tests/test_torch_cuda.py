"""The port's CUDA kernels on the card (marker ``cuda``; skipped without one).

Run on the machine with the card:
    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
This file imports no jax, so it runs where only torch is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import division_modes as dm
from repro_torch.core.seeds import compute_segments, rsqrt_seed_table
from repro_torch.eval import consumers
from repro_torch.kernels import common, ops, rmsnorm, softmax, tsdiv
from repro_torch.models import init_params
from repro_torch.serving import ServingEngine
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [128, 768, 2176])
def test_consumer_kernels_match_plain_versions_bit_for_bit(cuda, dtype, d):
    x = np.concatenate([*consumers.softmax_rows("float32", 16, d, 1).values(),
                        consumers.softmax_edge_rows("float32", d)])
    xt = torch.from_numpy(x).to(cuda, dtype)
    for sched in ("paper", "factored", "goldschmidt"):
        got = softmax.softmax(xt, 2, 24, sched)
        want = softmax.softmax_plain(xt, compute_segments(2, 24), 2, sched)
        assert got.dtype == dtype and _same_any(got, want)
    r = np.concatenate([*consumers.rmsnorm_rows("float32", 16, d, 1).values()])
    rt = torch.from_numpy(r).to(cuda, dtype)
    w = torch.from_numpy(consumers.rmsnorm_weight(d, 1)).to(cuda)
    assert _same_any(rmsnorm.rmsnorm(rt, w), rmsnorm.rmsnorm_plain(rt, w, 1e-6,
                                                                    rsqrt_seed_table(16), 2))


def _same_any(got, want):
    ints = torch.int32 if got.element_size() == 4 else torch.int16
    eq = (got.view(ints) == want.view(ints)) | (got.isnan() & want.isnan())
    return bool(eq.all())


def test_consumer_wrappers_count_and_refuse(cuda):
    softmax.reset_launches()
    rmsnorm.reset_launches()
    x = torch.randn(3, 5, 40, device=cuda)
    dm.softmax(x, 1, dm.DivisionConfig(mode="taylor_pallas"))
    dm.rmsnorm(x, torch.ones(40, device=cuda), dm.DivisionConfig(mode="goldschmidt_pallas"))
    dm.softmax(x, -1, dm.EXACT)
    assert softmax.LAUNCHES == {"softmax_f32": 1} and rmsnorm.LAUNCHES == {"rmsnorm_f32": 1}
    with pytest.raises(TypeError):
        dm.softmax(x.half(), -1, dm.DivisionConfig(mode="taylor_pallas"))
    with pytest.raises(TypeError):
        softmax.softmax(x)                      # 3-D: the wrapper takes rows


def test_serving_smoke_model_on_the_card(cuda):
    cfg = get_smoke_config("paper_fpdiv")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    eng = ServingEngine(cfg, params, max_len=64,
                        division=dm.DivisionConfig(mode="taylor_pallas", schedule="paper"))
    softmax.reset_launches()
    rmsnorm.reset_launches()
    out = eng.generate_batch([list(range(1, 12)), list(range(3, 25))], max_new=4)
    assert [len(o) for o in out] == [4, 4]
    forwards = 1 + 4
    assert softmax.LAUNCHES["softmax_f32"] == cfg.n_layers * forwards
    assert rmsnorm.LAUNCHES["rmsnorm_f32"] == (2 * cfg.n_layers + 1) * forwards
