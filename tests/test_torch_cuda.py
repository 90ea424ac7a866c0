"""The port's CUDA kernels on the card (marker ``cuda``; skipped without one).

Run on the machine with the card:
    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
This file imports no jax, so it runs where only torch is installed.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import division_modes as dm
from repro_torch.core.seeds import compute_segments, rsqrt_seed_table
from repro_torch.eval import consumers
from repro_torch.core import ilm as ilm_core
from repro_torch.kernels import common, flash_attention, ilm, ops, ref, rmsnorm, softmax, tsdiv
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


@pytest.mark.parametrize("n", [1, 3, 4097, 1 << 16])
def test_rsqrt_kernel_on_odd_lengths_and_misaligned_views(cuda, n):
    """The rsqrt kernel's vector and scalar paths: 0 lanes against the plain
    version on odd lengths and on a view off a 16-byte boundary."""
    x = torch.from_numpy(_bits(n, n + 1)).to(cuda)
    table = rsqrt_seed_table(16)
    for t in (x[:n], x[1:]):
        for it in (1, 2, 3):
            assert _same(tsdiv.rsqrt(t, it, 16), common.rsqrt_f32_bits(t, table, it)), (n, it)


@pytest.mark.parametrize("n", [1, 3, 4097, 1 << 16])
def test_recip_and_divide_kernels_on_odd_lengths_and_misaligned_views(cuda, n):
    """Recip and divide share rsqrt's grid-stride loop: 0 lanes on odd
    lengths, on misaligned views, and with only one divide operand aligned."""
    x = torch.from_numpy(_bits(n, n + 1)).to(cuda)
    a = torch.from_numpy(_bits(n + 7, n + 1)).to(cuda)
    table = compute_segments(2, 24)
    for sched in ("paper", "factored", "goldschmidt"):
        assert _same(tsdiv.recip(x[1:], 2, 24, sched),
                     common.recip_f32_bits(x[1:], table, 2, sched)), (n, sched)
        for num, den in ((a[:n], x[:n]), (a[1:], x[1:]), (a[:n], x[1:])):
            assert _same(tsdiv.divide(num, den, 2, 24, sched),
                         common.divide_f32_bits(num, den, table, 2, sched)), (n, sched)


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


def _qkv(seed, shape, dtype, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device, dtype)
            for _ in range(3)]


FLASH_SHAPES = [(2, 128, 16), (2, 256, 32), (3, 100, 64), (2, 160, 128)]
FLASH_RUNS = ((True, "paper", True), (True, "goldschmidt", False), (False, "factored", True))


FLASH_F32_RUNS = FLASH_RUNS + ((False, "paper", False),)


@pytest.mark.parametrize("bh,s,hd", FLASH_SHAPES + [(2, 72, 32), (1, 1024, 64)])
@pytest.mark.parametrize("block_k", [128, 32, 24])
def test_flash_kernel_matches_plain_version_bit_for_bit(cuda, bh, s, hd, block_k):
    """The f32 kernel (CUDA cores) against its plain version: 0 lanes,
    causal and full, skip on and off, query lengths that are not a multiple
    of the kernel's 64-row tile (100, 72), key blocks of 128, 32 and 24
    keys (24 leaves part of the 16-key slices empty), and k/v off a 16-byte
    boundary (the kernel's 4-byte copies)."""
    q, k, v = _qkv(s + hd, (bh, s, hd), torch.float32, cuda)
    table = compute_segments(2, 24)
    for causal, sched, skip in FLASH_F32_RUNS:
        q3, k3, v3, kw = ops.flash_padded(q, k, v, block_k=block_k)
        got = flash_attention.flash_attention(q3, k3, v3, causal=causal, schedule=sched,
                                              skip_masked_k=skip, **kw)
        want = flash_attention.flash_attention_plain(
            q3, k3, v3, table, 2, sched, causal=causal, skip_masked_k=skip, **kw)
        assert got.dtype == torch.float32 and _same_any(got, want), (causal, sched, skip)
    odd = [torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape).copy_(t) for t in (k3, v3)]
    got = flash_attention.flash_attention(q3, *odd, causal=causal, schedule=sched,
                                          skip_masked_k=skip, **kw)
    assert _same_any(got, want)


@pytest.mark.parametrize("bh,s,hd", FLASH_SHAPES + [(2, 48, 64)])
@pytest.mark.parametrize("block_k", [128, 32, 24])
def test_flash_bf16_kernel_meets_the_gate_against_its_plain_version(cuda, bh, s, hd, block_k):
    """The bf16 kernel (tensor cores) against its plain version: every lane
    within one bf16 ulp + 2^-16 max|v|, >= 99% of lanes bit-identical
    (block_k = 24 pads the key tile with masked zero keys)."""
    q, k, v = _qkv(s + hd, (bh, s, hd), torch.bfloat16, cuda)
    vmax = float(v.float().abs().max())
    for causal, sched, skip in FLASH_RUNS:
        q3, k3, v3, kw = ops.flash_padded(q, k, v, block_k=block_k)
        got = flash_attention.flash_attention(q3, k3, v3, causal=causal, schedule=sched,
                                              skip_masked_k=skip, **kw)
        want = flash_attention.flash_attention_tc_plain(
            q3, k3, v3, compute_segments(2, 24), 2, sched, causal=causal,
            skip_masked_k=skip, **kw)
        gate = flash_attention.tc_gate(got, want, vmax)
        assert got.dtype == torch.bfloat16 and gate["ok"], (causal, sched, skip, gate)


def test_flash_wrapper_counts_pads_and_refuses(cuda):
    """The f32 route: dm.attention at a ragged S pads, launches the CUDA-core
    kernel once and no tensor-core kernel; float16 has no kernel and raises."""
    flash_attention.reset_launches()
    q, k, v = _qkv(0, (2, 3, 100, 32), torch.float32, cuda)
    o = dm.attention(q, k, v, dm.DivisionConfig(mode="taylor_pallas"))
    dm.attention(q, k, v, dm.EXACT)
    assert o.shape == q.shape and flash_attention.LAUNCHES == {
        "flash_attention_f32": 1, "flash_attention_bf16": 0}
    e = dm.attention(q, k, v, dm.EXACT)
    assert float((o - e).abs().max()) <= 5e-6
    with pytest.raises(ValueError):          # a head size the kernel lacks
        dm.attention(q[..., :8], k[..., :8], v[..., :8], dm.DivisionConfig(mode="taylor_pallas"))
    with pytest.raises(TypeError):
        dm.attention(q.half(), k.half(), v.half(), dm.DivisionConfig(mode="taylor_pallas"))
    assert flash_attention.LAUNCHES == {"flash_attention_f32": 1, "flash_attention_bf16": 0}


def test_flash_bf16_kernel_counts_and_refuses(cuda):
    flash_attention.reset_launches()
    q, k, v = _qkv(1, (2, 3, 100, 64), torch.bfloat16, cuda)
    o = dm.attention(q, k, v, dm.DivisionConfig(mode="taylor_pallas"))
    assert flash_attention.LAUNCHES == {"flash_attention_f32": 0, "flash_attention_bf16": 1}
    e = ref.flash_attention_exact(*(t.reshape(6, 100, 64) for t in (q, k, v)))
    assert float((o.reshape(6, 100, 64).float() - e.float()).abs().max()) <= 0.04
    q3, k3, v3, kw = ops.flash_padded(q, k, v)
    with pytest.raises(ValueError):          # a head size the kernel lacks
        flash_attention.flash_attention(q3[..., :48].contiguous(), k3[..., :48].contiguous(),
                                        v3[..., :48].contiguous())
    with pytest.raises(ValueError):          # block_k above 128
        flash_attention.flash_attention(*(t.repeat(1, 3, 1) for t in (q3, k3, v3)), block_k=300)
    with pytest.raises(ValueError):          # mixed dtypes
        flash_attention.flash_attention(q3, k3.float(), v3)
    with pytest.raises(ValueError):          # k/v off a 16-byte boundary
        kk = torch.empty(k3.numel() + 1, dtype=k3.dtype, device=cuda)[1:].view(k3.shape)
        flash_attention.flash_attention(q3, kk.copy_(k3), v3)
    assert flash_attention.LAUNCHES == {"flash_attention_f32": 0, "flash_attention_bf16": 1}


@pytest.mark.parametrize("mode", ["exact", "taylor", "taylor_pallas", "goldschmidt",
                                  "goldschmidt_pallas", "ilm"])
def test_attention_every_mode_on_the_card(cuda, mode):
    q, k, v = _qkv(7, (2, 64, 32), torch.float32, cuda)
    for causal in (True, False):
        o = dm.attention(q, k, v, dm.DivisionConfig(mode=mode), causal=causal)
        e = dm.attention(q, k, v, dm.EXACT, causal=causal)
        dev = float((o - e).abs().max())
        assert bool(torch.isfinite(o).all())
        assert (1e-8 < dev < 1e-2) if mode == "ilm" else dev <= 1e-5, (mode, causal, dev)


def test_ilm_kernels_match_plain_versions_bit_for_bit(cuda):
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2**16, 1 << 16).astype(np.uint32)
    b = rng.integers(0, 2**16, 1 << 16).astype(np.uint32)
    a[:4], b[:4] = [0, 1, 65535, 65535], [7, 0, 65535, 1]
    at, bt = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    for iters in (1, 2, 3, 8, 16):
        assert _same_any(ilm.ilm_mul(at, bt, iters), ilm.ilm_mul_plain(at, bt, iters)), iters
        assert _same_any(ilm.ilm_square(at, iters), ilm.ilm_square_plain(at, iters)), iters
    bound = ilm_core.exact_iters_bound(16)
    assert _same_any(ilm.ilm_mul(at, bt, bound), ref.ilm_mul_exact(at, bt))
    assert _same_any(ilm.ilm_square(at, bound), ref.ilm_square_exact(at))


def test_ilm_wrappers_count_and_refuse(cuda):
    ilm.reset_launches()
    a = torch.arange(1000, device=cuda)
    ops.ilm_mul(a, a, iters=4)
    ops.ilm_square(a, iters=4)
    dm.recip(torch.ones(10, device=cuda), dm.DivisionConfig(mode="ilm"))   # core ILM, no kernel
    assert ilm.LAUNCHES == {"ilm_mul_u32": 1, "ilm_square_u32": 1}
    with pytest.raises(TypeError):
        ilm.ilm_mul(a, a, 4)                 # int64: the kernel takes uint32


@pytest.mark.parametrize("n", [1, 3, 4097, 1 << 16])
def test_ilm_square_kernel_over_all_of_uint32_every_iters(cuda, n):
    """The squarer's closed form against the stage loop of its plain
    version: 0 lanes at iters 1-32 on operands over all of uint32 (wrap
    included), on odd lengths and on a view off a 16-byte boundary."""
    rng = np.random.default_rng(n)
    a = rng.integers(0, 2**32, n + 1, dtype=np.uint64).astype(np.uint32)
    edges = [0, 1, 2**16 - 1, 2**32 - 1, 0xFFFF0000]
    a[:len(edges)] = edges[:n + 1]
    at = torch.from_numpy(a).to(cuda)
    for t in (at[:n], at[1:]):
        for iters in range(1, 33):
            assert _same_any(ilm.ilm_square(t, iters), ilm.ilm_square_plain(t, iters)), (n, iters)


@pytest.mark.parametrize("n", [1, 3, 4097, 1 << 16])
def test_ilm_mul_kernel_over_all_of_uint32_every_iters(cuda, n):
    """The multiplier's closed form against the stage loop of its plain
    version: 0 lanes at iters 1-32 on operand pairs over all of uint32
    (wrap included; the edges 0, 1, 2^16 - 1, 2^32 - 1 and 0xFFFF0000 in
    every pairing), on odd lengths and on views off a 16-byte boundary."""
    rng = np.random.default_rng(n + 7)
    a, b = (rng.integers(0, 2**32, n + 26, dtype=np.uint64).astype(np.uint32) for _ in range(2))
    edges = np.array([0, 1, 2**16 - 1, 2**32 - 1, 0xFFFF0000], np.uint32)
    a[:25], b[:25] = np.repeat(edges, 5), np.tile(edges, 5)
    at, bt = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    for x, y in ((at[:n], bt[:n]), (at[1:n + 1], bt[1:n + 1]), (at[:n], bt[1:n + 1])):
        for iters in range(1, 33):
            assert _same_any(ilm.ilm_mul(x, y, iters), ilm.ilm_mul_plain(x, y, iters)), (n, iters)
    lanes = ilm_core.as_u32_lanes       # at iters 32 every pair is x*y mod 2^32
    assert torch.equal(lanes(ilm.ilm_mul(at, bt, 32)), lanes(at) * lanes(bt) & ilm_core.U32)


SOFTMAX_DIMS = [1, 100, 768, 1800, 2048, 2112, 2176, 3000, 8192, 8200]


def _softmax_rows(m, d, seed):
    """Seeded logits of scale 4; past the first row, one with a +inf logit,
    an all-negative one, one with a nan, one all -inf (as m allows)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 4, (m, d))
    for i, row in enumerate((np.where(np.arange(d) == d // 3, np.inf, x[0]),
                             -np.abs(x[0]) - 200.0,
                             np.where(np.arange(d) == d // 2, np.nan, x[0]),
                             np.full(d, -np.inf)), start=1):
        if i < m:
            x[i] = row
    return x.astype(np.float32)


@pytest.mark.parametrize("d", SOFTMAX_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_kernel_matches_plain_version_bit_for_bit(cuda, d, dtype):
    """The kernel against its plain version: 0 lanes for every row length
    and row count m = 1, 7, 96, 1000, 2000, which between them take every
    path (one warp holding up to 9 chunks; 8 warps holding 2 to 9 chunks,
    or 10 to 32, where rows are few; one warp reading a longer row three
    times), f32 and bf16, the three schedules, the corpus with its edge
    rows, rows with +inf, nan, all-negative and all -inf logits, and a view
    at an odd storage offset (the scalar path)."""
    table = compute_segments(2, 24)
    corpus = np.concatenate([*consumers.softmax_rows("float32", 8, d, 1).values(),
                             consumers.softmax_edge_rows("float32", d), _softmax_rows(5, d, 3)])
    cases = [torch.from_numpy(corpus).to(cuda, dtype)]
    for m in (1, 7, 96, 1000, 2000):
        x = torch.from_numpy(_softmax_rows(m, d, d + m)).to(cuda, dtype)
        odd = torch.empty(m * d + 1, device=cuda, dtype=dtype)[1:].view(m, d)
        odd.copy_(x)
        cases += [x, odd]
    for x in cases:
        for sched in ("paper", "factored", "goldschmidt"):
            got = softmax.softmax(x, 2, 24, sched)
            assert got.dtype == dtype and _same_any(got, softmax.softmax_plain(x, table, 2, sched))


def test_softmax_launches_once_and_copies_nothing(cuda):
    """One softmax_f32 launch per call and no other work on the card."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(96, 2112, device=cuda)
    cfg = dm.DivisionConfig(mode="taylor_pallas")
    dm.softmax(x, -1, cfg)
    torch.cuda.synchronize()
    softmax.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dm.softmax(x, -1, cfg)
        torch.cuda.synchronize()
    assert softmax.LAUNCHES == {"softmax_f32": 1}
    names = [e.key for e in prof.key_averages()]
    assert not [k for k in names if k in ("aten::to", "aten::_to_copy", "aten::copy_")], names
    device = [e.key for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    assert len(device) == 1 and "softmax_kernel" in device[0], device
    assert [e.count for e in prof.key_averages() if e.key == device[0]] == [1]


RMS_DIMS = [1, 100, 128, 300, 768, 2048, 2176, 8192]


def _rms_rows(m, d, seed):
    """Seeded rows of unit scale, a row of inf and one of nan (m >= 3)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (m, d)).astype(np.float32)
    x[1, d // 2] = np.inf
    x[2, 0] = np.nan
    return x


@pytest.mark.parametrize("d", RMS_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain_version_bit_for_bit(cuda, d, dtype, w_dtype):
    """The warp-per-row kernel against its plain version: 0 lanes for every
    row length (held in registers or read twice, vector or scalar path),
    x and w in f32 and bf16, m = 1 and m = 13 (not a multiple of the rows a
    block takes), rows of inf and nan, and a view at an odd storage offset."""
    table = rsqrt_seed_table(16)
    w = torch.from_numpy(consumers.rmsnorm_weight(d, 2)).to(cuda, w_dtype)
    for m in (1, 13):
        x = torch.from_numpy(_rms_rows(max(m, 3), d, d + m)[:m].copy()).to(cuda, dtype)
        odd = torch.empty(m * d + 1, device=cuda, dtype=dtype)[1:].view(m, d)
        odd.copy_(x)
        for t in (x, odd):
            got = rmsnorm.rmsnorm(t, w)
            assert got.dtype == dtype and _same_any(got, rmsnorm.rmsnorm_plain(t, w, 1e-6, table, 2))
    assert _same_any(rmsnorm.rmsnorm(x, w, 1e-5, 3, 8),
                     rmsnorm.rmsnorm_plain(x, w, 1e-5, rsqrt_seed_table(8), 3))


def test_rmsnorm_launches_once_and_casts_nothing(cuda):
    """One rmsnorm_f32 launch per call and no other work on the card: the
    bf16 weight is read as it is, not cast first."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(64, 768, device=cuda).to(torch.bfloat16)
    w = torch.randn(768, device=cuda).to(torch.bfloat16)
    cfg = dm.DivisionConfig(mode="taylor_pallas")
    dm.rmsnorm(x, w, cfg)
    torch.cuda.synchronize()
    rmsnorm.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rmsnorm.rmsnorm(x, w)
        dm.rmsnorm(x, w, cfg)
        torch.cuda.synchronize()
    assert rmsnorm.LAUNCHES == {"rmsnorm_f32": 2}
    names = [e.key for e in prof.key_averages()]
    assert not [k for k in names if k in ("aten::to", "aten::_to_copy", "aten::copy_")], names
    device = [e.key for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    assert device and all("rmsnorm_kernel" in k for k in device), device
    with pytest.raises(TypeError):
        rmsnorm.rmsnorm(x, w.half())
    with pytest.raises(TypeError):
        rmsnorm.rmsnorm(x, torch.randn(2 * 768, device=cuda)[::2])   # not contiguous
    assert rmsnorm.LAUNCHES == {"rmsnorm_f32": 2}


@pytest.mark.parametrize("mode", ["taylor_pallas", "goldschmidt_pallas"])
def test_rmsnorm_modes_cast_a_weight_the_kernel_does_not_take(cuda, mode):
    """dm.rmsnorm with a float16 or a strided f32 weight: one launch each,
    the plain version's bits (which read the weight as f32), as the
    reference's kernel casts its weight."""
    table = rsqrt_seed_table(16)
    cfg = dm.DivisionConfig(mode=mode)
    x = torch.from_numpy(_rms_rows(13, 768, 5)).to(cuda)
    w32 = torch.from_numpy(consumers.rmsnorm_weight(768, 2)).to(cuda)
    for w in (w32.half(), w32.repeat_interleave(2)[::2]):
        rmsnorm.reset_launches()
        got = dm.rmsnorm(x, w, cfg)
        assert rmsnorm.LAUNCHES == {"rmsnorm_f32": 1}
        assert _same_any(got, rmsnorm.rmsnorm_plain(x, w, 1e-6, table, cfg.rsqrt_newton))


# ----------------------------------------------------------- training (slice 10)

def test_adamw_kernel_mode_matches_its_plain_version(cuda):
    """AdamW in taylor_pallas on the card: one tsdiv_recip launch per leaf,
    and new params, m and v equal to the plain version's (the same update on
    the CPU) bit for bit; unclipped, so no reduction order enters."""
    from repro_torch import tree
    from repro_torch.optim import adamw

    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(257, 33, generator=gen).to(torch.bfloat16),
              "n": torch.randn(33, generator=gen),
              "layers": [{"e": torch.randn(5, 7, 9, generator=gen)}]}
    grads = tree.map_tree(lambda p: torch.randn(p.shape, generator=gen)
                          * 10.0 ** torch.empty(p.shape).uniform_(-9, 1, generator=gen), params)
    cfg = adamw.AdamWConfig(grad_clip=1e9, state_dtype="bfloat16",
                            division=dm.DivisionConfig(mode="taylor_pallas", schedule="paper"))
    outs = {}
    for dev in ("cpu", cuda):
        p = tree.map_tree(lambda t: t.to(dev), params)
        g = tree.map_tree(lambda t: t.to(dev), grads)
        state = adamw.init(p, cfg)
        tsdiv.reset_launches()
        for _ in range(3):
            p, state = adamw.update(g, state, p, cfg)
        torch.cuda.synchronize()
        outs[str(dev)] = (tree.leaves(p) + tree.leaves(state), dict(tsdiv.LAUNCHES))
    (want, none), (got, counted) = outs["cpu"], outs[str(cuda)]
    assert none["tsdiv_recip"] == 0 and counted["tsdiv_recip"] == 3 * 3
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


def test_training_resumes_bit_for_bit_on_the_card(cuda, tmp_path):
    """The embedding gather's backward (index_put_ with accumulate, sorted
    on CUDA) repeats its bits; so a killed and resumed run on the card ends
    on an uninterrupted run's parameters exactly."""
    from repro_torch import tree
    from repro_torch.data import DataConfig
    from repro_torch.train import fault
    from repro_torch.train.loop import LoopConfig, run

    embed = torch.randn(512, 64, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    toks = torch.randint(0, 8, (16, 2048), device=cuda)       # many repeats per row
    g = torch.randn(16, 2048, 64, device=cuda, dtype=torch.bfloat16)
    grads = [torch.autograd.grad(embed[toks], embed, g)[0] for _ in range(3)]
    assert all(torch.equal(grads[0], x) for x in grads[1:])

    cfg = dataclasses.replace(get_smoke_config("paper_fpdiv"),
                              division=dm.DivisionConfig(mode="taylor_pallas", schedule="paper"))
    dc = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8, seed=1)
    lc = lambda d: LoopConfig(total_steps=8, ckpt_every=3, ckpt_dir=str(tmp_path / d))
    with pytest.raises(fault.FailureInjector.Injected):
        run(cfg, lc("cut"), dc, injector=fault.FailureInjector(5), log=lambda s: None)
    resumed = run(cfg, lc("cut"), dc, log=lambda s: None)
    straight = run(cfg, lc("straight"), dc, log=lambda s: None)
    assert resumed["losses"] == straight["losses"][3:]
    for a, b in zip(tree.leaves(resumed["state"]), tree.leaves(straight["state"])):
        assert a.device.type == "cuda" and torch.equal(a, b)


@pytest.mark.parametrize("shape", [(1992, 300), (8, 36, 130)])
def test_mesh_dispatch_on_two_ranks_sharing_the_card(cuda, shape):
    """2 gloo ranks on the one card: each tiled op launches once a rank on
    its block with no collective, the bits are the unsharded launch's and
    the plain version's, and the gradients are the unsharded ones."""
    import _torch_mesh
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import run_ranks

    _build.build_all()           # before the ranks load the libraries
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 3.0)
    b = torch.from_numpy(rng.uniform(0.1, 10.0, size=shape).astype(np.float32))
    outs = run_ranks(_torch_mesh.cuda_dispatch_rank, 2, a, b, device_type="cuda",
                     timeout_s=300.0)
    assert outs[0]["pid"] != outs[1]["pid"]
    for out in outs:
        assert out["launches"] == {"tsdiv_recip": 1, "tsdiv_divide": 1, "tsdiv_rsqrt": 1}
        assert out["collectives"] == 0 and out["placements_kept"]
        assert all(out["same_bits"].values()) and all(out["same_grads"].values())
        assert all(out["plain_bits"].values())
