"""The tensor-core flash kernel's plain version, and the division unit's
two rewritten steps (seed select, error-free product), against the
reference.

The bf16 route of flash attention runs on the tensor cores on the card
(``csrc/flash_attention_tc.cu``); here its plain version
(``flash_attention_tc_plain``) meets the reference's Pallas kernel (interpret
mode, as its own tests run it) on the reference's bf16 cases within the
kernel gate's per-lane bound: one bf16 ulp plus 2^-16 max|v|. XLA's exp and
sum order differ from the port's (ROADMAP F3, F6), and p is split into two
bf16 halves, so the identical-lane share is not asked of this pair. The
seed's binary search must select the ladder's segment for every mantissa of
every table the port builds, and the fma error term must equal the Dekker
split's on every operand pair the bodies can give it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.core import fpparts
from repro_torch.core.seeds import compute_segments, rsqrt_seed_table
from repro_torch.kernels import common, flash_attention, ops, ref, tsdiv
from test_torch_attention import CASES, RAGGED, _attention_f64
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TABLES = {f"recip/n{n}p{p}": compute_segments(n, p) for n, p in ((2, 24), (1, 12))}
TABLES.update({f"rsqrt/{n}": rsqrt_seed_table(n) for n in (8, 16)})
DOMAIN = {"recip": (1.0, 2.0), "rsqrt": (0.5, 2.0)}


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _bf16(*arrays):
    """torch bf16 tensors, and the same values as f32 numpy arrays."""
    ts = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    return ts, [t.float().numpy() for t in ts]


@pytest.mark.parametrize("bh,s,hd,bq,bk,causal", CASES + RAGGED)
def test_bf16_plain_version_vs_reference_and_oracle(bh, s, hd, bq, bk, causal):
    (qt, kt, vt), (q, k, v) = _bf16(*_qkv(s + hd + 1, (bh, s, hd)))
    got = ops.flash_attention(qt, kt, vt, causal, bq, bk)
    assert got.dtype == torch.bfloat16 and got.shape == (bh, s, hd)
    want = ref_ops.flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                   causal=causal, block_q=bq, block_k=bk)
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).to(torch.bfloat16)
    bound = flash_attention.bf16_ulp(want) + flash_attention.TC_FLOOR * float(np.abs(v).max())
    excess = ((got.float() - want.float()).abs() - bound).max()
    assert float(excess) <= 0, float(excess)
    np.testing.assert_allclose(got.float().numpy(), _attention_f64(q, k, v, causal), atol=0.04, rtol=0)


def test_bf16_routes_to_the_tensor_core_plain_version(monkeypatch):
    assert flash_attention.kernel_for(torch.bfloat16) == "flash_attention_bf16"
    assert flash_attention.kernel_for(torch.float32) == "flash_attention_f32"
    assert flash_attention.PLAIN == {
        "flash_attention_f32": flash_attention.flash_attention_plain,
        "flash_attention_bf16": flash_attention.flash_attention_tc_plain}
    calls = []
    for name in list(flash_attention.PLAIN):
        real = flash_attention.PLAIN[name]
        monkeypatch.setitem(flash_attention.PLAIN, name,
                            lambda *a, _n=name, _f=real, **kw: calls.append(_n) or _f(*a, **kw))
    q = torch.randn(2, 32, 16)
    flash_attention.flash_attention(q, q, q)
    flash_attention.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16())
    assert calls == ["flash_attention_f32", "flash_attention_bf16"]
    assert flash_attention.LAUNCHES == {"flash_attention_f32": 0, "flash_attention_bf16": 0}


def test_ref_follows_the_route_by_dtype():
    (q, k, v), _ = _bf16(*_qkv(3, (2, 100, 16)))
    got = ref.flash_attention_ref(q, k, v, block_q=32, block_k=32, schedule="paper")
    want = ops.flash_attention(q, k, v, True, 32, 32, schedule="paper")
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("bk", [24, 32, 64, 128])
def test_bf16_causal_skip_bit_identity(bk):
    (q, k, v), _ = _bf16(*_qkv(1, (2, 192, 32)))
    q3, k3, v3, kw = ops.flash_padded(q, k, v, block_k=bk)
    outs = [flash_attention.flash_attention_tc_plain(
        q3, k3, v3, compute_segments(2, 24), 2, "factored", causal=True,
        skip_masked_k=skip, **kw) for skip in (True, False)]
    assert torch.equal(outs[0].view(torch.int16), outs[1].view(torch.int16))


def test_bf16_bits_do_not_depend_on_the_query_tiling():
    (q, k, v), _ = _bf16(*_qkv(2, (2, 200, 32)))
    outs = [ops.flash_attention(q, k, v, True, bq, 64) for bq in (16, 64, 128, 256)]
    for o in outs[1:]:
        assert torch.equal(o.view(torch.int16), outs[0].view(torch.int16))


def test_p_split_keeps_p_to_2_pow_minus_16():
    """p_hi + p_lo is within 2^-16 relative of p wherever p_lo is a normal
    bf16 (p >= 2^-117; every p of the exp's range [e^-87, 1] above that),
    and within half a bf16 subnormal step (2^-134) below it."""
    rng = np.random.default_rng(5)
    p = torch.from_numpy(np.exp(rng.uniform(-87.0, 0.0, 1 << 20)).astype(np.float32))
    p = torch.cat([p, torch.tensor([1.0, 0.5, np.float32(np.nextafter(1, 0)), 2.0 ** -117, 0.0])])
    hi, lo = flash_attention.split_bf16(p)
    assert bool((hi == hi.bfloat16().float()).all() and (lo == lo.bfloat16().float()).all())
    err = (hi.double() + lo.double() - p.double()).abs()
    normal = p >= 2.0 ** -117
    assert bool((err[normal] <= 2.0 ** -16 * p[normal].double()).all())
    assert bool((err[~normal] <= 2.0 ** -134).all())


FULL_WIDTH_HEAD = (1, 2048, 64, 128, 128, True)   # one head of the serving shape


@pytest.mark.parametrize("bh,s,hd,bq,bk,causal", CASES + [FULL_WIDTH_HEAD])
def test_tc_gate_rejects_a_kernel_that_drops_p_lo(monkeypatch, bh, s, hd, bq, bk, causal):
    """The control for the gate: the plain version with the design fault the
    split exists to avoid (PV from one bf16 p, no p_lo step) fails the gate
    against the sound plain version on the corpus and at full width."""
    (q, k, v), _ = _bf16(*_qkv(s + hd + 1, (bh, s, hd)))
    q3, k3, v3, kw = ops.flash_padded(q, k, v, block_k=bk)

    def run():
        return flash_attention.flash_attention_tc_plain(
            q3, k3, v3, compute_segments(2, 24), 2, "factored", causal=causal,
            skip_masked_k=True, **kw)

    sound = run()
    monkeypatch.setattr(flash_attention, "split_bf16",
                        lambda p: (p.bfloat16().float(), torch.zeros_like(p)))
    gate = flash_attention.tc_gate(run(), sound, float(v.float().abs().max()))
    assert not gate["ok"] and gate["identical_share"] < flash_attention.TC_IDENTICAL, gate


def test_quad_row_sum_is_the_kernel_order():
    rng = np.random.default_rng(6)
    p = rng.uniform(0, 1, (3, 5, 48)).astype(np.float32)
    part = np.zeros((3, 5, 4), np.float32)
    for n in range(6):                       # thread t: columns 8n + 2t, 8n + 2t + 1
        for e in range(2):
            part = part + p[..., [8 * n + 2 * t + e for t in range(4)]]
    want = (part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3])
    got = flash_attention.quad_row_sum(torch.from_numpy(p))[..., 0].numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def _binary_search(man: torch.Tensor, inner: torch.Tensor) -> torch.Tensor:
    """The CUDA body's seed_segment: five halving steps over the 31 slots
    (+inf past the table's own)."""
    pos = torch.zeros(man.shape, dtype=torch.int64)
    step = 16
    while step:
        pos = torch.where(man >= inner[pos + step - 1], pos + step, pos)
        step //= 2
    return pos


@pytest.mark.parametrize("name", sorted(TABLES))
def test_binary_search_selects_the_ladders_segment_for_every_mantissa(name):
    """Exhaustive over the f32 mantissas of the table's domain: [1, 2) for
    the reciprocal tables, [0.5, 2) for the rsqrt tables."""
    table = TABLES[name]
    slots = torch.tensor(list(tsdiv._table_c(table).inner), dtype=torch.float32)
    inner = torch.from_numpy(table.inner_boundaries.astype(np.float32))
    lo, hi = DOMAIN[name.split("/")[0]]
    first = int(np.float32(lo).view(np.int32))
    last = int(np.float32(hi).view(np.int32))
    for start in range(first, last, 1 << 21):
        man = torch.arange(start, min(start + (1 << 21), last), dtype=torch.int32).view(torch.float32)
        ladder = (man[:, None] >= inner).sum(-1)
        assert torch.equal(_binary_search(man, slots), ladder), (name, start)


def test_fma_error_term_equals_the_dekker_split():
    """e = fma(a, b, -a*b) against fpparts.two_product's e on operands in
    [0.5, 2] (every call site's range: mantissas, seeds, products, Newton
    iterates) and at the range ends."""
    rng = np.random.default_rng(7)
    a = rng.uniform(0.5, 2.0, 1 << 20).astype(np.float32)
    b = rng.uniform(0.5, 2.0, 1 << 20).astype(np.float32)
    up, down = np.float32(2), np.float32(0)
    ends = np.array([0.5, np.nextafter(np.float32(0.5), up), 1.0, np.nextafter(np.float32(1), down),
                     np.nextafter(np.float32(2), down), 2.0], np.float32)
    a = torch.from_numpy(np.concatenate([a, np.repeat(ends, len(ends))]))
    b = torch.from_numpy(np.concatenate([b, np.tile(ends, len(ends))]))
    p, e = fpparts.two_product(a, b)
    assert torch.equal(p.view(torch.int32), (a * b).view(torch.int32))
    got = common.fma(a, b, -(a * b))
    assert torch.equal(got.view(torch.int32), e.view(torch.int32))
