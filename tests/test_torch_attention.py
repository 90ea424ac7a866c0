"""The port's attention in every mode and its flash kernel's plain version
against the reference.

The same numpy inputs go through the reference's ``division_modes.attention``
(its Pallas flash kernel in interpret mode, as its own tests run it) and the
port's (the kernel's plain version for CPU tensors). They cannot agree bit
for bit: XLA's CPU dot and row sums run in another order than the port's
fixed one, and its exp differs from torch's by 1 ulp on ~10% of arguments
(ROADMAP F3). The tolerance port vs reference is 2e-6 absolute on O(1)
outputs (measured <= 6e-7), 1e-3 in the ILM mode, whose 12-bit mantissa
quantization can turn a 1-ulp difference of the row sum into one 12-bit
step of 1/l. The division stage itself (``1/l`` on an identical ``l``) is
held bit for bit, and so is the early skip. The reference's own attention
gates are repeated on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import division_modes as ref_dm
from repro.kernels import flash_attention as ref_fa
from repro.kernels import ops as ref_ops
from repro_torch.core import division_modes as dm
from repro_torch.core.seeds import compute_segments
from repro_torch.kernels import common, flash_attention, ops, ref
from repro_torch.models import attention as model_attention
from test_torch_tsdiv import assert_bits_equal
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

MODES = [("exact", "factored"), ("taylor", "paper"), ("taylor", "factored"),
         ("taylor_pallas", "paper"), ("taylor_pallas", "factored"),
         ("goldschmidt", "factored"), ("goldschmidt_pallas", "factored"),
         ("ilm", "factored")]
NON_ILM = MODES[:-1]


def _qkv(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=shape) * scale).astype(np.float32) for _ in range(3)]


def _attention_f64(q, k, v, causal):
    """Softmax attention in f64 on the same inputs."""
    q, k, v = (a.astype(np.float64) for a in (q, k, v))
    s = q @ np.swapaxes(k, -1, -2) / np.sqrt(q.shape[-1])
    if causal:
        s = np.where(np.tril(np.ones(s.shape[-2:], bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)) @ v


def _port(q, k, v, *args, **kw):
    return dm.attention(*(torch.from_numpy(a) for a in (q, k, v)), *args, **kw).numpy()


@pytest.mark.parametrize("mode,sched", MODES)
@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_reference(mode, sched, causal):
    q, k, v = _qkv(7, (2, 64, 32))
    want = np.asarray(ref_dm.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       ref_dm.DivisionConfig(mode=mode, schedule=sched),
                                       causal=causal))
    got = _port(q, k, v, dm.DivisionConfig(mode=mode, schedule=sched), causal=causal)
    # On a failure, each side's distance to an f64 oracle names the side that
    # moved (ROADMAP F7).
    oracle = _attention_f64(q, k, v, causal)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=1e-3 if mode == "ilm" else 2e-6,
        err_msg=f"max |port - f64 oracle| {np.abs(got - oracle).max():.3e}, "
                f"max |reference - f64 oracle| {np.abs(want - oracle).max():.3e}")


@pytest.mark.parametrize("mode,sched", NON_ILM)
def test_attention_close_to_exact_twin(mode, sched):
    """The reference's gate (test_consumer_conformance.py): <= 1e-5."""
    q, k, v = _qkv(7, (2, 64, 32))
    for causal in (True, False):
        o = _port(q, k, v, dm.DivisionConfig(mode=mode, schedule=sched), causal=causal)
        e = _port(q, k, v, dm.EXACT, causal=causal)
        assert np.max(np.abs(o - e)) <= 1e-5, (mode, causal)


def test_attention_ilm_runs_and_is_approximate():
    q, _, _ = _qkv(8, (1, 16, 8))
    o = _port(q, q, q, dm.DivisionConfig(mode="ilm"))
    e = _port(q, q, q, dm.EXACT)
    dev = np.max(np.abs(o - e))
    assert np.all(np.isfinite(o)) and 1e-8 < dev < 1e-2


def test_attention_ragged_seq_through_kernel_mode():
    q, k, v = _qkv(9, (2, 100, 32))
    o = _port(q, k, v, dm.DivisionConfig(mode="taylor_pallas"))
    e = _port(q, k, v, dm.EXACT)
    assert o.shape == (2, 100, 32)
    np.testing.assert_allclose(o, e, atol=5e-6)


def test_kernel_modes_dispatch_to_flash_and_others_do_not(monkeypatch):
    scheds = []
    real = ops.flash_attention

    def spy(q, k, v, causal=True, block_q=128, block_k=128, n_iters=2,
            precision_bits=24, schedule="factored"):
        scheds.append(schedule)
        return real(q, k, v, causal, block_q, block_k, n_iters, precision_bits, schedule)

    monkeypatch.setattr(ops, "flash_attention", spy)
    q = torch.randn(2, 64, 32)
    dm.attention(q, q, q, dm.DivisionConfig(mode="taylor_pallas"))
    dm.attention(q, q, q, dm.DivisionConfig(mode="goldschmidt_pallas"))
    for mode in ("exact", "taylor", "goldschmidt", "ilm"):
        dm.attention(q, q, q, dm.DivisionConfig(mode=mode))
    assert scheds == ["factored", "goldschmidt"]
    # empty operands take the twin, as in the reference
    e = torch.zeros(2, 0, 32)
    assert dm.attention(e, e, e, dm.DivisionConfig(mode="taylor_pallas")).shape == (2, 0, 32)
    assert scheds == ["factored", "goldschmidt"]


def test_one_masking_constant():
    assert flash_attention.NEG_INF == model_attention.NEG_INF == ref_fa.NEG_INF


# ------------------------------------------- the flash kernel's plain version

CASES = [  # (bh, s, hd, block_q, block_k, causal): reference test_flash_attention.py
    (2, 256, 64, 128, 128, True), (3, 128, 32, 64, 32, True),
    (2, 256, 64, 128, 64, False), (1, 512, 128, 128, 128, True),
    (2, 64, 16, 64, 64, True)]


@pytest.mark.parametrize("bh,s,hd,bq,bk,causal", CASES)
def test_flash_vs_exact_and_reference(bh, s, hd, bq, bk, causal):
    q, k, v = _qkv(s + hd, (bh, s, hd))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    o = ops.flash_attention(qt, kt, vt, causal, bq, bk).numpy()
    np.testing.assert_allclose(o, ref.flash_attention_exact(qt, kt, vt, causal=causal).numpy(),
                               atol=2e-6, rtol=1e-5)
    want = np.asarray(ref_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              causal=causal, block_q=bq, block_k=bk))
    np.testing.assert_allclose(o, want, atol=2e-6, rtol=0)


RAGGED = [(2, 100, 32, 32, 32, True), (2, 100, 32, 32, 32, False),
          (1, 300, 16, 128, 64, True), (3, 77, 32, 32, 16, False)]


@pytest.mark.parametrize("bh,s,hd,bq,bk,causal", RAGGED)
def test_flash_ragged_seq_lens(bh, s, hd, bq, bk, causal):
    """Pad-and-mask: padded keys masked in the kernel, padded q rows sliced."""
    q, k, v = _qkv(s, (bh, s, hd))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    o = ops.flash_attention(qt, kt, vt, causal, bq, bk).numpy()
    assert o.shape == (bh, s, hd) and np.all(np.isfinite(o))
    np.testing.assert_allclose(o, ref.flash_attention_exact(qt, kt, vt, causal=causal).numpy(),
                               atol=5e-6, rtol=1e-4)
    want = np.asarray(ref_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              causal=causal, block_q=bq, block_k=bk))
    np.testing.assert_allclose(o, want, atol=2e-6, rtol=0)


def test_flash_causal_skip_bit_identity():
    """Skipping the key blocks above a row's diagonal gives the bits of
    running them, in the port as in the reference."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, (2, 256, 32)))
    table = compute_segments(2, 24)
    for bk in (32, 64, 128):
        kw = dict(causal=True, block_k=bk, sk_real=256)
        skip = flash_attention.flash_attention_plain(q, k, v, table, 2, "factored",
                                                     skip_masked_k=True, **kw)
        full = flash_attention.flash_attention_plain(q, k, v, table, 2, "factored",
                                                     skip_masked_k=False, **kw)
        assert torch.equal(skip.view(torch.int32), full.view(torch.int32)), bk
        o_skip = ref_fa.flash_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                        block_q=64, block_k=bk, skip_masked_k=True)
        o_full = ref_fa.flash_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                        block_q=64, block_k=bk, skip_masked_k=False)
        assert bool(jnp.all(o_skip == o_full))


def test_flash_bits_do_not_depend_on_the_query_tiling():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, (2, 200, 32)))
    outs = [ops.flash_attention(q, k, v, True, bq, 64) for bq in (16, 64, 128, 256)]
    for o in outs[1:]:
        assert torch.equal(o.view(torch.int32), outs[0].view(torch.int32))


@pytest.mark.parametrize("schedule", ["paper", "factored", "goldschmidt"])
def test_the_one_over_l_stage_is_bit_identical(schedule):
    """Given the same l, the finalize 1/l is the reference's: the port's
    recip_f32_bits against the reference's Pallas reciprocal (interpret),
    on row sums of the magnitudes attention produces (1 .. S)."""
    rng = np.random.default_rng(4)
    l = np.concatenate([rng.uniform(1.0, 4096.0, 8192),
                        rng.uniform(1.0, 2.0, 2048)]).astype(np.float32)
    want = ref_ops.tsdiv_recip(jnp.asarray(l), 2, 24, schedule)
    got = common.recip_f32_bits(torch.from_numpy(l), compute_segments(2, 24), 2, schedule)
    assert_bits_equal(got, want)


def test_flash_goldschmidt_schedule_differs_from_factored():
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, (2, 128, 32)))
    og = ops.flash_attention(q, k, v, schedule="goldschmidt")
    of = ops.flash_attention(q, k, v, schedule="factored")
    e = ref.flash_attention_exact(q, k, v)
    np.testing.assert_allclose(og.numpy(), e.numpy(), atol=3e-6, rtol=1e-4)
    assert bool((og != of).any())


def test_flash_bf16_4d_and_long_context():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(6, (2, 128, 64)))
    o = ops.flash_attention(q, k, v)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(),
                               ref.flash_attention_exact(q, k, v).float().numpy(), atol=0.04)
    q4, k4, v4 = (torch.from_numpy(a) for a in _qkv(7, (2, 4, 128, 32)))
    o4 = ops.flash_attention(q4, k4, v4)
    assert o4.shape == (2, 4, 128, 32)
    e4 = ref.flash_attention_exact(*(t.reshape(8, 128, 32) for t in (q4, k4, v4)))
    np.testing.assert_allclose(o4.reshape(8, 128, 32).numpy(), e4.numpy(), atol=2e-6)
    ql, kl, _ = _qkv(8, (1, 1024, 32), scale=3.0)
    vl = np.random.default_rng(9).normal(size=(1, 1024, 32)).astype(np.float32)
    ql, kl, vl = (torch.from_numpy(a) for a in (ql, kl, vl))
    ol = ops.flash_attention(ql, kl, vl, True, 128, 64)
    np.testing.assert_allclose(ol.numpy(), ref.flash_attention_exact(ql, kl, vl).numpy(),
                               atol=5e-6, rtol=1e-4)


def test_flash_ref_is_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, (2, 100, 16)))
    got = ref.flash_attention_ref(q, k, v, block_q=32, block_k=32, schedule="paper")
    want = ops.flash_attention(q, k, v, True, 32, 32, schedule="paper")
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_flash_backward_matches_jax_grad():
    """The recompute backward against jax.grad of the reference's
    ops.flash_attention (same f32 formula; XLA's einsum order)."""
    q, k, v = _qkv(10, (2, 100, 32))
    g = np.random.default_rng(11).normal(size=q.shape).astype(np.float32)
    for causal in (True, False):
        want = jax.grad(lambda a, b, c: jnp.sum(ref_ops.flash_attention(a, b, c, causal=causal)
                                                * jnp.asarray(g)), (0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        (ops.flash_attention(qt, kt, vt, causal) * torch.from_numpy(g)).sum().backward()
        for got, w in zip((qt.grad, kt.grad, vt.grad), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=2e-5, rtol=1e-5)


def test_flash_wrapper_counts_nothing_on_the_cpu_and_checks_shapes():
    flash_attention.reset_launches()
    q = torch.randn(2, 64, 16)
    flash_attention.flash_attention(q, q, q)
    assert flash_attention.LAUNCHES == {"flash_attention_f32": 0, "flash_attention_bf16": 0}
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, q[:, :50], q[:, :50], block_k=32)
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, q, q[:, :32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_padded_passes_whole_blocks_through_without_a_copy(dtype):
    """Lengths that are whole blocks, contiguous and 16-byte aligned: q3,
    k3, v3 are views of q, k, v (same storage), and attention through them
    gives the bits of attention through padded copies. Ragged lengths and
    views off a 16-byte boundary are still copied, ragged ones padded."""
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(11, (2, 3, 256, 32)))
    q3, k3, v3, kw = ops.flash_padded(q, k, v, 128, 64)
    assert kw == dict(block_k=64, sk_real=256)
    for t, t3 in ((q, q3), (k, k3), (v, v3)):
        assert t3.data_ptr() == t.data_ptr() and t3.shape == (6, 256, 32)
    table = compute_segments(2, 24)
    plain = flash_attention.PLAIN[flash_attention.kernel_for(dtype)]
    got = plain(q3, k3, v3, table, 2, "factored", causal=True, skip_masked_k=True, **kw)
    copies = [t.reshape(6, 256, 32).clone() for t in (q, k, v)]
    want = plain(*copies, table, 2, "factored", causal=True, skip_masked_k=True, **kw)
    assert torch.equal(got.float().view(torch.int32), want.float().view(torch.int32))
    assert torch.equal(ops.flash_attention(q, k, v, True, 128, 64).reshape(6, 256, 32), got)

    qr, kr, vr = (t[:, :, :200] for t in (q, k, v))          # ragged and strided
    q3, k3, v3, kw = ops.flash_padded(qr, kr, vr, 128, 64)
    assert kw == dict(block_k=64, sk_real=200)
    assert q3.shape == (6, 256, 32) and k3.shape == v3.shape == (6, 256, 32)
    assert all(t.is_contiguous() for t in (q3, k3, v3))
    assert all(t3.data_ptr() != t.data_ptr() for t, t3 in ((qr, q3), (kr, k3), (vr, v3)))
    assert not bool(q3[:, 200:].any()) and not bool(k3[:, 200:].any())

    odd = torch.empty(q.numel() + 1, dtype=dtype)[1:].view(q.shape)   # 2 or 4 bytes off
    odd.copy_(q)
    q3, _, _, _ = ops.flash_padded(odd, k, v, 128, 64)
    assert q3.data_ptr() % 16 == 0 and torch.equal(q3, q.reshape(6, 256, 32))
