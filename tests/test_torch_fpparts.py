"""The port's bit-level datapath (int32 views) against the reference's.

split/repack, the error-free two_product, the Markstein step, the exact
f32 fma of the kernels' plain versions, and the analytic VJPs of the
twins, all fed the same numpy inputs as the reference.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fpparts as ref_fp
from repro.core import division_modes as ref_dm
from repro_torch.core import fpparts
from repro_torch.core import division_modes as dm
from repro_torch.kernels.common import fma
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

RNG_SEED = 1234


def _mags(n=1 << 14):
    rng = np.random.default_rng(RNG_SEED)
    mags = rng.integers(0, 2**31, n, dtype=np.int64).astype(np.uint32)
    sub = rng.integers(1, 2**23, 512, dtype=np.int64).astype(np.uint32)
    edges = np.array([0, 1, 0x7FFFFF, 0x800000, 0x7F800000, 0x7FC00000,
                      0x7F7FFFFF], np.uint32)
    return np.concatenate([mags, sub, edges])


def test_split_f32_matches_reference():
    mags = _mags()
    ref_man, ref_e = ref_fp.split_f32(jnp.asarray(mags))
    man, e = fpparts.split_f32(torch.from_numpy(mags.view(np.int32)))
    np.testing.assert_array_equal(man.numpy().view(np.uint32),
                                  np.asarray(ref_man).view(np.uint32))
    np.testing.assert_array_equal(e.numpy(), np.asarray(ref_e))


@pytest.mark.parametrize("underflow", ["gradual", "ftz"])
def test_repack_f32_matches_reference(underflow):
    rng = np.random.default_rng(RNG_SEED + 1)
    n = 1 << 14
    man = rng.uniform(0.5, 4.0, n).astype(np.float32)
    e = rng.integers(-175, 140, n).astype(np.int32)
    sign = (rng.integers(0, 2, n).astype(np.uint32) << 31)
    want = ref_fp.repack_f32(jnp.asarray(man), jnp.asarray(e),
                             jnp.asarray(sign), underflow)
    got = fpparts.repack_f32(torch.from_numpy(man), torch.from_numpy(e),
                             torch.from_numpy(sign.view(np.int32)), underflow)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))


def test_two_product_and_markstein_step_match_reference():
    rng = np.random.default_rng(RNG_SEED + 2)
    a = rng.uniform(1.0, 2.0, 4096).astype(np.float32)
    b = rng.uniform(0.5, 1.0, 4096).astype(np.float32)
    p, e = fpparts.two_product(torch.from_numpy(a), torch.from_numpy(b))
    rp, re = ref_fp.two_product(a, b)                 # numpy f32, no fusion
    np.testing.assert_array_equal(p.numpy(), rp)
    np.testing.assert_array_equal(e.numpy(), re)
    # a*b == p + e exactly.
    exact = a.astype(np.float64) * b.astype(np.float64)
    np.testing.assert_array_equal(p.numpy().astype(np.float64)
                                  + e.numpy().astype(np.float64), exact)
    q0 = (a * b).astype(np.float32)
    got = fpparts.refine_quotient(*(torch.from_numpy(v) for v in (q0, a, b, b)))
    np.testing.assert_array_equal(got.numpy(), ref_fp.refine_quotient(q0, a, b, b))


def _round_f32(v: Fraction) -> np.float32:
    """Correct RNE rounding of an exact rational to f32 (normal range)."""
    lo = np.float32(float(v))
    cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
             np.nextafter(lo, np.float32(np.inf))]
    dist = [abs(Fraction(float(c)) - v) for c in cands]
    best = min(dist)
    ties = [c for c, d in zip(cands, dist) if d == best]
    return min(ties, key=lambda c: int(np.array(c).view(np.uint32)) & 1)


def test_fma_rounds_once():
    """fma is a*b + c with one rounding, including where a plain f64
    evaluation would round twice (an exact f32 tie nudged by a tiny c)."""
    a = np.float32(3.0)
    b = np.float32(8388609.0)          # 2^23 + 1: a*b = 25165827 is an f32 tie
    c = np.float32(-2.0 ** -30)
    got = fma(torch.tensor([a]), torch.tensor([b]), torch.tensor([c]))
    assert got.item() == 25165826.0    # exact value is just below the tie
    naive = np.float32(np.float64(a) * np.float64(b) + np.float64(c))
    assert naive == 25165828.0         # the double rounding this avoids
    rng = np.random.default_rng(RNG_SEED + 3)
    xs = rng.uniform(-2, 2, (3, 512)).astype(np.float32)
    xs[2] *= np.float32(2.0 ** -20)
    got = fma(*(torch.from_numpy(v) for v in xs)).numpy()
    want = [_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
            for x, y, z in xs.T]
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))


GRAD_MODES = ["taylor", "goldschmidt"]


def _grad_inputs():
    a = np.array([1.5, -3.0, 0.0, 2.0, np.inf, 1e-3, 7.0, -0.0], np.float32)
    b = np.array([0.7, 2.0, 1.0, 0.0, 3.0, 1e30, np.inf, 5.0], np.float32)
    return a, b


@pytest.mark.parametrize("mode", GRAD_MODES)
def test_twin_vjps_match_jax_grad(mode):
    a, b = _grad_inputs()
    rcfg, pcfg = ref_dm.DivisionConfig(mode=mode), dm.DivisionConfig(mode=mode)
    ga, gb = jax.grad(lambda x, y: jnp.sum(ref_dm.div(x, y, rcfg)),
                      argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    gr = jax.grad(lambda x: jnp.sum(ref_dm.recip(x, rcfg)))(jnp.asarray(b))
    gs = jax.grad(lambda x: jnp.sum(ref_dm.rsqrt(x, rcfg)))(jnp.abs(jnp.asarray(b)))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    dm.div(ta, tb, pcfg).sum().backward()
    tr = torch.from_numpy(b).requires_grad_()
    dm.recip(tr, pcfg).sum().backward()
    ts = torch.from_numpy(np.abs(b)).requires_grad_()
    dm.rsqrt(ts, pcfg).sum().backward()
    for got, want in ((ta.grad, ga), (tb.grad, gb), (tr.grad, gr), (ts.grad, gs)):
        got, want = got.numpy(), np.asarray(want)
        assert np.isfinite(got).all()
        # XLA on the CPU flushes subnormal products to zero; torch keeps
        # them (ROADMAP F4). Such a lane (a=7, b=inf: 1/b is subnormal)
        # is 0 in the reference and subnormal here; all others are equal.
        sub = (got != 0) & (np.abs(got) < np.float32(2.0 ** -126))
        assert (want[sub] == 0).all()
        np.testing.assert_array_equal(np.where(sub, 0, got), want)
    assert tb.grad[3] == 0                         # q = x/0 = inf: masked
    assert tr.grad[3] == 0 and ts.grad[3] == 0     # 1/0, rsqrt(0) edge lanes


def test_twin_divide_broadcasts_and_sums_cotangents():
    a = torch.tensor([[1.0, 2.0], [3.0, 4.0]], requires_grad=True)
    b = torch.tensor([2.0, 4.0], requires_grad=True)
    q = dm.div(a, b, dm.TAYLOR)
    assert q.shape == (2, 2)
    q.sum().backward()
    assert b.grad.shape == (2,)
    np.testing.assert_allclose(b.grad.numpy(), [-(1 + 3) / 4, -(2 + 4) / 16])
