"""The fused kernels' plain versions against the reference's Pallas kernels.

The reference's ``kernels.ops.tsdiv_*`` run their Pallas kernels in
interpret mode here, exactly as the JAX package's own tests run them; the
port's ``kernels.ops.tsdiv_*`` run the plain versions for CPU tensors.
Both get the same seeded bit patterns: random over every exponent, plus
the IEEE edges and the exponent fields 253/254 where the reciprocal flushes.
The gate is 0 int ulp on every lane, for every op and schedule.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.eval import golden as ref_golden
from repro.kernels import ops as ref_ops
from repro_torch.kernels import ops, tsdiv
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCHEDULES = ["paper", "factored", "goldschmidt"]
EDGES = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 2.0 ** -126,
                  2.0 ** -149, -(2.0 ** -140), 1.5 * 2.0 ** 126, 2.0 ** 127,
                  3.4e38, -1.5 * 2.0 ** 125], np.float32)


def corpus(seed: int, n: int = 1 << 14) -> np.ndarray:
    """n random f32 bit patterns + n/4 with exponent fields near the
    reciprocal's cliffs (253, 254, 0, 1, 255) + the IEEE edges."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    m = n // 4
    exp = rng.choice(np.array([253, 254, 0, 1, 255], np.uint32), m)
    man = rng.integers(0, 2**23, m, dtype=np.int64).astype(np.uint32)
    sign = rng.integers(0, 2, m).astype(np.uint32) << 31
    return np.concatenate([bits.view(np.float32),
                           (sign | (exp << 23) | man).view(np.float32), EDGES])


X = corpus(11)
A = corpus(12)


def assert_bits_equal(got: torch.Tensor, want) -> None:
    """0 int ulp, with any nan matching any nan."""
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype
    nan = np.isnan(got) & np.isnan(want)
    bad = ~nan & (got.view(np.uint32) != want.view(np.uint32))
    assert not bad.any(), (f"{int(bad.sum())} lanes differ, first at "
                           f"{np.flatnonzero(bad)[:5]}: {got[bad][:5]} vs {want[bad][:5]}")


@pytest.mark.parametrize("n,p", [(2, 24), (1, 12)])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_plain_recip_bit_exact_vs_pallas(schedule, n, p):
    want = ref_ops.tsdiv_recip(jnp.asarray(X), n, p, schedule)
    assert_bits_equal(ops.tsdiv_recip(torch.from_numpy(X), n, p, schedule), want)


@pytest.mark.parametrize("n,p", [(2, 24), (1, 12)])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_plain_divide_bit_exact_vs_pallas(schedule, n, p):
    want = ref_ops.tsdiv_divide(jnp.asarray(A), jnp.asarray(X), n, p, schedule)
    got = ops.tsdiv_divide(torch.from_numpy(A), torch.from_numpy(X), n, p,
                           schedule)
    assert_bits_equal(got, want)


def test_plain_divide_bit_exact_vs_tiled_pallas():
    """Rank-2 operands reach the reference's tiled kernel (ragged tiles);
    the port's one flat launch gives the same bits."""
    a2, x2 = A[:3 * 1000].reshape(3, 1000), X[:3 * 1000].reshape(3, 1000)
    want = ref_ops.tsdiv_divide(jnp.asarray(a2), jnp.asarray(x2), 2, 24,
                                "goldschmidt")
    got = ops.tsdiv_divide(torch.from_numpy(a2), torch.from_numpy(x2), 2, 24,
                           "goldschmidt")
    assert got.shape == (3, 1000)
    assert_bits_equal(got, want)


@pytest.mark.parametrize("newton_iters", [1, 2, 3])
def test_plain_rsqrt_bit_exact_vs_pallas(newton_iters):
    want = ref_ops.tsdiv_rsqrt(jnp.asarray(X), newton_iters, 16)
    assert_bits_equal(ops.tsdiv_rsqrt(torch.from_numpy(X), newton_iters, 16),
                      want)


def test_plain_rsqrt_bit_exact_on_golden_ftz_cell():
    """The rsqrt store has no fused-kernel cell; the reference pins its
    ftz twin bit-identical to the kernel, so the kernel's plain version is
    held to that cell."""
    with np.load(ref_golden.RSQRT_PATH) as z:
        x, want = z["inputs"], z["out:rsqrt/taylor/newton2/ftz"].view(np.float32)
    assert_bits_equal(ops.tsdiv_rsqrt(torch.from_numpy(x), 2, 16), want)


def test_recip_flushes_below_the_normal_range():
    """XLA on the CPU flushes subnormal products; torch does not, so the
    reciprocal flushes explicitly. Exponent fields 253 and 254 give
    subnormal reciprocals (flushed to signed zero) unless the mantissa is 1."""
    x = np.array([1.5 * 2.0 ** 126, -1.5 * 2.0 ** 126, 2.0 ** 126, 1.25 * 2.0 ** 127,
                  -(2.0 ** 127)], np.float32)
    got = ops.tsdiv_recip(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), np.array(
        [0, 0x80000000, np.float32(2.0 ** -126).view(np.uint32), 0, 0x80000000],
        np.uint32))
    assert_bits_equal(torch.from_numpy(got), ref_ops.tsdiv_recip(jnp.asarray(x)))


def test_recip_exponent_255_lanes_come_from_the_edge_table():
    """The reference's uint32 254 - exp wraps at exp = 255 where the port's
    int32 gives -1; both scales are overwritten by the edge table."""
    x = np.array([np.inf, -np.inf, np.nan, -np.nan], np.float32)
    x = np.concatenate([x, np.array([0x7F800001, 0xFFFFFFFF], np.uint32).view(np.float32)])
    got = ops.tsdiv_recip(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got[:2].view(np.uint32), [0, 0x80000000])
    assert np.isnan(got[2:]).all()


@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5), (2, 3, 4)])
def test_any_rank_is_one_flat_elementwise_launch(shape):
    rng = np.random.default_rng(5)
    a = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    got = ops.tsdiv_divide(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == shape
    flat = ops.tsdiv_divide(torch.from_numpy(a.reshape(-1)),
                            torch.from_numpy(b.reshape(-1)))
    np.testing.assert_array_equal(got.numpy().reshape(-1), flat.numpy())
    assert_bits_equal(got, ref_ops.tsdiv_divide(jnp.asarray(a), jnp.asarray(b)))


def test_divide_requires_equal_shapes():
    with pytest.raises(ValueError, match="equal shapes"):
        ops.tsdiv_divide(torch.ones(3), torch.ones(1))


def test_empty_tensors_keep_shape_and_dtype():
    for dtype in (torch.float32, torch.bfloat16):
        e = torch.ones((0, 4), dtype=dtype)
        for out in (ops.tsdiv_recip(e), ops.tsdiv_divide(e, e), ops.tsdiv_rsqrt(e)):
            assert out.shape == (0, 4) and out.dtype == dtype


def test_bf16_in_bf16_out_through_f32():
    x = X[np.isfinite(X)][:2048]
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    tb = torch.from_numpy(x).to(torch.bfloat16)
    for got, want in ((ops.tsdiv_recip(tb), ref_ops.tsdiv_recip(xb)),
                      (ops.tsdiv_rsqrt(tb), ref_ops.tsdiv_rsqrt(xb)),
                      (ops.tsdiv_divide(tb, tb.flip(0)),
                       ref_ops.tsdiv_divide(xb, xb[::-1]))):
        assert got.dtype == torch.bfloat16
        # bf16 -> f32 is exact, so equal f32 bits mean equal bf16 bits.
        assert_bits_equal(got.float(), np.asarray(want.astype(jnp.float32)))


def test_vjps_match_jax_grad():
    a = np.array([1.5, -3.0, 0.0, 2.0, np.inf, 1e-3, 7.0, 2.0 ** -130], np.float32)
    b = np.array([0.7, 2.0, 1.0, 0.0, 3.0, 1e30, 5.0, 4.0], np.float32)
    ga, gb = jax.grad(lambda x, y: jnp.sum(ref_ops.tsdiv_divide(x, y)),
                      argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    gr = jax.grad(lambda x: jnp.sum(ref_ops.tsdiv_recip(x)))(jnp.asarray(a))
    gs = jax.grad(lambda x: jnp.sum(ref_ops.tsdiv_rsqrt(x)))(jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    ops.tsdiv_divide(ta, tb).sum().backward()
    tr = torch.from_numpy(a).requires_grad_()
    ops.tsdiv_recip(tr).sum().backward()
    ts = torch.from_numpy(b).requires_grad_()
    ops.tsdiv_rsqrt(ts).sum().backward()
    for got, want in ((ta, ga), (tb, gb), (tr, gr), (ts, gs)):
        g = got.grad.numpy()
        assert np.isfinite(g).all()
        np.testing.assert_array_equal(g, np.asarray(want))
    # Edge lanes: 1/0 and x/0 give inf; their gradients are 0, not nan.
    assert tr.grad[2] == 0 and ta.grad[3] == 0 and tb.grad[3] == 0
    assert ts.grad[3] == 0


def test_plain_path_counts_no_launches():
    before = dict(tsdiv.LAUNCHES)
    ops.tsdiv_divide(torch.ones(4), torch.ones(4))
    ops.tsdiv_recip(torch.ones(4))
    ops.tsdiv_rsqrt(torch.ones(4))
    assert tsdiv.LAUNCHES == before


def test_seed_table_is_converted_once_per_table():
    """The kernels' by-value seed table is built on a table's first use and
    reused, with the table's own values and +inf past its last boundary."""
    from repro_torch.core.seeds import compute_segments, rsqrt_seed_table

    for table in (compute_segments(2, 24), rsqrt_seed_table(16)):
        c = tsdiv._table_c(table)
        assert tsdiv._table_c(table) is c
        n = table.n_segments
        np.testing.assert_array_equal(np.array(c.slopes[:n], np.float32),
                                      table.slopes.astype(np.float32))
        np.testing.assert_array_equal(np.array(c.inner[:n - 1], np.float32),
                                      table.inner_boundaries.astype(np.float32))
        assert all(v == np.inf for v in c.inner[n - 1:])
    assert tsdiv._table_c(compute_segments(2, 24)) is not tsdiv._table_c(rsqrt_seed_table(16))


def test_wrappers_reject_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        tsdiv.recip(torch.ones(4, dtype=torch.float64))
    with pytest.raises(TypeError):
        tsdiv.recip(torch.ones(4, 2).t())
    with pytest.raises(RuntimeError, match="no division-unit kernel"):
        tsdiv.recip(torch.ones(4, device="meta"))


def test_ref_oracles():
    """``*_ref`` is the plain version, so it matches the reference's Pallas
    kernels (not the reference's eager ``*_ref``, which does not fuse the
    multiply-adds its compiled kernel fuses); ``*_exact`` is torch's op."""
    from repro_torch.kernels import ref

    assert_bits_equal(ref.tsdiv_recip_ref(torch.from_numpy(X), schedule="paper"),
                      ref_ops.tsdiv_recip(jnp.asarray(X), 2, 24, "paper"))
    assert_bits_equal(ref.tsdiv_divide_ref(torch.from_numpy(A), torch.from_numpy(X)),
                      ref_ops.tsdiv_divide(jnp.asarray(A), jnp.asarray(X)))
    assert_bits_equal(ref.tsdiv_rsqrt_ref(torch.from_numpy(X)),
                      ref_ops.tsdiv_rsqrt(jnp.asarray(X)))
    x = torch.tensor([4.0, -0.5, 3.0])
    assert torch.equal(ref.tsdiv_recip_exact(x), 1.0 / x)
    assert torch.equal(ref.tsdiv_divide_exact(x, x.flip(0)), x / x.flip(0))
    assert torch.equal(ref.tsdiv_rsqrt_exact(x[:1]), torch.tensor([0.5]))


@pytest.mark.parametrize("op,schedule", [("recip", "factored"), ("recip", "goldschmidt"),
                                         ("divide", "goldschmidt")])
def test_the_fused_sites_are_needed(monkeypatch, op, schedule):
    """With every multiply-add rounded twice instead of fused at the sites
    the compiled reference fuses, the plain version leaves the Pallas
    kernel's bits (by 1-2 int ulp) on part of the corpus."""
    from repro_torch.core.fpparts import mul_add
    from repro_torch.kernels import common

    if op == "recip":
        want = np.asarray(ref_ops.tsdiv_recip(jnp.asarray(X), 2, 24, schedule))
        run = lambda: ops.tsdiv_recip(torch.from_numpy(X), 2, 24, schedule)
    else:
        want = np.asarray(ref_ops.tsdiv_divide(jnp.asarray(A), jnp.asarray(X), 2, 24,
                                               schedule))
        run = lambda: ops.tsdiv_divide(torch.from_numpy(A), torch.from_numpy(X), 2, 24,
                                       schedule)
    monkeypatch.setattr(common, "fma", mul_add)
    got = run().numpy()
    differ = ~(np.isnan(got) & np.isnan(want)) & (got.view(np.uint32) != want.view(np.uint32))
    d = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    print(f"{op}/{schedule}: {int(differ.sum())} of {X.size} lanes differ unfused")
    assert differ.any()
    assert d[differ].max() <= 2
