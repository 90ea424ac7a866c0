"""The port's Iterative Logarithmic Multiplier and its ILM mode against the
reference, lane for lane.

``core/ilm`` (numpy and torch twins), ``ops.ilm_mul`` / ``ilm_square`` (the
kernels' plain versions on the CPU) and the ILM modes of recip / div /
rsqrt take the same numpy inputs as the reference's functions and must give
its bits: 0 differing lanes, uint32 wrap-around included, on the
conformance corpora of ``eval/ulp.py`` (subnormal strata included: the
port's ILM mode flushes explicitly where XLA's CPU backend flushes, so F4
leaves no exception here). Also the ports of ``tests/test_ilm.py`` and of
the squaring unit's hardware claim in ``tests/test_powering.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import division_modes as ref_dm
from repro.core import ilm as ref_ilm
from repro.kernels import ilm as ref_ilm_k
from repro.kernels import ops as ref_ops
from repro_torch.core import division_modes as dm
from repro_torch.core import ilm, powering
from repro_torch.eval import ulp
from repro_torch.kernels import ilm as ilm_k
from repro_torch.kernels import ops, ref
from test_torch_tsdiv import assert_bits_equal
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ILM = dm.DivisionConfig(mode="ilm")
REF_ILM = ref_dm.DivisionConfig(mode="ilm")


def _operands(seed, n=4096, hi=2**16):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, hi, n, dtype=np.int64).astype(np.uint32)
    b = rng.integers(0, hi, n, dtype=np.int64).astype(np.uint32)
    edges = np.array([0, 1, 2, 65535, 32768, 65534, 1, 0], np.uint32)
    return np.concatenate([a, edges]), np.concatenate([b, edges[::-1]])


def _u32(t: torch.Tensor) -> np.ndarray:
    """int64 lanes or a torch.uint32 tensor as numpy uint32."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy().astype(np.uint32)


# ----------------------------------------------------------- core/ilm twins

@pytest.mark.parametrize("iters", range(1, 17))
def test_torch_twin_bit_exact_vs_reference(iters):
    a, b = _operands(iters)
    want_mul = np.asarray(ref_ilm.ilm_mul(jnp.asarray(a), jnp.asarray(b), iters))
    want_sq = np.asarray(ref_ilm.ilm_square(jnp.asarray(a), iters))
    got_mul = ilm.ilm_mul(torch.from_numpy(a), torch.from_numpy(b), iters)
    got_sq = ilm.ilm_square(torch.from_numpy(a), iters)
    np.testing.assert_array_equal(_u32(got_mul), want_mul)
    np.testing.assert_array_equal(_u32(got_sq), want_sq)


def test_torch_twin_wraps_as_uint32():
    """Operands past 2^16 overflow the 32-bit lane: the port wraps where the
    reference's uint32 arithmetic wraps."""
    a, b = _operands(5, hi=2**32)
    for iters in (1, 4, 16, 32):
        np.testing.assert_array_equal(
            _u32(ilm.ilm_mul(torch.from_numpy(a), torch.from_numpy(b), iters)),
            np.asarray(ref_ilm.ilm_mul(jnp.asarray(a), jnp.asarray(b), iters)))
        np.testing.assert_array_equal(
            _u32(ilm.ilm_square(torch.from_numpy(a), iters)),
            np.asarray(ref_ilm.ilm_square(jnp.asarray(a), iters)))


def test_floor_log2_and_numpy_twin_equal_reference():
    x = np.array([0, 1, 2, 3, 4, 7, 8, 255, 256, 65535, 2**31, 2**32 - 1], np.uint32)
    np.testing.assert_array_equal(ilm.floor_log2(torch.from_numpy(x)).numpy(),
                                  np.asarray(ref_ilm.floor_log2(jnp.asarray(x))))
    rng = np.random.default_rng(2)
    a = rng.integers(1, 2**24, 2000).astype(np.uint64)
    b = rng.integers(1, 2**24, 2000).astype(np.uint64)
    for iters in (1, 3, 12, 24):
        np.testing.assert_array_equal(ilm.ilm_mul_np(a, b, iters), ref_ilm.ilm_mul_np(a, b, iters))
        np.testing.assert_array_equal(ilm.ilm_square_np(a, iters), ref_ilm.ilm_square_np(a, iters))
    np.testing.assert_array_equal(ilm.floor_log2_np(a), ref_ilm.floor_log2_np(a))
    assert ilm.exact_iters_bound(16) == ref_ilm.exact_iters_bound(16) == 16


# ------------------------------------------- ops (the kernels' plain versions)

@pytest.mark.parametrize("iters", [1, 2, 4, 8, 16])
def test_ops_bit_exact_vs_reference_kernels(iters):
    """ops.ilm_mul / ilm_square (plain versions on the CPU) against the
    reference's Pallas kernels in interpret mode."""
    rng = np.random.default_rng(iters)
    a = rng.integers(0, 2**16, (33, 70)).astype(np.uint32)
    b = rng.integers(0, 2**16, (33, 70)).astype(np.uint32)
    got = ops.ilm_mul(torch.from_numpy(a), torch.from_numpy(b), iters=iters)
    assert got.dtype == torch.uint32 and got.shape == (33, 70)
    np.testing.assert_array_equal(_u32(got), np.asarray(
        ref_ops.ilm_mul(jnp.asarray(a), jnp.asarray(b), iters=iters)))
    np.testing.assert_array_equal(_u32(ops.ilm_square(torch.from_numpy(a), iters=iters)),
                                  np.asarray(ref_ops.ilm_square(jnp.asarray(a), iters=iters)))


def test_exact_at_the_bound_and_the_oracles():
    a, b = _operands(9)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    bound = ilm.exact_iters_bound(16)
    np.testing.assert_array_equal(_u32(ops.ilm_mul(at, bt, iters=bound)),
                                  a.astype(np.uint64) * b)
    np.testing.assert_array_equal(_u32(ops.ilm_square(at, iters=bound)),
                                  a.astype(np.uint64) ** 2)
    np.testing.assert_array_equal(_u32(ref.ilm_mul_exact(at, bt)),
                                  np.asarray(ref_ilm.ilm_mul(jnp.asarray(a), jnp.asarray(b), 16)))
    np.testing.assert_array_equal(_u32(ref.ilm_square_exact(at)), _u32(ref.ilm_square_ref(at)))
    np.testing.assert_array_equal(_u32(ref.ilm_mul_ref(at, bt, iters=3)),
                                  _u32(ops.ilm_mul(at, bt, iters=3)))


def test_ops_takes_any_integer_tensor_and_broadcasts():
    a = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    got = ops.ilm_mul(a, torch.tensor(5), iters=16)
    assert got.dtype == torch.uint32 and got.shape == (3, 4)
    np.testing.assert_array_equal(_u32(got), (np.arange(12) * 5).reshape(3, 4))
    empty = ops.ilm_square(torch.zeros(0, dtype=torch.int64))
    assert empty.shape == (0,) and empty.dtype == torch.uint32


def test_kernel_wrappers_take_uint32_only_and_count_nothing_on_the_cpu():
    ilm_k.reset_launches()
    a = torch.arange(10, dtype=torch.int64)
    with pytest.raises(TypeError):
        ilm_k.ilm_mul(a, a)
    ilm_k.ilm_square(ilm_k.to_u32(a))
    assert ilm_k.LAUNCHES == {"ilm_mul_u32": 0, "ilm_square_u32": 0}


# ------------------------------------ the squarer kernel's closed form (ilm.cu)

def _mul_mod32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a*b mod 2^32 on int64 lanes below 2^32, with no product past 2^48."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & ilm.U32


def _residue(x: torch.Tensor, iters: int) -> torch.Tensor:
    """``residue()`` of csrc/ilm.cu: x with its top ``iters`` set bits
    cleared, by the kernel's two loops (keep the lowest ``popcount - iters``
    set bits, or clear the leading one ``iters`` times, whichever is fewer)."""
    keep = ilm._popcount32(x) - iters
    low = keep < iters
    v = x
    for s in range(iters):
        clz = 31 - ilm.floor_log2(v).clamp(min=0)
        top = torch.full_like(v, 0x7FFF_FFFF) >> clz
        v = torch.where(low & (s < keep), v & (v - 1),
                        torch.where(~low & (keep > 0), v & top, v))
    return torch.where(keep <= 0, 0, torch.where(low, x ^ v, v))


def _full_range_operands(seed: int, shape=(64, 256)) -> np.ndarray:
    """Seeded uint32 words over the whole range, led by 0, 1, 2^16 - 1,
    2^32 - 1 (popcount 32) and a few other popcount edges."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    a.flat[:8] = [0, 1, 2**16 - 1, 2**32 - 1, 0xFFFF_0000, 0x8000_0001, 0x7FFF_FFFF, 2**31]
    return a


@pytest.mark.parametrize("iters", [1, 2, 3, 4, 8, 15, 16, 17, 31, 32])
@pytest.mark.parametrize("fn", ["square", "mul"])
def test_residue_identity_equals_the_reference_kernel(fn, iters):
    """The stages telescope: ilm_square(x) = x*x - r*r and ilm_mul(x, y) =
    x*y - rx*ry (mod 2^32), r being the operand with its top ``iters`` set
    bits cleared. The squarer kernel computes the first; written here in
    torch on int64 lanes, both equal the reference's Pallas kernels
    (interpret mode) bit for bit over all of uint32."""
    a = _full_range_operands(iters)
    x = ilm.as_u32_lanes(torch.from_numpy(a))
    rx = _residue(x, iters)
    if fn == "square":
        got = (_mul_mod32(x, x) - _mul_mod32(rx, rx)) & ilm.U32
        want = ref_ilm_k.ilm_square_2d(jnp.asarray(a), iters=iters, interpret=True)
    else:
        b = _full_range_operands(iters + 100)
        y = ilm.as_u32_lanes(torch.from_numpy(b))
        got = (_mul_mod32(x, y) - _mul_mod32(rx, _residue(y, iters))) & ilm.U32
        want = ref_ilm_k.ilm_mul_2d(jnp.asarray(a), jnp.asarray(b), iters=iters,
                                    interpret=True)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))


# ---------------------------------------------------- the ILM mode, bit for bit

def _bits_equal_or_count(got, want):
    got, want = got.numpy(), np.asarray(want)
    nan = np.isnan(got.astype(np.float32)) & np.isnan(want.astype(np.float32))
    ints = np.uint32 if got.dtype == np.float32 else np.uint16
    return int((~nan & (got.view(ints) != want.view(ints))).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ilm_recip_and_rsqrt_bit_exact_on_conformance_corpora(dtype):
    """Every stratum of the recip and rsqrt corpora, subnormals and edges
    included: 0 lanes differ (no F4 exception: the port flushes as XLA)."""
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    bad = {}
    for op, strata in (("recip", ulp.stratified_sweep(dtype, 1024, 1024)),
                       ("rsqrt", ulp.rsqrt_sweep(dtype, 1024, 1024))):
        for name, x in strata.items():
            x32 = np.asarray(x, np.float32)
            want = getattr(ref_dm, op)(jnp.asarray(x32).astype(jd), REF_ILM)
            got = getattr(dm, op)(torch.from_numpy(x32).to(td), ILM)
            assert got.dtype == td
            bad[(op, name)] = _bits_equal_or_count(got.float(), np.asarray(want, np.float32))
    assert not any(bad.values()), bad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ilm_div_bit_exact_on_conformance_corpora(dtype):
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    bad = {}
    for name, (a, b) in ulp.div_sweep(dtype, 1024, 1024).items():
        a32, b32 = np.asarray(a, np.float32), np.asarray(b, np.float32)
        want = ref_dm.div(jnp.asarray(a32).astype(jd), jnp.asarray(b32).astype(jd), REF_ILM)
        got = dm.div(torch.from_numpy(a32).to(td), torch.from_numpy(b32).to(td), ILM)
        bad[name] = _bits_equal_or_count(got.float(), np.asarray(want, np.float32))
    assert not any(bad.values()), bad


def test_ilm_modes_on_random_bit_patterns():
    from test_torch_division_modes import AS, XS

    assert_bits_equal(dm.recip(torch.from_numpy(XS), ILM), ref_dm.recip(jnp.asarray(XS), REF_ILM))
    assert_bits_equal(dm.rsqrt(torch.from_numpy(XS), ILM), ref_dm.rsqrt(jnp.asarray(XS), REF_ILM))
    assert_bits_equal(dm.div(torch.from_numpy(AS), torch.from_numpy(XS), ILM),
                      ref_dm.div(jnp.asarray(AS), jnp.asarray(XS), REF_ILM))


@pytest.mark.parametrize("kw", [dict(n_iters=1, precision_bits=12), dict(n_iters=4),
                                dict(n_iters=7, precision_bits=53), dict(rsqrt_newton=1),
                                dict(rsqrt_newton=3, rsqrt_segments=8)])
def test_ilm_dials_bit_exact(kw):
    x = np.abs(ulp.sweep_logspace(2048, seed=4))
    cfg, rcfg = dm.DivisionConfig(mode="ilm", **kw), ref_dm.DivisionConfig(mode="ilm", **kw)
    assert_bits_equal(dm.recip(torch.from_numpy(x), cfg), ref_dm.recip(jnp.asarray(x), rcfg))
    assert_bits_equal(dm.rsqrt(torch.from_numpy(x), cfg), ref_dm.rsqrt(jnp.asarray(x), rcfg))


def test_ilm_gradients_match_jax_grad():
    rng = np.random.default_rng(6)
    x = rng.uniform(0.1, 10, 256).astype(np.float32)
    x[:4] = [0.0, np.inf, 1e-40, 3e38]
    a = rng.normal(size=256).astype(np.float32)
    for op in ("recip", "rsqrt"):
        want = jax.grad(lambda v: jnp.sum(getattr(ref_dm, op)(v, REF_ILM)))(jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_()
        getattr(dm, op)(xt, ILM).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    ga, gb = jax.grad(lambda p, q: jnp.sum(ref_dm.div(p, q, REF_ILM)), (0, 1))(
        jnp.asarray(a), jnp.asarray(x))
    at, bt = torch.from_numpy(a).requires_grad_(), torch.from_numpy(x).requires_grad_()
    dm.div(at, bt, ILM).sum().backward()
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(ga), rtol=1e-6, atol=0)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb), rtol=1e-6, atol=0)


def test_ilm_consumers_close_to_reference():
    """softmax and RMSNorm take the ILM through their twins. The 12-bit
    mantissa quantization turns a 1-ulp difference of the row sum (F3's exp,
    F5's sum order) into at most one 12-bit step of 1/sum: 2^-11 relative."""
    rng = np.random.default_rng(10)
    x = rng.normal(size=(16, 128)).astype(np.float32) * 3
    w = rng.normal(size=128).astype(np.float32)
    s = dm.softmax(torch.from_numpy(x), -1, ILM).numpy()
    np.testing.assert_allclose(s, np.asarray(ref_dm.softmax(jnp.asarray(x), -1, REF_ILM)),
                               rtol=2**-11, atol=1e-9)
    r = dm.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), ILM).numpy()
    np.testing.assert_allclose(r, np.asarray(ref_dm.rmsnorm(jnp.asarray(x), jnp.asarray(w),
                                                            REF_ILM)), rtol=2**-11, atol=1e-6)


def test_ilm_mode_is_approximate_and_keeps_the_edge_contract():
    """Ports of the reference's ILM-mode checks (test_division_modes,
    test_consumer_conformance, test_edge_semantics)."""
    x = torch.linspace(1.0, 2.0, 32)
    rel = (dm.recip(x, ILM) * x - 1).abs().max()
    assert 1e-8 < rel < 5e-3
    u = torch.linspace(1.0, 4.0, 512)
    rel = (dm.rsqrt(u, ILM) * u.sqrt() - 1).abs().max()
    assert 1e-6 < rel < 5e-3
    a = torch.tensor([1.0, -1.0, 1.0, -1.0, 0.0, np.inf, 1.0, 1.0, np.nan, 1.0, 6.0, -6.0])
    b = torch.tensor([0.0, 0.0, -0.0, -0.0, 0.0, np.inf, np.inf, -np.inf, 1.0, np.nan, 3.0, 3.0])
    q = dm.div(a, b, ILM)
    assert q[0] == np.inf and q[1] == -np.inf and q[2] == -np.inf and q[3] == np.inf
    assert q[4].isnan() and q[5].isnan() and q[8].isnan() and q[9].isnan()
    assert q[6] == 0 and not q[6].signbit() and q[7] == 0 and q[7].signbit()
    assert abs(q[10] - 2) < 0.05 and abs(q[11] + 2) < 0.05
    r = dm.rsqrt(torch.tensor([0.0, -0.0, np.inf, -np.inf, np.nan, 4.0, -4.0]), ILM)
    assert r[0] == np.inf and r[1] == -np.inf and r[2] == 0 and not r[2].signbit()
    assert r[3].isnan() and r[4].isnan() and abs(r[5] - 0.5) < 1e-3 and r[6].isnan()


# ------------------------------------------------ ports of tests/test_ilm.py

class TestNumpyILM:
    @given(st.integers(1, 2**24 - 1), st.integers(1, 2**24 - 1))
    @settings(max_examples=200, deadline=None)
    def test_exact_at_full_iterations(self, a, b):
        assert int(ilm.ilm_mul_np(a, b, 24)[()]) == a * b

    @given(st.integers(1, 2**24 - 1))
    @settings(max_examples=200, deadline=None)
    def test_square_exact(self, a):
        assert int(ilm.ilm_square_np(a, 24)[()]) == a * a

    def test_error_decays_monotonically(self):
        rng = np.random.default_rng(0)
        a = torch.from_numpy(rng.integers(1, 2**16, 5000))
        b = torch.from_numpy(rng.integers(1, 2**16, 5000))
        exact = a * b
        prev = None
        for iters in range(1, 17):
            p = ilm.ilm_mul(a, b, iters)
            assert bool((p <= exact).all())     # the ILM truncates E >= 0
            err = float((exact - p).sum())
            if prev is not None:
                assert err <= prev
            prev = err
        assert prev == 0.0

    def test_one_iteration_is_mitchell(self):
        """iters=1 reproduces Mitchell's error profile (<= 25%)."""
        rng = np.random.default_rng(1)
        a = rng.integers(1, 2**20, 10_000).astype(np.uint64)
        b = rng.integers(1, 2**20, 10_000).astype(np.uint64)
        p = ilm.ilm_mul_np(a, b, 1)
        rel = (a * b - p).astype(np.float64) / (a * b).astype(np.float64)
        assert 0.10 < rel.max() <= 0.25 + 1e-9

    def test_floor_log2(self):
        xs = np.asarray([1, 2, 3, 4, 7, 8, 255, 256, 2**31], np.uint64)
        assert list(ilm.floor_log2_np(xs)) == [0, 1, 1, 2, 2, 3, 7, 8, 31]


class TestTorchILM:
    @given(st.integers(1, 2**16 - 1), st.integers(1, 2**16 - 1), st.integers(1, 16))
    @settings(max_examples=100, deadline=None)
    def test_matches_numpy_twin(self, a, b, iters):
        got = int(ilm.ilm_mul(torch.tensor(a), torch.tensor(b), iters))
        assert got == int(ilm.ilm_mul_np(a, b, iters)[()])

    @given(st.integers(1, 2**16 - 1))
    @settings(max_examples=100, deadline=None)
    def test_square_exact_16bit(self, a):
        assert int(ilm.ilm_square(torch.tensor(a), 16)) == a * a


class TestFpEmulation:
    def test_fp_mul_accuracy_by_iters(self):
        rng = np.random.default_rng(2)
        x = rng.uniform(-100, 100, 2000)
        y = rng.uniform(0.01, 100, 2000)
        prev = None
        for iters in (1, 2, 4, 8, 24):
            p = ilm.fp_mul_ilm_np(x, y, iters=iters, mant_bits=24)
            np.testing.assert_array_equal(p, ref_ilm.fp_mul_ilm_np(x, y, iters=iters, mant_bits=24))
            rel = np.max(np.abs(p - x * y) / np.abs(x * y))
            if prev is not None:
                assert rel <= prev * (1 + 1e-12)
            prev = rel
        assert prev < 1e-6

    def test_full_datapath_recip(self):
        """Fig. 7 system: PWL seed + ILM-powered Taylor series, end to end."""
        x = np.random.default_rng(3).uniform(1.0, 2.0, 500)
        r = ilm.fp_recip_ilm_np(x, iters_mul=24, n_terms=5)
        np.testing.assert_array_equal(r, ref_ilm.fp_recip_ilm_np(x, iters_mul=24, n_terms=5))
        assert np.max(np.abs(r * x - 1.0)) < 2**-22


# ------------------------------- the ILM cases of tests/test_powering.py

def test_powering_unit_through_the_ilm():
    """The §6 schedule evaluated with the ILM multiplier and squarer gives
    the powers to the 24-bit quantization."""
    x = 0.9371
    powers = powering.eval_powers(
        x, 9, mul=lambda a, b: ilm.fp_mul_ilm_np(a, b, iters=24),
        square=lambda a: ilm.fp_mul_ilm_np(a, a, iters=24))
    for k in range(2, 10):
        assert abs(float(powers[k]) - x**k) < 2**-20 * x**k


def test_squarer_under_half():
    from repro.core import powering as ref_powering

    hw = powering.hw_cost()
    assert hw["area_ratio"] < 0.5 and hw["unit_ratio"] < 0.5     # paper §5
    m, s = hw["multiplier"], hw["squarer"]
    assert m.priority_encoder == 2 * s.priority_encoder and m.lod == 2 * s.lod
    assert s.decoder == 0
    want = ref_powering.hw_cost()
    assert (hw["area_ratio"], hw["unit_ratio"]) == (want["area_ratio"], want["unit_ratio"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ilm_softmax_masked_matrix(dtype):
    """The reference's masked-softmax contract in the ILM mode: all-False
    row -> zeros, single survivor -> one-hot, the rest renormalise."""
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(3, 16))).to(dtype)
    where = torch.from_numpy(np.stack([np.zeros(16, bool), np.eye(16, dtype=bool)[5],
                                       np.arange(16) < 9]))
    s = dm.softmax(x, -1, ILM, where=where).float()
    assert bool((s[0] == 0).all()) and bool((s[1, torch.arange(16) != 5] == 0).all())
    assert abs(float(s[1, 5]) - 1.0) <= 2e-3 and bool((s[2, 9:] == 0).all())
    assert abs(float(s[2].sum()) - 1.0) <= (1e-2 if dtype == torch.bfloat16 else 2e-3)
    assert bool(torch.isfinite(s).all())
