"""The port's softmax / RMSNorm consumers against the live reference.

The reference's Pallas modes run their kernels in interpret mode, as its own
tests run them; the port's run the kernels' plain versions (CPU tensors).
Both get the same seeded numpy rows.

Bit for bit where the result does not depend on the backend's exp or on the
order of the row sum: constant rows and rows of {max, -inf} (every exp is 1
or 0, every sum an exact integer), and RMSNorm rows of small integers (exact
squares and sums). Elsewhere two measured facts separate the packages: XLA's
CPU exp differs from torch's on ~10% of lanes (ROADMAP F3), and the port's
kernels sum a row in their own fixed order (``common.row_sum``), not XLA's.
On lanes whose f64 result is normal the port stays within
``SOFTMAX_VS_REF_ULP`` / ``RMSNORM_VS_REF_ULP`` int ulp of the reference
(measured maxima: 12 and 5, over seeds 1-3 and D = 128, 300, 768, 2176).
Lanes whose result is subnormal differ by design: XLA on the CPU flushes
them, torch keeps them (F4).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import division_modes as ref_dm
from repro.core.seeds import rsqrt_seed_table as ref_rsqrt_table
from repro.eval import consumers as ref_consumers
from repro.kernels import common as ref_common
from repro.kernels import ops as ref_ops
from repro_torch.core import division_modes as dm
from repro_torch.core.seeds import compute_segments, rsqrt_seed_table
from repro_torch.eval import consumers, ulp
from repro_torch.kernels import common, ops, ref, rmsnorm, softmax
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCHEDULES = ["paper", "factored", "goldschmidt"]
SOFTMAX_VS_REF_ULP = 16
RMSNORM_VS_REF_ULP = 8
NON_ILM = [("exact", "factored"), ("taylor", "paper"), ("taylor", "factored"),
           ("taylor_pallas", "paper"), ("taylor_pallas", "factored"),
           ("goldschmidt", "factored"), ("goldschmidt_pallas", "factored")]


def _np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else t.detach().numpy()


def _ref_np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def assert_bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = np.isnan(got) & np.isnan(want)
    bad = ~nan & (got.view(np.uint32) != want.view(np.uint32))
    assert not bad.any(), f"{int(bad.sum())} lanes differ: {got[bad][:5]} vs {want[bad][:5]}"


def order_free_softmax_rows(d: int, seed: int) -> np.ndarray:
    """Constant rows and rows of {max, -inf}: exps of 0 and -inf only."""
    rng = np.random.default_rng(seed)
    const = np.repeat(rng.normal(0, 10, (8, 1)), d, axis=1)
    two = np.where(rng.random((8, d)) < 0.4, -np.inf, rng.normal(0, 10, (8, 1)))
    two[:, 0] = rng.normal(0, 10, 8)                 # at least one finite logit
    two = np.where(np.isfinite(two), two[:, :1], two)
    return np.concatenate([const, two]).astype(np.float32)


def integer_rows(d: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(-3, 4, (48, d)).astype(np.float32)


# ------------------------------------------------------- the plain versions

@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("d", [16, 128, 300])
def test_plain_softmax_bit_exact_on_order_free_rows(schedule, d):
    x = order_free_softmax_rows(d, d)
    want = ref_ops.softmax(jnp.asarray(x), 2, 24, schedule)
    assert_bits_equal(ops.softmax(torch.from_numpy(x), 2, 24, schedule).numpy(), want)


@pytest.mark.parametrize("d", [100, 128, 768])
def test_plain_rmsnorm_bit_exact_on_integer_rows(d):
    x = integer_rows(d, d)
    w = consumers.rmsnorm_weight(d, seed=1)
    want = ref_ops.rmsnorm(jnp.asarray(x), jnp.asarray(w))
    assert_bits_equal(ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(), want)


def _within(got, want, oracle, tol):
    d = ulp.ulp_diff(np.asarray(got), np.asarray(want))
    normal = ulp.oracle_mask(oracle, "float32")
    worst = int(np.where(normal, d, 0).max())
    assert worst <= tol, f"{worst} int ulp on oracle-normal lanes"
    return normal


@pytest.mark.parametrize("d", [128, 300])
def test_plain_softmax_close_on_the_corpus(d):
    for name, x in consumers.softmax_rows("float32", 16, d, seed=1).items():
        want = np.asarray(ref_ops.softmax(jnp.asarray(x), 2, 24, "paper"))
        got = ops.softmax(torch.from_numpy(x), 2, 24, "paper").numpy()
        normal = _within(got, want, consumers.softmax_oracle(x.astype(np.float64)),
                         SOFTMAX_VS_REF_ULP)
        # Subnormal results: the reference flushes them (XLA's CPU FTZ).
        assert np.all(want[~normal & (np.abs(want) < 2.0 ** -126)] == 0.0), name


@pytest.mark.parametrize("d", [128, 768])
def test_plain_rmsnorm_close_on_the_corpus(d):
    w = consumers.rmsnorm_weight(d, seed=1)
    for x in consumers.rmsnorm_rows("float32", 16, d, seed=1).values():
        want = ref_ops.rmsnorm(jnp.asarray(x), jnp.asarray(w))
        got = ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
        _within(got, want, consumers.rmsnorm_oracle(x.astype(np.float64),
                                                    w.astype(np.float64)),
                RMSNORM_VS_REF_ULP)


def _warp_row_sum(v: torch.Tensor) -> torch.Tensor:
    """The RMSNorm kernel's sum (csrc/rmsnorm.cu, rows.cuh warp_tree_sum),
    modelled lane by lane: lane l holds elements c*256 + 8l + j of chunk c
    in slot j, added chunk by chunk onto +0 (past the row's end: 0); then
    shuffles down by 16, 8, 4, 2, 1 lanes (a lane whose source is past the
    warp reads its own value, as __shfl_down_sync gives), then slots j + 4,
    j + 2, j + 1 onto j inside lane 0."""
    lanes = 32
    per = common.REDUCE_THREADS // lanes
    d = v.shape[-1]
    chunks = -(-d // common.REDUCE_THREADS)
    g = torch.nn.functional.pad(v, (0, chunks * common.REDUCE_THREADS - d))
    g = g.reshape(*v.shape[:-1], chunks, lanes, per)
    p = torch.zeros(v.shape[:-1] + (lanes, per), dtype=v.dtype)
    for c in range(chunks):
        p = p + g[..., c, :, :]
    for off in (16, 8, 4, 2, 1):
        src = torch.arange(lanes) + off
        p = p + p[..., torch.where(src < lanes, src, torch.arange(lanes)), :]
    q = p[..., 0, :]
    for h in (4, 2, 1):
        q = q[..., :h] + q[..., h:2 * h]
    return q


@pytest.mark.parametrize("d", [1, 100, 768, 2176, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_layout_sums_in_the_row_sum_order(d, dtype):
    """One warp per row gives common.row_sum's bits: the squares of seeded
    rows over six decades of scale, f32 or cast to bf16 first."""
    rng = np.random.default_rng(d)
    x = rng.normal(0, 1, (24, d)) * 10.0 ** rng.uniform(-3, 3, (24, 1))
    xf = torch.from_numpy(x.astype(np.float32)).to(dtype).to(torch.float32)
    want = common.row_sum(xf * xf)
    got = _warp_row_sum(xf * xf)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _warp_softmax(x: torch.Tensor, table, n_iters: int, schedule: str) -> torch.Tensor:
    """The softmax kernel (csrc/softmax.cu) modelled lane by lane: lane l
    holds elements c*256 + 8l + j of chunk c in slot j, -inf past the row's
    end; each lane's max over its slots, then shuffles (xor 16, 8, 4, 2, 1)
    that give every lane the warp's max, nan propagating; ex = exp(x - mfin)
    in the layout (exp(-inf) = +0 past the end); _warp_row_sum's additions
    of ex; one recip_f32_bits a row (lane 0's); ex * (1/s), 0 where s is 0."""
    lanes, t = 32, common.REDUCE_THREADS
    per = t // lanes
    d = x.shape[-1]
    chunks = -(-d // t)
    g = torch.nn.functional.pad(x.to(torch.float32), (0, chunks * t - d), value=-torch.inf)
    g = g.reshape(-1, chunks, lanes, per)
    mx = g.amax(dim=(1, 3))
    for off in (16, 8, 4, 2, 1):
        mx = torch.maximum(mx, mx[:, torch.arange(lanes) ^ off])
    assert torch.equal(mx.isnan(), mx[:, :1].isnan().expand_as(mx))
    m = mx[:, :1, None, None]
    ex = torch.exp(g - torch.where(torch.isfinite(m), m, 0.0))
    s = _warp_row_sum(ex.reshape(-1, chunks * t))[..., None, None]
    rs = common.recip_f32_bits(s, table, n_iters, schedule)
    out = torch.where(s == 0.0, 0.0, ex * rs).reshape(-1, chunks * t)[:, :d]
    return out.to(x.dtype)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 100, 768, 2048, 2112, 2176, 8192])
def test_warp_softmax_model_gives_the_plain_versions_bits(d, dtype, schedule):
    """The warp-per-row kernel's arithmetic (_warp_softmax) gives
    softmax_plain's bits: the corpus, the edge rows, a row holding a +inf
    logit and an all-negative row (whose max a past-end fill of 0 would
    replace)."""
    rng = np.random.default_rng(d)
    extra = rng.normal(0, 4, (2, d))
    extra[0, d // 3] = np.inf
    extra[1] = -np.abs(extra[1]) - 200.0
    x = np.concatenate([*consumers.softmax_rows("float32", 4, d, seed=d).values(),
                        consumers.softmax_edge_rows("float32", d), extra]).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    table = compute_segments(2, 24)
    want = softmax.softmax_plain(xt, table, 2, schedule)
    got = _warp_softmax(xt, table, 2, schedule)
    assert got.dtype == want.dtype == dtype
    ints = torch.int32 if dtype == torch.float32 else torch.int16
    same = (got.view(ints) == want.view(ints)) | (got.isnan() & want.isnan())
    assert bool(same.all()), f"{int((~same).sum())} lanes differ"
    assert bool((want[-1].float().sum() > 0.5) & torch.isfinite(want[-1].float()).all())


def test_corpora_equal_the_reference():
    for d in (16, 128):
        for mine, theirs in ((consumers.softmax_rows("float32", 8, d, 3),
                              ref_consumers.softmax_rows("float32", 8, d, 3)),
                             (consumers.rmsnorm_rows("float32", 8, d, 3),
                              ref_consumers.rmsnorm_rows("float32", 8, d, 3))):
            assert mine.keys() == theirs.keys()
            for k in mine:
                np.testing.assert_array_equal(mine[k], theirs[k])
        np.testing.assert_array_equal(consumers.softmax_edge_rows("float32", d),
                                      ref_consumers.softmax_edge_rows("float32", d))
        np.testing.assert_array_equal(consumers.rmsnorm_weight(d, 2),
                                      ref_consumers.rmsnorm_weight(d, 2))
    assert consumers.ROW_SUM_GATE_ULP == ref_consumers.ROW_SUM_GATE_ULP == 2
    assert consumers.VS_EXACT_GATE_ULP == ref_consumers.VS_EXACT_GATE_ULP == 4


def test_rsqrt_f32_bit_exact_vs_the_compiled_reference():
    x = np.exp2(np.random.default_rng(0).uniform(-120, 120, 1 << 14)).astype(np.float32)
    for n in (1, 2, 3):
        want = jax.jit(functools.partial(ref_common.rsqrt_f32, table=ref_rsqrt_table(16),
                                         newton_iters=n))(jnp.asarray(x))
        assert_bits_equal(common.rsqrt_f32(torch.from_numpy(x), rsqrt_seed_table(16), n).numpy(),
                          want)


def test_the_fused_sites_are_needed():
    """The compiled reference fuses ss*(1/d) + eps and leaves x*x unfused in
    the sum: rounding the first twice, or fusing the second, moves rows."""
    table = rsqrt_seed_table(16)

    def variant(x, fuse_sq, fuse_se):
        xt = torch.from_numpy(x)
        ss = common.row_sum((xt, xt), common.fma) if fuse_sq else common.row_sum(xt * xt)
        inv = float(np.float32(1.0 / x.shape[-1]))
        se = common.fma(ss, inv, 1e-6) if fuse_se else ss * np.float32(inv) + np.float32(1e-6)
        return (xt * common.rsqrt_f32(se, table, 2)).numpy()

    # exact sums; 1/768 is inexact, so ss*(1/d) rounds (on ~2% of rows it
    # then moves the sum with eps)
    x = np.random.default_rng(5).integers(-3, 4, (1024, 768)).astype(np.float32)
    # one tiny exact square at lane 0, one inexact square at lane 256: the
    # same thread's chain, so a fused x*x rounds them once
    y = np.zeros((256, 384), np.float32)
    y[:, 0] = np.float32(0.8125 * 2.0 ** -12)
    y[:, 256] = np.random.default_rng(6).uniform(1.0, 1.41, 256).astype(np.float32)
    ones_x, ones_y = np.ones(768, np.float32), np.ones(384, np.float32)
    moved = {}
    for name, rows, w in (("se", x, ones_x), ("sq", y, ones_y)):
        want = np.asarray(ref_ops.rmsnorm(jnp.asarray(rows), jnp.asarray(w)))
        assert_bits_equal(variant(rows, False, True), want)      # the kernel's sites
        assert_bits_equal(rmsnorm.rmsnorm_plain(torch.from_numpy(rows), torch.from_numpy(w),
                                                1e-6, table, 2).numpy(), want)
        wrong = variant(rows, name == "sq", name != "se")
        moved[name] = int((wrong.view(np.uint32) != want.view(np.uint32)).any(-1).sum())
    print("rows moved by the wrong rounding:", moved)
    assert moved["se"] > 0 and moved["sq"] > 0


# ---------------------------------------------------- division_modes, every mode

def _pair(mode, sched):
    return (dm.DivisionConfig(mode=mode, schedule=sched),
            ref_dm.DivisionConfig(mode=mode, schedule=sched))


@pytest.mark.parametrize("mode,sched", NON_ILM)
def test_division_modes_softmax_and_rmsnorm_vs_reference(mode, sched):
    cfg, rcfg = _pair(mode, sched)
    x = order_free_softmax_rows(128, 9)
    assert_bits_equal(dm.softmax(torch.from_numpy(x), -1, cfg).numpy(),
                      ref_dm.softmax(jnp.asarray(x), -1, rcfg))
    xi = integer_rows(128, 9)
    w = consumers.rmsnorm_weight(128, 9)
    got = dm.rmsnorm(torch.from_numpy(xi), torch.from_numpy(w), cfg).numpy()
    want = np.asarray(ref_dm.rmsnorm(jnp.asarray(xi), jnp.asarray(w), rcfg))
    if mode in ("taylor_pallas", "goldschmidt_pallas"):
        assert_bits_equal(got, want)
    else:   # the twins' mean: sum / d here, jnp.mean's reduction there
        _within(got, want, consumers.rmsnorm_oracle(xi.astype(np.float64),
                                                    w.astype(np.float64)), RMSNORM_VS_REF_ULP)
    for name, xs in consumers.softmax_rows("float32", 8, 128, seed=2).items():
        _within(dm.softmax(torch.from_numpy(xs), -1, cfg).numpy(),
                ref_dm.softmax(jnp.asarray(xs), -1, rcfg),
                consumers.softmax_oracle(xs.astype(np.float64)), SOFTMAX_VS_REF_ULP)


@pytest.mark.parametrize("mode,sched", NON_ILM)
def test_consumer_gates(mode, sched):
    """The reference's gates on its own corpora (tests/test_consumer_
    conformance.py): row sums within 2 ULP-equivalents of 1, within 4 int
    ulp of the exact twin (the twins share the kernels' sum order, so the
    difference is the division unit's)."""
    cfg = dm.DivisionConfig(mode=mode, schedule=sched)
    for x in consumers.softmax_rows("float32", n_rows=32, d=128, seed=5).values():
        xt = torch.from_numpy(x)
        out = dm.softmax(xt, -1, cfg).numpy()
        assert consumers.row_sum_ulp1(out).max() <= consumers.ROW_SUM_GATE_ULP
        twin = dm.softmax(xt, -1, dm.EXACT).numpy()
        assert consumers.vs_exact_int_ulp(out, twin, consumers.softmax_oracle(
            x.astype(np.float64))) <= consumers.VS_EXACT_GATE_ULP
    w = consumers.rmsnorm_weight(128, seed=6)
    for x in consumers.rmsnorm_rows("float32", n_rows=32, d=128, seed=6).values():
        xt, wt = torch.from_numpy(x), torch.from_numpy(w)
        out = dm.rmsnorm(xt, wt, cfg).numpy()
        twin = dm.rmsnorm(xt, wt, dm.EXACT).numpy()
        assert consumers.vs_exact_int_ulp(out, twin, consumers.rmsnorm_oracle(
            x.astype(np.float64), w.astype(np.float64))) <= consumers.VS_EXACT_GATE_ULP


@pytest.mark.parametrize("mode,sched", NON_ILM)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_rows_are_zero(mode, sched, dtype):
    """all-False row -> zeros; single survivor -> one-hot; the rest
    renormalise; all -inf rows -> zeros; all NEG_INF rows -> uniform, as the
    reference gives them."""
    cfg, rcfg = _pair(mode, sched)
    x = np.random.default_rng(3).normal(size=(3, 16)).astype(np.float32)
    where = np.stack([np.zeros(16, bool), np.eye(16, dtype=bool)[5], np.arange(16) < 9])
    s = _np(dm.softmax(torch.from_numpy(x).to(dtype), -1, cfg, where=torch.from_numpy(where)))
    assert np.all(s[0] == 0.0) and np.all(s[1, np.arange(16) != 5] == 0.0)
    assert abs(s[1, 5] - 1.0) <= 2e-6 and np.all(s[2, 9:] == 0.0)
    assert abs(s[2].sum() - 1.0) <= (1e-2 if dtype == torch.bfloat16 else 2e-6)
    rows = np.array([[-np.inf] * 8, [-1e30] * 8, [0.0] + [-np.inf] * 7], np.float32)
    got = _np(dm.softmax(torch.from_numpy(rows).to(dtype), -1, cfg))
    want = _ref_np(ref_dm.softmax(jnp.asarray(rows, jnp.bfloat16 if dtype == torch.bfloat16
                                              else jnp.float32), -1, rcfg))
    np.testing.assert_array_equal(got, want)
    assert np.all(got[0] == 0) and np.all(np.abs(got[1] - 0.125) <= 2e-7)
    assert abs(got[2, 0] - 1.0) <= 2e-7 and np.all(got[2, 1:] == 0)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_edge_rows_match_the_reference(schedule):
    x = consumers.softmax_edge_rows("float32", 16)
    got = ops.softmax(torch.from_numpy(x), 2, 24, schedule).numpy()
    assert_bits_equal(got, ref_ops.softmax(jnp.asarray(x), 2, 24, schedule))
    assert np.all(got[0] == 0) and abs(got[1, 0] - 1.0) <= 2e-7 and np.isnan(got[2]).all()
    r = np.zeros((4, 16), np.float32)
    r[1] = 3e38                               # x*x overflows: scales by 0 (nan at inf*0)
    r[2, 3] = np.inf
    r[3, 5] = np.nan
    w = np.ones(16, np.float32)
    got = ops.rmsnorm(torch.from_numpy(r), torch.from_numpy(w)).numpy()
    assert_bits_equal(got, ref_ops.rmsnorm(jnp.asarray(r), jnp.asarray(w)))
    assert np.all(got[0] == 0) and np.all(got[1] == 0) and np.isnan(got[3]).all()


def test_bf16_rows_match_the_reference():
    x = order_free_softmax_rows(128, 4)
    got = ops.softmax(torch.from_numpy(x).to(torch.bfloat16), 2, 24, "paper")
    want = ref_ops.softmax(jnp.asarray(x, jnp.bfloat16), 2, 24, "paper")
    np.testing.assert_array_equal(got.float().numpy(), _ref_np(want))
    xi = integer_rows(768, 4)
    w = consumers.rmsnorm_weight(768, 4)
    got = ops.rmsnorm(torch.from_numpy(xi).to(torch.bfloat16), torch.from_numpy(w))
    want = ref_ops.rmsnorm(jnp.asarray(xi, jnp.bfloat16), jnp.asarray(w))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), _ref_np(want))


def test_axes_where_and_degenerate_shapes():
    cfg = dm.DivisionConfig(mode="taylor_pallas")
    x = np.random.default_rng(2).normal(size=(16, 8, 5)).astype(np.float32)
    for axis in (0, 1, -1):
        got = dm.softmax(torch.from_numpy(x), axis, cfg).numpy()
        np.testing.assert_allclose(got, jax.nn.softmax(jnp.asarray(x), axis), atol=1e-6)
    where = np.random.default_rng(3).random((8, 1)) < 0.5        # broadcasts
    got = dm.softmax(torch.from_numpy(x), 1, cfg, where=torch.from_numpy(where)).numpy()
    want = ref_dm.softmax(jnp.asarray(x), 1, ref_dm.DivisionConfig(mode="taylor_pallas"),
                          where=jnp.asarray(where))
    np.testing.assert_allclose(got, want, atol=1e-6)
    for mode in ("exact", "taylor", "taylor_pallas"):
        c = dm.DivisionConfig(mode=mode)
        assert dm.softmax(torch.tensor(3.0), -1, c).item() == 1.0
        assert dm.softmax(torch.zeros(4, 0), -1, c).shape == (4, 0)
        assert dm.rmsnorm(torch.zeros(4, 0), torch.zeros(0), c).shape == (4, 0)
        assert dm.softmax(torch.zeros(0, 4), -1, c).shape == (0, 4)


def test_kernel_modes_dispatch_to_the_fused_kernels(monkeypatch):
    seen = []
    real_sm, real_rms = ops.softmax, ops.rmsnorm
    monkeypatch.setattr(ops, "softmax", lambda x, n, p, s: seen.append(("softmax", s))
                        or real_sm(x, n, p, s))
    monkeypatch.setattr(ops, "rmsnorm", lambda x, w, e, n, k: seen.append(("rmsnorm", n, k))
                        or real_rms(x, w, e, n, k))
    real_fa = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda q, k, v, c, **kw: seen.append(
        ("flash", kw["schedule"])) or real_fa(q, k, v, c, **kw))
    x, w = torch.randn(4, 32), torch.ones(32)
    for mode in ("taylor_pallas", "goldschmidt_pallas"):
        dm.softmax(x, -1, dm.DivisionConfig(mode=mode, schedule="paper"))
        dm.rmsnorm(x, w, dm.DivisionConfig(mode=mode, rsqrt_newton=3))
        dm.attention(x, x, x, dm.DivisionConfig(mode=mode, schedule="paper"))
    assert seen == [("softmax", "paper"), ("rmsnorm", 3, 16), ("flash", "paper"),
                    ("softmax", "goldschmidt"), ("rmsnorm", 3, 16), ("flash", "goldschmidt")]
    seen.clear()
    for mode in ("exact", "taylor", "goldschmidt", "ilm"):
        dm.softmax(x, -1, dm.DivisionConfig(mode=mode))
        dm.rmsnorm(x, w, dm.DivisionConfig(mode=mode))
        dm.attention(x, x, x, dm.DivisionConfig(mode=mode))
    assert seen == []


def test_ref_oracles_are_the_plain_versions():
    x = consumers.softmax_rows("float32", 4, 64, 0)["gaussian"]
    xt = torch.from_numpy(x)
    torch.testing.assert_close(ref.softmax_ref(xt), softmax.softmax_plain(
        xt, compute_segments(2, 24), 2, "factored"), rtol=0, atol=0)
    w = torch.from_numpy(consumers.rmsnorm_weight(64))
    torch.testing.assert_close(ref.rmsnorm_ref(xt, w), ops.rmsnorm(xt, w), rtol=0, atol=0)
    torch.testing.assert_close(ref.softmax_exact(xt), torch.softmax(xt, -1))
    np.testing.assert_allclose(ref.rmsnorm_exact(xt, w).numpy(),
                               ref_ops.rmsnorm(jnp.asarray(x), jnp.asarray(w.numpy())),
                               rtol=2e-6)


# ------------------------------------------------------------------- VJPs

def test_vjps_match_jax_grad():
    rng = np.random.default_rng(11)
    x = rng.normal(0, 2, (6, 40)).astype(np.float32)
    x[0] = -np.inf                                        # a masked row
    g = rng.normal(size=(6, 40)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    ops.softmax(xt, 2, 24, "paper").backward(torch.from_numpy(g))
    want = jax.vjp(lambda v: ref_ops.softmax(v, 2, 24, "paper"), jnp.asarray(x))[1](
        jnp.asarray(g))[0]
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5, atol=1e-6)
    assert np.all(xt.grad.numpy()[0] == 0)
    x = rng.normal(0, 2, (6, 40)).astype(np.float32)
    w = rng.normal(1, 0.5, 40).astype(np.float32)
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    ops.rmsnorm(xt, wt).backward(torch.from_numpy(g))
    gx, gw = jax.vjp(lambda a, b: ref_ops.rmsnorm(a, b), jnp.asarray(x), jnp.asarray(w))[1](
        jnp.asarray(g))
    np.testing.assert_allclose(xt.grad.numpy(), gx, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), gw, rtol=1e-5, atol=1e-5)


def test_twin_gradients_are_finite_on_masked_rows():
    x = torch.randn(2, 8, requires_grad=True)
    where = torch.tensor([[False] * 8, [True] * 8])
    for mode, sched in NON_ILM:
        (g,) = torch.autograd.grad(
            dm.softmax(x, -1, dm.DivisionConfig(mode=mode, schedule=sched),
                       where=where)[1].sum(), x)
        assert torch.isfinite(g).all(), mode


@pytest.mark.parametrize("mode", ["taylor_pallas", "goldschmidt_pallas"])
@pytest.mark.parametrize("weight", ["float16", "strided"])
def test_rmsnorm_kernel_modes_take_any_weight(mode, weight):
    """A weight that the kernel does not read as it is (float16, or f32 not
    contiguous) is cast to a contiguous f32 weight first, as the reference's
    kernel casts it: the result equals the call with that f32 weight bit for
    bit, and the reference within the row-sum order's tolerance (F5)."""
    cfg, rcfg = _pair(mode, "factored" if mode == "taylor_pallas" else "goldschmidt")
    d = 768
    w32 = consumers.rmsnorm_weight(d, 3)
    if weight == "float16":
        w_np = w32.astype(np.float16)
        w = torch.from_numpy(w_np)
    else:
        w_np = w32
        w = torch.from_numpy(np.repeat(w32, 2))[::2]
        assert not w.is_contiguous()
    for x in consumers.rmsnorm_rows("float32", 8, d, seed=3).values():
        xt = torch.from_numpy(x)
        got = dm.rmsnorm(xt, w, cfg)
        assert_bits_equal(got.numpy(),
                          dm.rmsnorm(xt, w.to(torch.float32).contiguous(), cfg).numpy())
        want = ref_dm.rmsnorm(jnp.asarray(x), jnp.asarray(w_np), rcfg)
        _within(got.numpy(), want, consumers.rmsnorm_oracle(
            x.astype(np.float64), w_np.astype(np.float64)), RMSNORM_VS_REF_ULP)
