"""The reference's f64 numpy oracles and golden-store generators, ported.

``core/taylor.py`` ``reciprocal_np`` / ``divide_np`` / ``rsqrt_np`` and
``core/goldschmidt.py`` ``reciprocal_np`` / ``divide_np`` run the port's
series, seed and Newton code in torch f64 on the CPU with the reference's
53-bit tables; they are held bit for bit against the reference's oracles on
the golden corpora and on IEEE and f64-range edges. ``eval/golden.py``'s
corpora are the reference's arrays bit for bit, and its generators, run on
the CPU (the kernels' plain versions), write the committed reciprocal,
divide and rsqrt stores' arrays bit for bit; the softmax store is held
within ``SOFTMAX_TOLERANCE_ULP`` int ulp on its oracle-normal lanes (F1,
F3, F5). No lane of the oracles differs from the reference's. Their
recombine does not rest on ``torch.ldexp``, documented as ``input *
2**other`` (a power of two that overflows at 2^1024 and flushes below
2^-1074 where the product is representable): ``fpparts.ldexp64`` rounds
once, as numpy's ``ldexp`` (``test_ldexp64_is_numpys``).
"""
import warnings

import numpy as np
import pytest
import torch

from repro.core import goldschmidt as ref_goldschmidt
from repro.core import taylor as ref_taylor
from repro.eval import golden as ref_golden
from repro_torch.core import fpparts, goldschmidt, taylor
from repro_torch.eval import golden
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

# f64 lanes at the edges of the range and the IEEE specials: subnormal and
# near-overflow operands, whose reciprocals and quotients leave the range.
F64_EDGES = np.array([5e-324, 1e-310, 2.2250738585072014e-308, 1.5 * 2.0 ** -1022, 1e308,
                      1.7976931348623157e308, 2.0 ** 1023, -1e-320, -3.5e307, 0.0, -0.0,
                      np.inf, -np.inf, np.nan, 0.75, 3.0, -1.0], np.float64)


def _same_bits(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    same = (got.view(np.int64) == want.view(np.int64)) | (np.isnan(got) & np.isnan(want))
    assert same.all(), (f"{int((~same).sum())} lanes differ, first at "
                        f"{np.argwhere(~same)[0].tolist()}: {got[~same][:3]} vs {want[~same][:3]}")


def _pairs():
    a, b = ref_golden.golden_div_inputs()
    ea, eb = np.meshgrid(F64_EDGES, F64_EDGES)
    return [(a, b), (ref_golden.golden_numerators(515), ref_golden.golden_inputs()),
            (ea.ravel(), eb.ravel())]


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)    # the reference's inf/nan lanes
        yield


# ------------------------------------------------------------------- oracles

@pytest.mark.parametrize("n_iters", [None, 2])
@pytest.mark.parametrize("schedule", ["paper", "factored"])
def test_taylor_reciprocal_oracle_is_the_references(schedule, n_iters):
    for x in (ref_golden.golden_inputs(), ref_golden.golden_rsqrt_inputs(), F64_EDGES):
        got = taylor.reciprocal_np(x, n_iters=n_iters, schedule=schedule)
        assert isinstance(got, np.ndarray) and got.dtype == np.float64
        _same_bits(got, ref_taylor.reciprocal_np(x, n_iters=n_iters, schedule=schedule))


@pytest.mark.parametrize("n_iters", [None, 2])
@pytest.mark.parametrize("schedule", ["paper", "factored"])
def test_taylor_divide_oracle_is_the_references(schedule, n_iters):
    for a, b in _pairs():
        _same_bits(taylor.divide_np(a, b, n_iters=n_iters, schedule=schedule),
                   ref_taylor.divide_np(a, b, n_iters=n_iters, schedule=schedule))


@pytest.mark.parametrize("newton_iters", [1, 2, 3])
def test_rsqrt_oracle_is_the_references(newton_iters):
    for x in (ref_golden.golden_rsqrt_inputs(), ref_golden.golden_inputs(), F64_EDGES):
        _same_bits(taylor.rsqrt_np(x, newton_iters=newton_iters),
                   ref_taylor.rsqrt_np(x, newton_iters=newton_iters))


@pytest.mark.parametrize("iters", [1, 2, 3])
def test_goldschmidt_oracles_are_the_references(iters):
    for x in (ref_golden.golden_inputs(), F64_EDGES):
        _same_bits(goldschmidt.reciprocal_np(x, iters=iters),
                   ref_goldschmidt.reciprocal_np(x, iters=iters))
    for a, b in _pairs():
        _same_bits(goldschmidt.divide_np(a, b, iters=iters),
                   ref_goldschmidt.divide_np(a, b, iters=iters))


def test_oracles_take_array_likes_and_keep_the_edge_semantics():
    """Lists and scalars in, f64 arrays out; 0 -> +-inf, inf -> +-0, nan ->
    nan; rsqrt of a negative -> nan (``src/repro/core/taylor.py:166-170``)."""
    r = taylor.reciprocal_np([0.0, -0.0, np.inf, -np.inf, np.nan, 4.0])
    assert r.dtype == np.float64 and r.shape == (6,)
    assert np.signbit(r[:4]).tolist() == [False, True, False, True]
    assert np.isinf(r[:2]).all() and (r[2:4] == 0).all() and np.isnan(r[4])
    assert abs(r[5] - 0.25) <= 2.0 ** -54               # within one f64 ulp of 1/4
    assert taylor.divide_np(1.0, 3.0).shape == ()
    q = taylor.divide_np([0.0, 1.0, np.inf, 2.0], [0.0, -0.0, np.inf, np.inf])
    assert np.isnan(q[0]) and q[1] == -np.inf and np.isnan(q[2]) and q[3] == 0
    s = taylor.rsqrt_np([-1.0, 0.0, -0.0, np.inf, 4.0])
    assert np.isnan(s[0]) and s[1] == np.inf and s[2] == -np.inf and s[3] == 0
    assert abs(s[4] - 0.5) <= 2.0 ** -53


def test_ldexp64_is_numpys():
    """The oracles' recombine: numpy's ldexp rounds x * 2^k once, where a
    product by a computed 2^k would give inf for ``ldexp(0.5, 1024)``
    (numpy: 2^1023) and 0 for ``ldexp(3.0, -1075)`` (numpy: 2^-1073);
    ``fpparts.ldexp64`` gives numpy's bits on those lanes and on random ones
    over the whole exponent range, subnormal results included."""
    x = np.array([0.5, 3.0, 0.75, -1.5, 1.0, 1.25, 0.0, -0.0, np.inf, np.nan, 5e-324, 1e-310])
    k = np.array([1024, -1075, -1073, -1074, 1024, -1080, 5, -7, -3, 2, 1000, 1100])
    want = np.ldexp(x, k)
    _same_bits(fpparts.ldexp64(torch.from_numpy(x), torch.from_numpy(k)).numpy(), want)
    assert want[0] == 2.0 ** 1023 and want[1] == 2.0 ** -1073
    rng = np.random.default_rng(7)
    xs = rng.uniform(0.5, 2.0, 4096) * rng.choice([-1, 1], 4096)
    ks = rng.integers(-1100, 1100, 4096)
    _same_bits(fpparts.ldexp64(torch.from_numpy(xs), torch.from_numpy(ks)).numpy(),
               np.ldexp(xs, ks))


# ------------------------------------------------------------------- corpora

@pytest.mark.parametrize("name", ["golden_inputs", "golden_rsqrt_inputs",
                                  "golden_softmax_inputs", "golden_div_inputs"])
def test_each_corpus_is_the_references(name):
    got, want = getattr(golden, name)(), getattr(ref_golden, name)()
    for g, w in (zip(got, want) if isinstance(got, tuple) else ((got, want),)):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))
    np.testing.assert_array_equal(golden.golden_numerators(515),
                                  ref_golden.golden_numerators(515))


def test_cell_lists_are_the_references():
    for name in ("golden_cells", "golden_div_cells", "golden_rsqrt_cells",
                 "golden_softmax_cells"):
        assert getattr(golden, name)() == getattr(ref_golden, name)()


# ---------------------------------------------------------------- generators

@pytest.mark.parametrize("which", ["generate", "generate_divide", "generate_rsqrt"])
def test_generators_write_the_committed_stores_bits(tmp_path, which):
    """Every array of the port's store, generated on the CPU, equals the
    committed store's (the meta aside: it names the port's versions)."""
    committed = {"generate": golden.GOLDEN_PATH, "generate_divide": golden.DIVIDE_PATH,
                 "generate_rsqrt": golden.RSQRT_PATH}[which]
    path = getattr(golden, which)(tmp_path / committed.name, device="cpu")
    with np.load(path) as got, np.load(committed) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            if k != "meta":
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert b'"torch"' in got["meta"].tobytes()


def test_the_softmax_generator_meets_the_store_within_the_stated_ulp(tmp_path):
    """The port's softmax store: the committed inputs, and every cell within
    SOFTMAX_TOLERANCE_ULP (16, ``test_torch_consumers.py``'s bound) of the
    committed outputs on the lanes whose f64 softmax is a normal f32;
    measured here: at most 6."""
    path = golden.generate_softmax(tmp_path / "softmax_v1.npz", device="cpu")
    with np.load(path) as got:
        np.testing.assert_array_equal(got["inputs"], golden.golden_softmax_inputs())
        # The port's own store reproduces at 0 int ulp on its normal lanes.
        assert golden.check_softmax(path, tolerance_ulp=0, device="cpu") == []
    drift = golden.softmax_drift(device="cpu")
    assert set(drift) == {k for k, _ in golden.golden_softmax_cells()}
    assert golden.SOFTMAX_TOLERANCE_ULP == 16
    worst = max(d["max_ulp"] for d in drift.values())
    assert 0 < worst <= 6, drift
    assert golden.check_softmax(device="cpu") == []


def test_check_softmax_fails_a_planted_drift(tmp_path):
    """A copy of the store with one oracle-normal lane of one cell moved by
    17 int ulp fails that cell alone, naming the lane."""
    with np.load(golden.SOFTMAX_PATH) as z:
        arrays = {k: z[k].copy() for k in z.files}
    key = "out:softmax/taylor/factored/n2p24"
    arrays[key][30, 7] += np.uint32(17)               # a gaussian row: a normal lane
    planted = tmp_path / "softmax_v1.npz"
    np.savez(planted, **arrays)
    failures = golden.check_softmax(planted, device="cpu")
    assert [f["cell"] for f in failures] == ["softmax/taylor/factored/n2p24"]
    assert failures[0]["first"] == (30, 7) and failures[0]["max_ulp_drift"] >= 17


def test_the_generators_never_write_the_committed_stores(tmp_path):
    with pytest.raises(ValueError, match="committed"):
        golden.generate(golden.GOLDEN_PATH, device="cpu")
    assert golden.OUT_DIR.parts == ("build", "golden")


def test_cli_generates_into_the_given_directory(tmp_path, capsys):
    assert golden.main(["--generate", "--out", str(tmp_path), "--device", "cpu"]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        p.name for p in (golden.GOLDEN_PATH, golden.DIVIDE_PATH, golden.RSQRT_PATH,
                         golden.SOFTMAX_PATH))
    assert capsys.readouterr().out.count("wrote ") == 4
    assert golden.main(["--device", "cpu"]) == 0
