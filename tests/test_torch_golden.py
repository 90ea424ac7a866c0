"""The reference's committed golden stores, reproduced by the port.

Every cell of the reciprocal, divide and rsqrt stores, ``recip/ilm/n2p24``
included, must come out of the port at 0 int ulp. The softmax store is not
checked (ROADMAP F1).
"""
import numpy as np
import pytest

from repro.eval import golden as ref_golden
from repro_torch.eval import golden, ulp
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _cells():
    for path, cells, x_key, a_key in (
            (golden.GOLDEN_PATH, golden.golden_cells(), "inputs", "numerators"),
            (golden.DIVIDE_PATH, golden.golden_div_cells(), "b", "a"),
            (golden.RSQRT_PATH, golden.golden_rsqrt_cells(), "inputs", "inputs")):
        for key, kw in cells:
            yield pytest.param(path, key, kw, x_key, a_key, id=key)


def test_cell_lists_are_the_reference_lists():
    assert golden.golden_cells() == ref_golden.golden_cells()
    assert golden.golden_div_cells() == ref_golden.golden_div_cells()
    assert golden.golden_rsqrt_cells() == ref_golden.golden_rsqrt_cells()
    assert not hasattr(golden, "NOT_PORTED")        # every cell is checked
    for mine, ref in ((golden.GOLDEN_PATH, ref_golden.GOLDEN_PATH),
                      (golden.DIVIDE_PATH, ref_golden.DIVIDE_PATH),
                      (golden.RSQRT_PATH, ref_golden.RSQRT_PATH)):
        assert mine.resolve() == ref.resolve()


@pytest.mark.parametrize("path,key,kw,x_key,a_key", list(_cells()))
def test_golden_cell_bit_exact_on_cpu(path, key, kw, x_key, a_key):
    with np.load(path) as z:
        x, a, want = z[x_key], z[a_key], z["out:" + key].view(np.float32)
    d = ulp.ulp_diff(golden.compute(key, kw, x, a, "cpu"), want)
    assert d.max() == 0, f"{key}: {int((d > 0).sum())} lanes, max {int(d.max())} ulp"


def test_checkers_report_no_failures():
    assert golden.check(device="cpu") == []
    assert golden.check_divide(device="cpu") == []
    assert golden.check_rsqrt(device="cpu") == []


def test_checker_reports_drift(tmp_path):
    with np.load(golden.RSQRT_PATH) as z:
        arrays = {k: z[k] for k in z.files}
    key = "out:rsqrt/taylor/newton2"
    arrays[key] = arrays[key].copy()
    arrays[key][0] += 1
    path = tmp_path / "rsqrt.npz"
    np.savez(path, **arrays)
    failures = golden.check_rsqrt(path, device="cpu")
    assert [f["cell"] for f in failures] == ["rsqrt/taylor/newton2"]
    assert failures[0]["n_mismatch"] == 1 and failures[0]["max_ulp_drift"] == 1


def test_sweeps_equal_reference():
    """The port's numpy copy of the ULP engine builds the same corpora."""
    from repro.eval import ulp as ref_ulp

    for name in ("sweep_logspace", "sweep_mantissa", "sweep_subnormals",
                 "sweep_rsqrt_mantissa", "sweep_exponent_parity"):
        np.testing.assert_array_equal(getattr(ulp, name)(256, "float32", seed=9),
                                      getattr(ref_ulp, name)(256, "float32", seed=9))
    np.testing.assert_array_equal(ulp.sweep_edges(), ref_ulp.sweep_edges())
    for got, want in zip(ulp.div_sweep(n_log=64, n_man=64, boundaries=[1.25]).values(),
                         ref_ulp.div_sweep(n_log=64, n_man=64, boundaries=[1.25]).values()):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    x = ulp.sweep_logspace(512, seed=3)
    exact = 1.0 / x.astype(np.float64)
    approx = (1.0 / x).astype(np.float32)
    np.testing.assert_array_equal(ulp.ulp_error(approx, exact),
                                  ref_ulp.ulp_error(approx, exact))
    np.testing.assert_array_equal(ulp.to_ordered(x), ref_ulp.to_ordered(x))


def test_entry_points_default_to_the_card():
    import inspect

    for fn in (golden.compute, golden.check, golden.check_divide, golden.check_rsqrt):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
