"""The port's seed tables and powering schedule against the reference.

The division unit has no weights: its parameters are the PWL seed tables,
recomputed from (n_iters, precision_bits). The port keeps its own numpy
copy of the generator, so the tables must be equal to the reference's, bit
for bit, at every operating point the golden cells and configs use.
"""
import numpy as np
import pytest

from repro.core import powering as ref_powering
from repro.core import seeds as ref_seeds
from repro_torch.core import powering, seeds
from repro_torch.core.taylor import _paper_leaves
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

# (n, p) of the golden cells, the conformance dial and the paper's Table I.
OPERATING_POINTS = [(2, 24), (1, 12), (1, 24), (3, 24), (2, 30), (5, 53)]


def _assert_tables_equal(got, want):
    for field in ("boundaries", "slopes", "intercepts"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert (got.n_iters, got.precision_bits) == (want.n_iters, want.precision_bits)
    np.testing.assert_array_equal(got.inner_boundaries, want.inner_boundaries)


@pytest.mark.parametrize("n,p", OPERATING_POINTS)
def test_reciprocal_seed_tables_equal_reference(n, p):
    _assert_tables_equal(seeds.compute_segments(n, p),
                         ref_seeds.compute_segments(n, p))


def test_f32_operating_point_has_six_segments():
    assert seeds.compute_segments(2, 24).n_segments == 6


@pytest.mark.parametrize("n_segments", [8, 16])
def test_rsqrt_seed_table_equal_reference(n_segments):
    got = seeds.rsqrt_seed_table(n_segments)
    _assert_tables_equal(got, ref_seeds.rsqrt_seed_table(n_segments))
    assert got.n_segments == n_segments


@pytest.mark.parametrize("n", range(0, 13))
def test_powering_schedule_equal_reference(n):
    assert powering.schedule(n) == ref_powering.schedule(n)


@pytest.mark.parametrize("n", range(1, 17))
def test_paper_leaves_follow_the_closed_form_of_the_cuda_body(n):
    """The CUDA body picks the fused-add powers by a closed form (2k > n,
    and k odd or k + 1 > n); it must name the same powers as the
    schedule-derived rule of the plain version."""
    closed = {k for k in range(2, n + 1)
              if 2 * k > n and (k % 2 == 1 or k + 1 > n)}
    assert closed == _paper_leaves(n)


# The paper's analytic pieces (§3 seeds, §6 powering), on the inputs of
# tests/test_seeds.py and tests/test_powering.py.

def test_paper_table_i_is_the_references():
    assert seeds.PAPER_TABLE_I == ref_seeds.PAPER_TABLE_I
    t = seeds.compute_segments(5, 53)
    for ours, theirs in zip(t.boundaries[1:], seeds.PAPER_TABLE_I):
        assert abs(ours - theirs) / theirs < 0.006


@pytest.mark.parametrize("a,b,bits", [(1.0, 2.0, 53), (1.0, 2.0 ** 0.5, 53),
                                      (2.0 ** 0.5, 2.0, 53), (1.0, 2.0, 24),
                                      (1.5, 1.75, 30)])
def test_iterations_required_and_seed_max_m_are_the_references(a, b, bits):
    assert seeds.iterations_required(a, b, bits) == ref_seeds.iterations_required(a, b, bits)
    assert seeds.seed_max_m(a, b) == ref_seeds.seed_max_m(a, b)
    for n in range(6):
        assert seeds.seed_error_bound(a, b, n) == ref_seeds.seed_error_bound(a, b, n)


def test_single_segment_needs_17_iterations():
    # paper §3: the linear seed on [1, 2] needs 17 iterations for 53 bits
    assert seeds.iterations_required(1.0, 2.0, 53) == 17
    with pytest.raises(ValueError, match="no n <= 3"):
        seeds.iterations_required(1.0, 2.0, 53, n_max=3)


@pytest.mark.parametrize("n,p", OPERATING_POINTS)
def test_max_error_bound_is_the_references(n, p):
    got, want = seeds.compute_segments(n, p), ref_seeds.compute_segments(n, p)
    assert got.max_error_bound() == want.max_error_bound()
    assert got.max_error_bound(n + 1) == want.max_error_bound(n + 1)
    assert got.max_error_bound() <= 2.0 ** -p


@pytest.mark.parametrize("sched", ["paper", "factored"])
def test_op_counts_are_the_references(sched):
    for n in list(range(0, 9)) + [12, 17, 33]:
        assert powering.op_counts(n, sched) == ref_powering.op_counts(n, sched)
    with pytest.raises(ValueError):
        powering.op_counts(3, "bogus")
