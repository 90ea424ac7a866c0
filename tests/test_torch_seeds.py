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
