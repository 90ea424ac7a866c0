"""The split softmax kernel's module (``kernels/softmax_split.py``): a row
whose elements lie on several ranks, normalised in three passes with the
ranks' combines between them.

On the CPU the wrappers run the plain versions. Held here:
- on one rank the three passes give the fused softmax kernel's plain
  version (``softmax.softmax_plain``) bit for bit, in every schedule, with
  -inf lanes, rows of -inf and nan rows;
- over 2 and 4 simulated ranks (each rank's block of the row, the maxima
  and sums combined as the all-reduces combine them) the result stays within
  ``SOFTMAX_VS_REF_ULP`` int ulp of the reference's softmax (its Pallas
  kernel's path, ``repro.kernels.ops.softmax``) on oracle-normal lanes, the
  bound of ``test_torch_consumers.py``: only the row sum's order differs;
- ``division_modes.split_softmax`` in every mode on one rank is
  ``division_modes.softmax`` bit for bit, and a row masked on every rank is
  zeros;
- on fake tensors (the dry run's) each pass counts a call, never a launch.
The kernel against its plain version runs on the card (marker ``cuda``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.core import division_modes as dm
from repro_torch.core.seeds import compute_segments
from repro_torch.eval import consumers, ulp
from repro_torch.kernels import fake, softmax, softmax_split as ks
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCHEDULES = ["paper", "factored", "goldschmidt"]
SOFTMAX_VS_REF_ULP = 16
MODES = ["exact", "taylor", "taylor_pallas", "goldschmidt", "goldschmidt_pallas", "ilm"]


def _bits(t):
    return t.contiguous().view(torch.int32)


def _same(got, want) -> bool:
    return bool(((_bits(got) == _bits(want)) | (got.isnan() & want.isnan())).all())


def _rows(d: int, seed: int) -> torch.Tensor:
    """Seeded logits with -inf lanes, a row of -inf and a row holding a nan."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 8, (12, d)).astype(np.float32)
    x[3, rng.random(d) < 0.5] = -np.inf
    x[5, :] = -np.inf
    x[7, d // 3] = np.nan
    return torch.from_numpy(x)


def _split(x: torch.Tensor, n: int, schedule: str, n_iters: int = 2) -> torch.Tensor:
    """The three passes over ``n`` ranks' blocks of each row, combined as
    the all-reduces combine them (the maximum; the sum in rank order)."""
    blocks = x.chunk(n, dim=-1)
    top = torch.stack([ks.split_max(b) for b in blocks]).amax(0)
    parts = [ks.split_exp(b.contiguous(), top) for b in blocks]
    total = parts[0][1]
    for _, s in parts[1:]:
        total = total + s
    return torch.cat([ks.split_scale(e, total, n_iters, 24, schedule) for e, _ in parts], -1)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("d", [8, 300, 1024])
def test_one_rank_is_the_fused_softmax_bit_for_bit(schedule, d):
    x = _rows(d, d)
    want = softmax.softmax_plain(x, compute_segments(2, 24), 2, schedule)
    assert _same(_split(x, 1, schedule), want)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_over_ranks_within_the_consumer_bound_of_the_reference(n, schedule):
    for name, x in consumers.softmax_rows("float32", 16, 512, seed=n).items():
        want = np.asarray(ref_ops.softmax(jnp.asarray(x), 2, 24, schedule))
        got = _split(torch.from_numpy(x), n, schedule).numpy()
        diff = ulp.ulp_diff(got, want)
        normal = ulp.oracle_mask(consumers.softmax_oracle(x.astype(np.float64)), "float32")
        worst = int(np.where(normal, diff, 0).max())
        assert worst <= SOFTMAX_VS_REF_ULP, (name, worst)


@pytest.mark.parametrize("mode", MODES)
def test_division_modes_split_softmax_on_one_rank_is_softmax(mode):
    cfg = dm.DivisionConfig(mode=mode)
    x = _rows(200, 3)[[0, 1, 2, 3, 5]].reshape(5, 1, 200)
    got = dm.split_softmax(x, cfg, lambda t: t, lambda t: t)
    assert got.shape == x.shape and _same(got, dm.softmax(x, -1, cfg))
    assert torch.equal(got[4], torch.zeros_like(got[4]))      # every lane -inf: zeros


def test_fake_tensors_count_a_call_never_a_launch():
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake.reset()
    ks.reset_launches()
    with FakeTensorMode():
        x = torch.empty(4, 64)
        e, s = ks.split_exp(x, ks.split_max(x))
        out = ks.split_scale(e, s)
    assert out.shape == (4, 64) and s.shape == (4, 1)
    assert fake.CALLS == {"softmax_split_f32": 3} and ks.LAUNCHES == {"softmax_split_f32": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 262144), (128, 1040), (3, 5)])
def test_kernel_is_its_plain_version_on_the_card(shape):
    """Each pass bit for bit against its plain version at the decode
    shapes the main path gives it (gemma3 at 524288 slots over data 2,
    llama3_8b's kvseq cache) and a short row."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(shape, generator=g, device="cuda") * 6
    x[0, ::3] = -torch.inf
    ks.reset_launches()
    top = ks.split_max(x)
    assert _same(top, ks.split_max_plain(x))
    e, s = ks.split_exp(x, top)
    we, ws = ks.split_exp_plain(x, top)
    assert _same(e, we) and _same(s, ws)
    table = compute_segments(2, 24)
    for schedule in SCHEDULES:
        assert _same(ks.split_scale(e, s, 2, 24, schedule),
                     ks.split_scale_plain(e, s, table, 2, schedule))
    assert ks.LAUNCHES == {"softmax_split_f32": 2 + len(SCHEDULES)}
