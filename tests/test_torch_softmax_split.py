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
- on fake tensors (the dry run's) each pass counts a call, never a launch;
- the exp pass's decomposition where rows are few (the order's 256 chains
  a row over G blocks, staged a tile of steps at a time, each chain adding
  in step order, the chains' sums met by chain index in whatever order the
  blocks arrive, then the order's tree in ``rows::warp_tree_sum``'s lane
  layout) is ``common.row_sum`` bit for bit.
The kernel against its plain version runs on the card (marker ``cuda``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import division_modes as dm
from repro_torch.core.seeds import compute_segments
from repro_torch.eval import consumers, ulp
from repro_torch.kernels import common, fake, softmax, softmax_split as ks
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
    import jax.numpy as jnp                  # here, so that the card's tests run without JAX
    from repro.kernels import ops as ref_ops

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


def test_workspace_keeps_its_tickets_past_every_row_of_partials(monkeypatch):
    """The max and exp passes' workspace: (M, 256) partials, then M tickets,
    zeroed once; fewer rows reuse it (the same tickets, which no row of
    partials overlaps), more rows grow it zeroed; another stream takes a
    buffer of its own."""
    monkeypatch.setattr(ks, "_WORKSPACE", {})
    part, ticket = ks._workspace(torch.empty(8, 4), 0)
    assert part.numel() == 8 * common.REDUCE_THREADS and ticket.numel() == 8
    assert ticket.data_ptr() == part.data_ptr() + part.numel() * part.element_size()
    part2, ticket2 = ks._workspace(torch.empty(3, 4), 0)
    assert (part2.data_ptr(), ticket2.data_ptr()) == (part.data_ptr(), ticket.data_ptr())
    other, _ = ks._workspace(torch.empty(3, 4), 1)
    assert other.data_ptr() != part.data_ptr()
    part3, ticket3 = ks._workspace(torch.empty(20, 4), 0)
    assert part3.numel() == 20 * common.REDUCE_THREADS and ticket3.numel() == 20
    assert not part3.any() and not ticket3.any()


TILE = 1024   # kTile in csrc/softmax.cu: floats a block stages at a time


def _chains_over_blocks(ex: torch.Tensor, groups: int, seed: int) -> torch.Tensor:
    """The exp pass's row sums as its kernel takes them where rows are few:
    block g of ``groups`` a row adds chains [C g, C g + C) (C = 256 /
    groups) one stage of TILE / C steps at a time, each chain in step order
    onto +0, steps past the row's end staged as +0; the blocks arrive in a
    seeded order and leave their sums at their chains' indices; then the
    halving tree as ``rows::warp_tree_sum`` runs it (lane l, slot j holding
    chain 8 l + j: shuffles down by 16 ... 1 lanes, then slots 4, 2, 1)."""
    t = common.REDUCE_THREADS
    m, d = ex.shape
    c, steps = t // groups, -(-d // t)
    tile = TILE // c
    padded = torch.zeros((m, -(-steps // tile) * tile * t))
    padded[:, :d] = ex
    view = padded.reshape(m, -1, t)
    part = torch.full((m, t), torch.nan)
    for g in np.random.default_rng(seed).permutation(groups):
        acc = torch.zeros((m, c))
        for k0 in range(0, view.shape[1], tile):
            for k in range(k0, k0 + tile):
                acc = acc + view[:, k, c * g:c * g + c]
        part[:, c * g:c * g + c] = acc
    p = part.reshape(m, 32, 8)
    for lanes in (16, 8, 4, 2, 1):
        p = torch.cat([p[:, :lanes] + p[:, lanes:2 * lanes], p[:, lanes:]], 1)
    for h in (4, 2, 1):
        p = torch.cat([p[..., :h] + p[..., h:2 * h], p[..., h:]], 2)
    return p[:, :1, 0]


@pytest.mark.parametrize("d", [5, 255, 256, 1032, 4100])
@pytest.mark.parametrize("groups", [1, 2, 8, 32])
def test_chains_over_blocks_are_row_sum_bit_for_bit(groups, d):
    x = _rows(d, d + groups)
    x[9, d // 2] = torch.inf                  # a +inf lane: the row's top is not finite
    ex, want = ks.split_exp_plain(x, ks.split_max_plain(x))
    got = _chains_over_blocks(ex, groups, seed=groups)
    assert got.shape == want.shape and _same(got, want)
    assert want[5].item() == 0.0 and want[7].isnan() and want[9].isinf()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 262144), (8, 512), (128, 1032), (128, 1040), (3, 5),
                                   (8, 257), (8, 4099), (2, 131072 + 3)])
def test_kernel_is_its_plain_version_on_the_card(shape):
    """Each pass bit for bit against its plain version at the decode
    shapes the main path gives it (gemma3 at 524288 slots over data 2, its
    ring layers, llama3_8b's kvseq cache), rows the one-block and the
    spread layouts split at a chain's end (d % 256 != 0, d % 4 != 0: the
    scalar path) and a short row; a row with -inf lanes, a row holding a
    nan, a row of -inf and a row with a +inf lane where there are rows for
    them. The max and exp passes also run on a second stream, with a
    workspace of its own. The workspaces' tickets are left at 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(shape, generator=g, device="cuda") * 6
    m, d = shape
    x[0, ::3] = -torch.inf
    for row, lanes, value in ((1, d // 3, torch.nan), (2, slice(None), -torch.inf),
                              (3, d // 2, torch.inf)):
        if row < m:
            x[row, lanes] = value
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
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        top2 = ks.split_max(x)
        e2, s2 = ks.split_exp(x, top2)
    torch.cuda.synchronize()
    assert _same(top2, top) and _same(e2, e) and _same(s2, s)
    assert ks.LAUNCHES == {"softmax_split_f32": 4 + len(SCHEDULES)}
    for stream in (torch.cuda.current_stream(), side):
        assert not ks._workspace(x, stream.cuda_stream)[1].any()
