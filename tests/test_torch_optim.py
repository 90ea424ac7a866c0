"""The port's AdamW, LR schedules and int8 compression against the
reference's, on the same numpy inputs.

Unclipped (``grad_clip`` above the global norm, so the clip factor is 1),
the update is the reference's bit for bit in every mode: parameters, m and
v, and the recip stage (every leaf's denominator ``sqrt(v_hat) + eps`` and
its reciprocal through the division unit, recorded in both packages). The
reference runs op by op here: under ``jax.jit`` XLA fuses ``b * m + (1 - b)
* g`` into a multiply-add, which moves lanes where the two terms cancel.

With clipping the global norm sums its per-leaf sums in another order
(F5), the clip factor may differ in its last bit and every lane with it;
over three steps m and v stay within ``CLIP_MOMENT_RTOL`` of the leaf's
largest value (measured 4.8e-7) and parameters within ``CLIP_STEP_TOL``
learning rates (measured 4.0e-4 lr: where |g| is near eps the Adam step
``m_hat / (sqrt(v_hat) + eps)`` amplifies the moments' differences).
The bias corrections are f32 pows and equal the reference's over steps
1-1000; the warmup-cosine schedule is within 2^-24 (torch's and XLA's f32
cos differ in the last bit: 29 of 1200 steps, measured).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import division_modes as ref_dm
from repro.optim import adamw as ref_adamw
from repro.optim import compress as ref_compress
from repro.optim import schedule as ref_schedule
from repro_torch import tree
from repro_torch.core import division_modes as dm
from repro_torch.kernels import tsdiv
from repro_torch.optim import adamw, compress, schedule
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

MODES = ["exact", "taylor", "taylor_pallas", "goldschmidt", "goldschmidt_pallas", "ilm"]
CLIP_MOMENT_RTOL, CLIP_STEP_TOL = 1e-6, 1e-3


def _params(seed=0):
    """Four leaves of two shapes (the reference compiles each op once per
    shape when it runs op by op)."""
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(32, 24)).astype(np.float32),
            "b": rng.normal(size=(24,)).astype(np.float32),
            "blocks": [{"e": rng.normal(size=(32, 24)).astype(np.float32)},
                       {"e": rng.normal(size=(24,)).astype(np.float32)}]}


def _grads(params, seed):
    """Gradients over ten decades, edge lanes (0, -0) included."""
    rng = np.random.default_rng(seed)

    def one(p):
        g = rng.normal(size=p.shape) * 10.0 ** rng.uniform(-9, 1, size=p.shape)
        g.reshape(-1)[:2] = (0.0, -0.0)
        return g.astype(np.float32)
    return jax.tree_util.tree_map(one, params)


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np(tree):
    return jax.tree_util.tree_map(lambda t: t.float().numpy() if torch.is_tensor(t)
                                  else np.asarray(t).astype(np.float32), tree)


def _configs(mode, **kw):
    div = dict(mode=mode, schedule="paper")
    return (ref_adamw.AdamWConfig(division=ref_dm.DivisionConfig(**div), **kw),
            adamw.AdamWConfig(division=dm.DivisionConfig(**div), **kw))


def _spy(monkeypatch, module, record):
    real = module.recip

    def spy(x, cfg):
        y = real(x, cfg)
        record.append((np.array(x), np.array(y)))
        return y
    monkeypatch.setattr(module, "recip", spy)


def _run(rc, pc, steps, params, lr_scale=1.0):
    rp, pp = jax.tree_util.tree_map(jnp.asarray, params), _torch(params)
    rs, ps = ref_adamw.init(rp, rc), adamw.init(pp, pc)
    for i in range(steps):
        g = _grads(params, 10 + i)
        rp, rs = ref_adamw.update(jax.tree_util.tree_map(jnp.asarray, g), rs, rp, rc,
                                  lr_scale)
        pp, ps = adamw.update(_torch(g), ps, pp, pc, lr_scale)
    return (rp, rs), (pp, ps)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_update_is_the_references_bit_for_bit(monkeypatch, mode, state_dtype):
    rc, pc = _configs(mode, grad_clip=1e9, state_dtype=state_dtype)
    rec_ref, rec_port = [], []
    _spy(monkeypatch, ref_dm, rec_ref)
    _spy(monkeypatch, dm, rec_port)
    (rp, rs), (pp, ps) = _run(rc, pc, 2, _params())
    for want, got in ((rp, pp), (rs.m, ps.m), (rs.v, ps.v)):
        for a, b in zip(jax.tree_util.tree_leaves(_np(want)), jax.tree_util.tree_leaves(_np(got))):
            np.testing.assert_array_equal(a, b)
    assert ps.m["w"].dtype == getattr(torch, state_dtype) and int(ps.step) == int(rs.step) == 2
    # The recip stage: 2 steps x 4 leaves, each denominator and its
    # reciprocal equal bit for bit (exact mode divides, with no recip).
    assert len(rec_port) == len(rec_ref) == (0 if mode == "exact" else 8)
    for (dr, yr), (dp, yp) in zip(rec_ref, rec_port):
        np.testing.assert_array_equal(dp.view(np.int32), dr.view(np.int32))
        np.testing.assert_array_equal(yp.view(np.int32), yr.view(np.int32))


@pytest.mark.parametrize("mode", ["exact", "taylor_pallas"])
def test_clipped_update_within_the_stated_tolerance(mode):
    rc, pc = _configs(mode, grad_clip=0.5)
    params = _params(1)
    g = _grads(params, 3)
    gn_ref = float(ref_adamw._global_norm(jax.tree_util.tree_map(jnp.asarray, g)))
    gn = float(adamw.global_norm(_torch(g)))
    assert abs(gn - gn_ref) <= 2 * np.spacing(np.float32(gn_ref))
    assert 0.5 / gn_ref < 1      # the clip is live
    (rp, rs), (pp, ps) = _run(rc, pc, 3, params)
    for a, b in zip(jax.tree_util.tree_leaves(_np(rp)), jax.tree_util.tree_leaves(_np(pp))):
        assert np.abs(a - b).max() <= CLIP_STEP_TOL * pc.lr
    for want, got in ((rs.m, ps.m), (rs.v, ps.v)):
        for a, b in zip(jax.tree_util.tree_leaves(_np(want)), jax.tree_util.tree_leaves(_np(got))):
            assert np.abs(a - b).max() <= CLIP_MOMENT_RTOL * np.abs(a).max()


def test_sqrt_f32_is_correctly_rounded():
    """AdamW's square root equals numpy's and XLA's IEEE sqrt bit for bit on
    2^20 random f32 values over 2^-120 .. 2^120 (torch's own CPU sqrt does
    not with AVX-512: F10)."""
    rng = np.random.default_rng(7)
    x = np.exp2(rng.uniform(-120, 120, 1 << 20)).astype(np.float32)
    want = np.sqrt(x)
    np.testing.assert_array_equal(np.asarray(jnp.sqrt(jnp.asarray(x))).view(np.int32),
                                  want.view(np.int32))
    got = adamw.sqrt_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_bias_corrections_are_the_references_steps_1_to_1000():
    cfg = adamw.AdamWConfig()
    for s in range(1, 1001):
        c1, c2 = adamw.bias_corrections(torch.tensor(s, dtype=torch.int32), cfg)
        st = jnp.asarray(s, jnp.int32).astype(jnp.float32)
        assert c1.dtype == c2.dtype == torch.float32
        assert (c1.item(), c2.item()) == (float(1.0 - cfg.b1 ** st), float(1.0 - cfg.b2 ** st)), s


def test_schedules_match_the_reference():
    steps = np.arange(0, 1200, dtype=np.int32)
    kw = dict(warmup_steps=100, total_steps=1000, min_ratio=0.1)
    got = schedule.warmup_cosine(torch.from_numpy(steps), **kw).numpy()
    want = np.asarray(ref_schedule.warmup_cosine(jnp.asarray(steps), **kw))
    assert np.abs(got - want).max() <= 2.0 ** -24     # torch's and XLA's f32 cos
    np.testing.assert_array_equal(schedule.constant(7, value=0.5).numpy(),
                                  np.asarray(ref_schedule.constant(7, value=0.5)))
    # A scheduled lr_scale (an f32 tensor) moves the update as the reference's.
    rc, pc = _configs("taylor_pallas", grad_clip=1e9)
    params = _params(2)
    g = _grads(params, 4)
    rp, pp = jax.tree_util.tree_map(jnp.asarray, params), _torch(params)
    want, _ = ref_adamw.update(jax.tree_util.tree_map(jnp.asarray, g), ref_adamw.init(rp, rc),
                               rp, rc, ref_schedule.warmup_cosine(jnp.asarray(37), **kw))
    got, _ = adamw.update(_torch(g), adamw.init(pp, pc), pp, pc,
                          schedule.warmup_cosine(torch.tensor(37), **kw))
    for a, b in zip(jax.tree_util.tree_leaves(_np(want)), jax.tree_util.tree_leaves(_np(got))):
        np.testing.assert_array_equal(a, b)


def test_matches_the_adam_formula():
    """tests/test_optim.py's first-step check on the port."""
    cfg = adamw.AdamWConfig(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                            grad_clip=1e9)
    params = {"w": torch.tensor([[1.0, -2.0], [0.5, 3.0]]), "b": torch.tensor([0.1, -0.1])}
    grads = {k: torch.full_like(v, 0.3) for k, v in params.items()}
    new_p, new_s = adamw.update(grads, adamw.init(params, cfg), params, cfg)
    m, v = (1 - 0.9) * 0.3, (1 - 0.999) * 0.3 * 0.3
    want = 1e-2 * (m / (1 - 0.9)) / (np.sqrt(v / (1 - 0.999)) + 1e-8)
    np.testing.assert_allclose((params["b"] - new_p["b"]).numpy(), want, rtol=1e-5)
    assert int(new_s.step) == 1


@pytest.mark.parametrize("mode", ["taylor", "taylor_pallas", "goldschmidt_pallas"])
def test_division_modes_close_to_exact_and_big_grads_clipped(mode):
    """tests/test_optim.py's gates on the port: every mode within 1e-6 of
    exact; clipped huge gradients leave finite parameters."""
    params = _torch(_params())
    g = _torch(_grads(_params(), 5))
    want, _ = adamw.update(g, adamw.init(params, adamw.AdamWConfig()), params,
                           adamw.AdamWConfig())
    cfg = adamw.AdamWConfig(division=dm.DivisionConfig(mode=mode))
    got, _ = adamw.update(g, adamw.init(params, cfg), params, cfg)
    for a, b in zip(jax.tree_util.tree_leaves(_np(want)), jax.tree_util.tree_leaves(_np(got))):
        assert np.abs(a - b).max() < 1e-6
    cfg = dataclasses.replace(cfg, grad_clip=0.5, lr=1.0)
    big = jax.tree_util.tree_map(lambda t: torch.full_like(t, 1e3), params)
    out, _ = adamw.update(big, adamw.init(params, cfg), params, cfg)
    assert all(bool(torch.isfinite(t).all()) for t in jax.tree_util.tree_leaves(out))


def test_kernel_mode_divides_through_one_recip_per_leaf(monkeypatch):
    """In a kernel mode each leaf's Adam divide is one tsdiv_recip call (the
    plain version on the CPU, a launch on the card), never a torch divide."""
    calls = []
    real = tsdiv.recip
    monkeypatch.setattr(tsdiv, "recip", lambda x, *a: calls.append(x.shape) or real(x, *a))
    monkeypatch.setattr(torch, "reciprocal", None)
    params = _torch(_params())
    cfg = adamw.AdamWConfig(division=dm.DivisionConfig(mode="taylor_pallas"))
    adamw.update(_torch(_grads(_params(), 6)), adamw.init(params, cfg), params, cfg)
    leaves = jax.tree_util.tree_leaves(params)
    assert calls == [torch.Size([t.numel()]) for t in leaves]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_roundtrip_is_the_references(seed):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(128,)) * 10.0 ** rng.uniform(-3, 3)).astype(np.float32)
    err = (rng.normal(size=(128,)) * 1e-3).astype(np.float32)
    deq, new_err = compress.quantize_roundtrip(torch.from_numpy(g), torch.from_numpy(err))
    want_deq, want_err = ref_compress.quantize_roundtrip(jnp.asarray(g), jnp.asarray(err))
    np.testing.assert_array_equal(deq.numpy(), np.asarray(want_deq))
    np.testing.assert_array_equal(new_err.numpy(), np.asarray(want_err))
    lsb = np.abs(g + err).max() / 127.0
    assert np.abs(deq.numpy() - (g + err)).max() <= lsb * 0.5 + 1e-7


def test_error_feedback_is_the_references_and_unbiased():
    """200 steps of compensated quantization: the same residuals as the
    reference at every step, and the mean of the dequantized values within
    one level of g (tests/test_optim.py's property)."""
    g = (np.random.default_rng(1).normal(size=(64,)) * 0.01).astype(np.float32)
    err, ref_err = torch.zeros(64), jnp.zeros(64)
    acc = torch.zeros(64)
    for _ in range(200):
        deq, err = compress.quantize_roundtrip(torch.from_numpy(g), err)
        _, ref_err = ref_compress.quantize_roundtrip(jnp.asarray(g), ref_err)
        np.testing.assert_array_equal(err.numpy(), np.asarray(ref_err))
        acc += deq
    np.testing.assert_allclose((acc / 200).numpy(), g, atol=np.abs(g).max() / 127.0)


def test_error_tree_and_cross_pod_mean(tmp_path):
    params = _torch(_params())
    errs = compress.init_error_tree(params)
    for e, p in zip(jax.tree_util.tree_leaves(errs), jax.tree_util.tree_leaves(params)):
        assert e.dtype == torch.float32 and e.shape == p.shape and not e.any()
    with pytest.raises(ValueError, match="needs an active mesh"):
        compress.psum_compressed(params, errs, "pod", [])
    # The working mean over a one-rank 'pod' axis is the round trip: the
    # int8 values summed over one rank, times the scale, over 1 (the
    # 4-rank mean is in test_torch_sharded_paths.py).
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import rules as shr

    grads = tree.map_tree(lambda p: (p.float() * 0.01 + 1e-3), params)
    store = tmp_path / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        with shr.use_mesh(make_mesh((1,), ("pod",), "cpu")):
            mean, new_err = compress.psum_compressed(grads, errs, "pod", [])
    finally:
        dist.destroy_process_group()
    for m, e, g in zip(tree.leaves(mean), tree.leaves(new_err), tree.leaves(grads)):
        deq, want_err = compress.quantize_roundtrip(g, torch.zeros_like(g))
        assert torch.equal(m, deq)
        # g' - q*s is one fused rounding here (as XLA fuses it); the round
        # trip, whose product has another use, rounds q*s first: they
        # differ by at most that rounding, half an ulp of q*s.
        ulp = torch.nextafter(deq.abs(), torch.tensor(float("inf"))) - deq.abs()
        assert bool(((e - want_err).abs() <= ulp / 2).all())
