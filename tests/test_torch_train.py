"""The port's training path: the train step against the reference's on the
same state and batch, remat, the microbatch accumulation, the loop's fault
handling, every architecture's smoke step and the launcher.

The train step starts from the reference's own state
(``convert.train_state_from_reference``) on paper_fpdiv's smoke config in
f32. The packages sum in different orders (matmuls, reductions, the
logsumexp), so the loss is held to ``LOGIT_RTOL`` relative and each
gradient leaf to ``GRAD_RTOL`` of its largest value (measured: loss 1.6e-7,
gradients 1.02e-6). Parameters after a step are compared only from the
same gradients: the first Adam step is about sign(g), so a gradient lane
near 0 whose sign differs moves its parameter by 2 lr.
"""
import dataclasses
import inspect
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.core.division_modes import DivisionConfig as RefDivisionConfig
from repro.optim import adamw as ref_adamw
from repro.train import step as ref_step
from repro_torch import convert, tree
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.core.division_modes import DivisionConfig
from repro_torch.data import DataConfig
from repro_torch.kernels import rmsnorm, softmax, tsdiv
from repro_torch.launch import train as launch_train
from repro_torch.models import init_params
from repro_torch.optim import adamw
from repro_torch.train import fault, step
from repro_torch.train.loop import LoopConfig, run
from _ref_params import ref_init
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

LOGIT_RTOL, GRAD_RTOL = 1e-5, 1e-5


def _pair(mode):
    div = dict(mode=mode, schedule="paper")
    ref = dataclasses.replace(ref_smoke_config("paper_fpdiv"), param_dtype="float32",
                              division=RefDivisionConfig(**div))
    port = dataclasses.replace(get_smoke_config("paper_fpdiv"), param_dtype="float32",
                               division=DivisionConfig(**div))
    return ref, port


def _tokens(vocab, b=4, s=32, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.mark.parametrize("mode,n_micro", [("exact", 1), ("taylor_pallas", 2)])
def test_train_step_matches_the_reference(mode, n_micro):
    rc, pc = _pair(mode)
    ref_state = ref_step.init_state(rc, ref_init(rc, 0),
                                    ref_adamw.AdamWConfig(division=rc.division))
    state = convert.train_state_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_state), pc, "cpu")
    batch = _tokens(rc.vocab)
    r_loss, r_metrics, r_grads = jax.jit(
        lambda p, b: ref_step.grads_fn(rc, p, b, n_micro))(
        ref_state.params, jax.tree_util.tree_map(jnp.asarray, batch))
    opt_cfg = adamw.AdamWConfig(division=pc.division)
    new, metrics = step.train_step(pc, opt_cfg, state, _torch(batch), n_micro=n_micro)
    assert set(metrics) == {"ce", "aux", "loss", "step"} and int(metrics["step"]) == 0
    assert abs(float(metrics["loss"]) - float(r_loss)) <= LOGIT_RTOL * abs(float(r_loss))
    assert abs(float(metrics["ce"]) - float(r_metrics["ce"])) <= LOGIT_RTOL * float(r_loss)
    assert float(metrics["aux"]) == float(r_metrics["aux"]) == 0.0
    assert int(new.step) == int(new.opt.step) == 1
    want = convert.params_from_reference(jax.tree_util.tree_map(np.asarray, r_grads), pc, "cpu")
    _, _, grads = step.grads_fn(pc, state.params, _torch(batch), n_micro)
    for got, w, path in zip(tree.leaves(grads), tree.leaves(want), tree.paths(grads)):
        assert got.dtype == torch.float32 and got.shape == w.shape, path
        assert float((got - w).abs().max()) <= GRAD_RTOL * float(w.abs().max()), path
    # The update from the reference's own gradients on the converted state,
    # against the reference's (jitted, as its loop runs it): within
    # tests/test_torch_optim.py's clipped tolerances (the clip is live, and
    # XLA fuses the moments' multiply-adds).
    r_params, r_opt = jax.jit(ref_adamw.update, static_argnums=3)(
        r_grads, ref_state.opt, ref_state.params, ref_adamw.AdamWConfig(division=rc.division))
    assert float(ref_adamw._global_norm(r_grads)) > 1.0
    p_params, p_opt = adamw.update(want, state.opt, state.params, opt_cfg)
    for got, w, tol in ((p_params, r_params, 1e-3 * opt_cfg.lr), (p_opt.m, r_opt.m, None),
                        (p_opt.v, r_opt.v, None)):
        w = convert.params_from_reference(jax.tree_util.tree_map(np.asarray, w), pc, "cpu")
        for a, b in zip(tree.leaves(got), tree.leaves(w)):
            assert float((a - b).abs().max()) <= (tol or 1e-6 * float(b.abs().max()))


def test_cross_entropy_matches_the_reference():
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    got = step.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    want = ref_step.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    assert abs(float(got) - float(want)) <= LOGIT_RTOL * float(want)


def _spy_counts(monkeypatch):
    counts = {"softmax_f32": 0, "rmsnorm_f32": 0, "tsdiv_recip": 0}
    for mod, attr, name in ((softmax, "softmax", "softmax_f32"),
                            (rmsnorm, "rmsnorm", "rmsnorm_f32"), (tsdiv, "recip", "tsdiv_recip")):
        real = getattr(mod, attr)

        def spy(*a, real=real, name=name, **kw):
            counts[name] += 1
            return real(*a, **kw)
        monkeypatch.setattr(mod, attr, spy)
    return counts


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_remat_gives_the_same_bits_and_runs_each_block_twice(monkeypatch, param_dtype):
    """Remat on and off give the same loss and gradients bit for bit; with
    remat each block's softmax and RMSNorm run twice a microbatch (the final
    norm once), and AdamW divides once per leaf: the counts the card's train
    phase holds its launches to."""
    base = dataclasses.replace(get_smoke_config("paper_fpdiv"), param_dtype=param_dtype,
                               division=DivisionConfig(mode="taylor_pallas", schedule="paper"))
    params = init_params(base, torch.Generator().manual_seed(0))
    batch = _torch(_tokens(base.vocab))
    outs = []
    counts = _spy_counts(monkeypatch)
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        for k in counts:
            counts[k] = 0
        outs.append(step.grads_fn(cfg, params, batch, 2))
        n = base.n_layers * (1 + remat)
        assert counts == {"softmax_f32": 2 * n, "rmsnorm_f32": 2 * (2 * n + 1), "tsdiv_recip": 0}
    (l0, _, g0), (l1, _, g1) = outs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(g0), tree.leaves(g1)))
    cfg = dataclasses.replace(base, remat=True)
    state = step.init_state(cfg, params, adamw.AdamWConfig(division=cfg.division))
    for k in counts:
        counts[k] = 0
    step.train_step(cfg, adamw.AdamWConfig(division=cfg.division), state, batch, n_micro=2)
    assert counts["tsdiv_recip"] == len(tree.leaves(params))


def test_microbatch_grads_are_cast_to_f32_and_summed_from_zero():
    """Each microbatch's gradients come out in the parameters' dtype (bf16),
    are cast to f32 and summed into zeros, then scaled by 1/n_micro, as the
    reference's scan does."""
    cfg = get_smoke_config("paper_fpdiv")
    params = init_params(cfg, torch.Generator().manual_seed(1))
    batch = _torch(_tokens(cfg.vocab, seed=2))
    loss, metrics, grads = step.grads_fn(cfg, params, batch, 2)
    parts = [step.grads_fn(cfg, params, {k: v[i * 2:(i + 1) * 2] for k, v in batch.items()}, 1)
             for i in range(2)]
    assert torch.equal(loss, (torch.zeros(()) + parts[0][0] + parts[1][0]) * 0.5)
    assert float(metrics["aux"]) == 0.0 and torch.equal(metrics["ce"], loss)
    for g, a, b in zip(tree.leaves(grads), tree.leaves(parts[0][2]), tree.leaves(parts[1][2])):
        assert g.dtype == torch.float32
        assert torch.equal(g, (torch.zeros_like(g) + a + b) * 0.5)


def _batch_for(cfg, b=4, s=32, seed=3):
    rng = np.random.default_rng(seed)
    out = {"labels": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))}
    if cfg.embed_inputs and not cfg.is_encoder_decoder:
        out["embeds"] = torch.from_numpy(rng.normal(size=(b, s, cfg.d_model)).astype(np.float32))
    else:
        out["tokens"] = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = torch.from_numpy(
            rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_step_every_arch(arch):
    """tests/test_models_smoke.py's train step on the port: two
    microbatches, a finite positive loss, every architecture's parameters
    moved (the MoE aux loss and an embedding-input model's unread token
    table included)."""
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(1))
    opt_cfg = adamw.AdamWConfig(state_dtype=cfg.opt_state_dtype, division=cfg.division)
    state = step.init_state(cfg, params, opt_cfg)
    new, metrics = step.train_step(cfg, opt_cfg, state, _batch_for(cfg), n_micro=2)
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and loss > 0
    moved = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(tree.leaves(state.params), tree.leaves(new.params)))
    assert moved > 0 and int(new.step) == 1
    assert all(bool(torch.isfinite(t.float()).all()) for t in tree.leaves(new))


def test_compress_axis_waits_for_the_mesh():
    cfg = get_smoke_config("paper_fpdiv")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    state = step.init_state(cfg, params, adamw.AdamWConfig())
    with pytest.raises(ValueError, match="needs an active mesh"):
        step.train_step(cfg, adamw.AdamWConfig(), state, _batch_for(cfg), compress_axis="pod")


# ------------------------------------------------------------------ the loop

def _data_cfg(cfg, seed=1):
    return DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8, seed=seed)


def test_loss_decreases():
    cfg = get_smoke_config("paper_fpdiv")
    out = run(cfg, LoopConfig(total_steps=25, log_every=100), _data_cfg(cfg),
              log=lambda s: None, device="cpu")
    losses = out["losses"]
    assert losses[-1] < losses[0] - 0.3, f"no learning: {losses[0]:.3f} -> {losses[-1]:.3f}"


def test_kill_resume_bit_identical(tmp_path):
    cfg = get_smoke_config("paper_fpdiv")
    dc = _data_cfg(cfg)
    lc = lambda d: LoopConfig(total_steps=14, ckpt_every=5, ckpt_dir=str(tmp_path / d),
                              log_every=100)
    logs = []
    with pytest.raises(fault.FailureInjector.Injected):
        run(cfg, lc("interrupted"), dc, injector=fault.FailureInjector(fail_at_step=8),
            log=logs.append, device="cpu")
    resumed = run(cfg, lc("interrupted"), dc, log=logs.append, device="cpu")
    straight = run(cfg, lc("straight"), dc, log=lambda s: None, device="cpu")
    assert "[resume] restored checkpoint at step 5" in logs
    assert resumed["last_step"] == straight["last_step"] == 14
    assert resumed["losses"] == straight["losses"][5:]
    for a, b in zip(tree.leaves(resumed["state"]), tree.leaves(straight["state"])):
        assert torch.equal(a, b)


def test_preemption_checkpoints_and_exits(tmp_path):
    """SIGTERM mid-run: the loop finishes its step, checkpoints it and
    returns; the next run resumes there."""
    cfg = get_smoke_config("paper_fpdiv")
    lc = LoopConfig(total_steps=6, ckpt_every=100, ckpt_dir=str(tmp_path), log_every=1)

    def log(line):
        if line.startswith("step     2"):
            os.kill(os.getpid(), signal.SIGTERM)
    out = run(cfg, lc, _data_cfg(cfg), log=log, device="cpu")
    assert out["last_step"] == 3 and len(out["losses"]) == 3
    logs = []
    out = run(cfg, lc, _data_cfg(cfg), log=logs.append, device="cpu")
    assert logs[0] == "[resume] restored checkpoint at step 3" and out["last_step"] == 6


def test_straggler_watchdog_detects_slow_step():
    wd = fault.StragglerWatchdog(threshold=3.0, warmup=3)
    for i in range(10):
        wd.observe(i, 0.1)
    ev = wd.observe(10, 1.0)
    assert ev is not None and ev.step == 10
    assert wd.ewma < 0.2            # the straggler does not poison the EWMA
    assert wd.observe(11, 0.1) is None


def test_preemption_guard_restores_handlers():
    before = signal.getsignal(signal.SIGTERM)
    with fault.PreemptionGuard() as g:
        assert not g.preempted
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.preempted
    assert signal.getsignal(signal.SIGTERM) is before


def test_launcher_trains_in_process_and_defaults_to_the_card(capsys):
    assert inspect.signature(run).parameters["device"].default == "cuda"
    assert launch_train.build_parser().parse_args([]).device == "cuda"
    out = launch_train.main(["--smoke", "--device", "cpu", "--steps", "3", "--seq-len", "16",
                             "--global-batch", "4", "--n-micro", "2",
                             "--division-mode", "taylor_pallas"])
    assert capsys.readouterr().out.strip().endswith(
        f"final loss: {out['losses'][-1]:.4f} after 3 steps")
    assert out["state"].params["lm_head"].device.type == "cpu"
