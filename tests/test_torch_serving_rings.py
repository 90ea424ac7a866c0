"""Serving the sliding-window (gemma3) and MoE (deepseek) smoke models.

The reference's serving gates for these families (``tests/test_decode_equiv.py``
and ``tests/test_serving_correctness.py``) run against the port, in f32 and,
for MoE, at ``capacity_factor=8.0``: drop-free routing, so that a token's
experts do not depend on the rest of the batch (pad tokens take capacity in
a padded prefill, as in the reference). The port's greedy tokens also equal
the reference's on the same parameters.
"""
import contextlib
import dataclasses
import io

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.serving import ServingEngine as RefServingEngine
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core.division_modes import DivisionConfig
from repro_torch.launch import serve as serve_cli
from repro_torch.models import forward, init_params
from repro_torch.serving import Request, ServingEngine, pad_cache_to
from _ref_params import ref_init
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ["gemma3_12b", "deepseek_moe_16b"]
# One prompt exactly the gemma smoke model's window (16).
PROMPTS = [list(range(1, 12)), list(range(3, 25)), list(range(5, 21))]


def _setup(arch, *, max_len=96, seed=0, **engine_kw):
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                              capacity_factor=8.0)
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    return cfg, params, ServingEngine(cfg, params, max_len=max_len, **engine_kw)


def _toks(cfg, shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, shape))


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_padded_matches_single(arch):
    """Prompts pad to a multiple of the window; generate_batch must be
    token-identical to per-request generate."""
    _, _, eng = _setup(arch)
    assert eng._pad_to(22) == (32 if arch == "gemma3_12b" else 22)
    singles = [eng.generate(p, max_new=5) for p in PROMPTS]
    assert eng.generate_batch(PROMPTS, max_new=5) == singles


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_full(arch):
    cfg, params, _ = _setup(arch)
    S, total = 32, 48
    toks = _toks(cfg, (2, total), 0)
    full, _, _ = forward(cfg, params, tokens=toks, mode="train")
    _, cache, _ = forward(cfg, params, tokens=toks[:, :S], mode="prefill")
    cache = pad_cache_to(cache, S, total, cfg)
    errs = []
    for t in range(8):
        dl, cache, _ = forward(cfg, params, tokens=toks[:, S + t:S + t + 1],
                               cache=cache, pos=S + t, mode="decode")
        errs.append(float((dl[:, 0] - full[:, S + t]).abs().max()))
    assert max(errs) / float(full.abs().max()) < 3e-4


def test_swa_ring_cache_wraps():
    """Decode through two more windows: ring slots recycle and every step
    matches the full forward at that position."""
    cfg, params, _ = _setup("gemma3_12b", seed=1)
    W = cfg.sliding_window
    toks = _toks(cfg, (1, 4 * W), 1)
    full, _, _ = forward(cfg, params, tokens=toks, mode="train")
    _, cache, _ = forward(cfg, params, tokens=toks[:, :2 * W], mode="prefill")
    cache = pad_cache_to(cache, 2 * W, 4 * W, cfg)
    scale = float(full.abs().max())
    for t in range(2 * W, 4 * W):
        dl, cache, _ = forward(cfg, params, tokens=toks[:, t:t + 1], cache=cache,
                               pos=t, mode="decode")
        assert float((dl[:, 0] - full[:, t]).abs().max()) / scale < 3e-4


def test_ring_from_prefill_keeps_pad_tokens_out():
    """A padded prefill with ``lengths`` leaves in each ring exactly the
    row's last W real positions, as a prefill of that row alone does."""
    cfg, params, _ = _setup("gemma3_12b")
    toks = _toks(cfg, (2, 32), 2)
    lens = [32, 12]
    _, cache, _ = forward(cfg, params, tokens=toks, mode="prefill",
                          lengths=torch.tensor(lens))
    for i, n in enumerate(lens):
        _, alone, _ = forward(cfg, params, tokens=toks[i:i + 1, :n], mode="prefill")
        for li, spec in enumerate(cfg.layer_specs()[:3]):     # swa, swa, attn
            got = cache["groups"][0]["layers"][li]["attn"]["k"][i]
            want = alone["groups"][0]["layers"][li]["attn"]["k"][0]
            if spec.mixer == "swa":
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
                assert torch.all(got[n:] == 0)     # slots no position has held
            else:
                torch.testing.assert_close(got[:n], want, rtol=1e-5, atol=1e-6)


def test_pad_cache_to_ring_window_equals_prompt():
    """With W == the prefill length, rings stay W slots and only the
    full-attention caches grow; decoding past the window still matches."""
    cfg, params, _ = _setup("gemma3_12b")
    W = cfg.sliding_window
    _, cache, _ = forward(cfg, params, tokens=_toks(cfg, (1, W), 7), mode="prefill")
    grown = pad_cache_to(cache, W, 64, cfg)
    sizes = {(spec.mixer, lc["attn"]["k"].shape[1])
             for spec, lc in zip(cfg.layer_specs(), grown["groups"][0]["layers"])}
    assert sizes == {("swa", W), ("attn", 64)}
    eng = ServingEngine(cfg, params, max_len=64)
    single = eng.generate(list(range(1, W + 1)), max_new=W + 4)
    batch = eng.generate_batch([list(range(1, W + 1)), list(range(2, W - 3))],
                               max_new=W + 4)
    assert batch[0] == single


def _replay(engine, prompts, steps, teacher=None):
    """Greedy decode through the engine's own steps; with ``teacher`` that
    token stream is fed back (tests/test_decode_equiv.py's _replay)."""
    B, lens = len(prompts), [len(p) for p in prompts]
    toks = torch.zeros((B, engine._pad_to(max(lens))), dtype=torch.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    lengths = torch.tensor(lens, dtype=torch.int32)
    logits, cache = engine._prefill_tok(toks, lengths)
    cache = pad_cache_to(cache, toks.shape[1], engine.max_len, engine.cfg)
    pos, picks, seen = lengths, [], []
    for t in range(steps):
        seen.append(logits.numpy())
        choice = torch.argmax(logits, -1)[:, None].to(torch.int32)
        picks.append(choice[:, 0].numpy())
        feed = choice if teacher is None else torch.as_tensor(teacher[t])[:, None]
        logits, cache = engine._decode(cache, feed.to(torch.int32), pos)
        pos = pos + 1
    return np.stack(picks), np.stack(seen)


@pytest.mark.parametrize("arch,modes", [("gemma3_12b", ["taylor"])])
def test_serving_mode_equivalence_vs_exact(arch, modes):
    """The reference's gate: >= 99% greedy agreement with the exact twin
    under teacher forcing, logit drift < 5e-3."""
    cfg, params, _ = _setup(arch)
    prompts = [list(range(1, 14)), list(range(3, 20))]
    exact = ServingEngine(cfg, params, max_len=96, division=DivisionConfig(mode="exact"))
    teacher, exact_logits = _replay(exact, prompts, 24)
    scale = float(np.abs(exact_logits).max())
    for mode in modes:
        eng = ServingEngine(cfg, params, max_len=96,
                            division=DivisionConfig(mode=mode, n_iters=2))
        picks, logits = _replay(eng, prompts, 24, teacher)
        assert float(np.mean(picks == teacher)) >= 0.99
        assert float(np.abs(logits - exact_logits).max()) / scale < 5e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_with_rings_admits_and_finishes_every_request(arch):
    """4 requests through 2 slots (slot refill, per-request max_new): each
    request finishes with generate()'s tokens."""
    _, _, eng = _setup(arch)
    reqs = [Request(list(range(1, 10)), max_new=4),
            Request(list(range(2, 20)), max_new=20),
            Request(list(range(4, 11)), max_new=3),
            Request(list(range(7, 40)), max_new=5)]
    eng.serve(reqs, slots=2)
    assert all(r.done and len(r.out) == r.max_new for r in reqs)
    for r in reqs:
        assert r.out == eng.generate(r.tokens, max_new=r.max_new)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_the_reference(arch):
    rcfg = dataclasses.replace(ref_smoke_config(arch), param_dtype="float32",
                               capacity_factor=8.0)
    rparams = ref_init(rcfg, 0)
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                              capacity_factor=8.0)
    params = convert.params_from_reference(jax.tree_util.tree_map(np.asarray, rparams),
                                           cfg, "cpu")
    want = RefServingEngine(rcfg, rparams, max_len=64).generate_batch(PROMPTS, 12)
    assert ServingEngine(cfg, params, max_len=64).generate_batch(PROMPTS, 12) == want


def test_serve_cli_serves_the_new_archs_on_the_cpu():
    for arch in ARCHS:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                            "--division-mode", "taylor_pallas", "--prompt-len", "20",
                            "--max-new", "3", "--batch", "2"])
        text = out.getvalue()
        assert "division=taylor_pallas" in text and text.count("generated 3 tokens") == 2
