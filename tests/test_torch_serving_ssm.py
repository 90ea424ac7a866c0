"""Serving the SSM (mamba2), hybrid (jamba), encoder-decoder (whisper) and
embedding-input (llava) smoke models.

The reference's serving gates for these families (``tests/
test_serving_correctness.py``, ``tests/test_decode_equiv.py``) run against
the port in f32 and, for jamba's MoE layers, at ``capacity_factor=8.0``
(drop-free routing, so a token's experts do not depend on the rest of the
batch). Prompts pad to the SSM chunk (16 in the smoke models); pad tokens
are SSM no-ops. The port's greedy tokens also equal the reference's on the
same parameters, encoder frames and prompt embeddings.
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
from repro_torch.models import init_params
from repro_torch.serving import Request, ServingEngine, alignment, pad_cache_to
from _ref_params import ref_init
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SSM = ["mamba2_780m", "jamba_1_5_large"]
ARCHS = SSM + ["whisper_tiny", "llava_next_mistral_7b"]
PROMPTS = [list(range(1, 12)), list(range(3, 25)), list(range(5, 21))]


def _cfg(arch, get=get_smoke_config):
    return dataclasses.replace(get(arch), param_dtype="float32", capacity_factor=8.0)


def _setup(arch, *, max_len=96, seed=0, **engine_kw):
    cfg = _cfg(arch)
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    return cfg, params, ServingEngine(cfg, params, max_len=max_len, **engine_kw)


def _hand_offs(cfg, seed=3):
    """generate_batch's keyword inputs beside the prompts: seeded encoder
    frames (B, encoder_seq, d) or per-request prompt embeddings (len_i, d)."""
    rng = np.random.default_rng(seed)
    if cfg.is_encoder_decoder:
        return {"enc_embeds": rng.normal(size=(len(PROMPTS), cfg.encoder_seq,
                                               cfg.d_model)).astype(np.float32)}
    if cfg.embed_inputs:
        return {"embeds": [rng.normal(size=(len(p), cfg.d_model)).astype(np.float32)
                           for p in PROMPTS]}
    return {}


def _single(kw, i):
    return {k: v[i] for k, v in kw.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_padded_matches_single(arch):
    """Prompts pad to a multiple of the chunk; generate_batch must be
    token-identical to per-request generate."""
    cfg, _, eng = _setup(arch)
    assert eng._pad_to(22) == (32 if cfg.family in ("ssm", "hybrid") else 22)
    kw = _hand_offs(cfg)
    prompts = None if "embeds" in kw else PROMPTS
    singles = [eng.generate(None if prompts is None else p, max_new=5, **_single(kw, i))
               for i, p in enumerate(PROMPTS)]
    assert eng.generate_batch(prompts, max_new=5, **kw) == singles


@pytest.mark.parametrize("arch", SSM)
def test_serve_matches_generate_batch_and_generate(arch):
    """4 requests through 2 slots: each slot's SSM state and conv tails are
    written at admission; every request ends with generate()'s tokens, and
    the first two with generate_batch's."""
    _, _, eng = _setup(arch)
    reqs = [Request(list(range(1, 10)), max_new=4),
            Request(list(range(2, 20)), max_new=20),
            Request(list(range(4, 11)), max_new=3),
            Request(list(range(7, 40)), max_new=5)]
    eng.serve(reqs, slots=2)
    assert all(r.done and len(r.out) == r.max_new for r in reqs)
    for r in reqs:
        assert r.out == eng.generate(r.tokens, max_new=r.max_new)
    gb = eng.generate_batch([r.tokens for r in reqs[:2]], max_new=20)
    assert reqs[0].out == gb[0][:4] and reqs[1].out == gb[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_the_reference(arch):
    rcfg = _cfg(arch, ref_smoke_config)
    rparams = ref_init(rcfg, 0)
    cfg = _cfg(arch)
    params = convert.params_from_reference(jax.tree_util.tree_map(np.asarray, rparams),
                                           cfg, "cpu")
    kw = _hand_offs(cfg)
    prompts = None if "embeds" in kw else PROMPTS
    want = RefServingEngine(rcfg, rparams, max_len=64).generate_batch(prompts, 12, **kw)
    assert ServingEngine(cfg, params, max_len=64).generate_batch(prompts, 12, **kw) == want


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


@pytest.mark.parametrize("arch,modes", [("jamba_1_5_large", ["goldschmidt"])])
def test_serving_mode_equivalence_vs_exact(arch, modes):
    """The reference's gate (tests/test_decode_equiv.py, jamba in
    goldschmidt): >= 99% greedy agreement with the exact twin under teacher
    forcing, logit drift < 5e-3."""
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


def test_alignment_and_pad_cache_to_pass_ssm_and_cross_caches_through():
    """Prompts pad to lcm(window, ssm_chunk) for SSM and hybrid models
    (256 at full width); pad_cache_to grows only the full-attention K/V."""
    from repro_torch.configs import get_config

    assert [alignment(get_config(a)) for a in ARCHS] == [256, 256, 1, 1]
    assert alignment(dataclasses.replace(_cfg("jamba_1_5_large"), sliding_window=24)) == 48
    cfg, params, eng = _setup("jamba_1_5_large")
    _, cache = eng._prefill_tok(torch.tensor([list(range(1, 17))]), [16])
    grown = pad_cache_to(cache, 16, 40, cfg)
    for spec, lc, lg in zip(cfg.layer_specs(), cache["groups"][0]["layers"],
                            grown["groups"][0]["layers"]):
        if spec.mixer == "mamba":
            assert all(lg["mamba"][k] is lc["mamba"][k] for k in lc["mamba"])
        else:
            assert lg["attn"]["k"].shape[1] == 40
    wcfg, wparams, weng = _setup("whisper_tiny")
    enc = torch.from_numpy(_hand_offs(wcfg)["enc_embeds"][:1])
    _, wc = weng._prefill_enc(torch.tensor([list(range(1, 17))]), enc, [16])
    wg = pad_cache_to(wc, 16, 40, wcfg)
    for lc, lg in zip(wc["groups"][0]["layers"], wg["groups"][0]["layers"]):
        assert lg["cross"]["ck"] is lc["cross"]["ck"]
        assert lg["cross"]["ck"].shape == (1, wcfg.encoder_seq, wcfg.n_kv_heads, wcfg.head_dim)
        assert lg["attn"]["k"].shape[1] == 40


def test_encoder_decoder_and_embedding_inputs_refuse_what_the_reference_refuses():
    for arch, missing, served in (("whisper_tiny", "enc_embeds=", "encoder-decoder config"),
                                  ("llava_next_mistral_7b", "embeds=", "embed-input config")):
        _, _, eng = _setup(arch)
        with pytest.raises(ValueError, match=missing):
            eng.generate_batch(PROMPTS, max_new=2)
        with pytest.raises(ValueError, match=served):
            eng.serve([Request(list(range(1, 5)), max_new=2)])


def test_serve_cli_on_the_cpu():
    """The launcher serves the SSM models; as the reference's launcher it
    passes neither encoder frames nor embeddings, so whisper and llava stop
    at the engine's ValueError."""
    for arch in SSM:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                            "--division-mode", "taylor_pallas", "--prompt-len", "20",
                            "--max-new", "3", "--batch", "2"])
        text = out.getvalue()
        assert "division=taylor_pallas" in text and text.count("generated 3 tokens") == 2
    for arch, what in (("whisper_tiny", "enc_embeds="), ("llava_next_mistral_7b", "embeds=")):
        with contextlib.redirect_stdout(io.StringIO()), pytest.raises(ValueError, match=what):
            serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--max-new", "2"])

