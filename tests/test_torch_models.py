"""The port's models (dense, sliding-window, MoE, Mamba-2 and hybrid,
encoder-decoder, embedding-input) against the live reference, on the same
parameters.

The reference's ``init_params`` output goes through numpy to the port
(``convert.params_from_reference``), so both packages run the same weights;
the smoke configs run with ``param_dtype="float32"``. The packages sum their
matmuls and row reductions in different orders and use different exp, pow,
sin and cos implementations (torch's CPU kernels vs XLA's), so logits are
held to ``LOGIT_RTOL`` of the largest logit (measured: <= 6e-6, jamba's
hybrid stack the largest) and greedy choices must agree on every position;
caches are held leaf by leaf to ``LOGIT_RTOL`` of each leaf's largest
value. Sequence lengths are multiples of the gemma smoke model's window and
the SSM smoke models' chunk (16), which the block-local attention and the
chunked scan need. Encoder-decoder models take seeded encoder frames,
embedding-input models seeded prompt embeddings.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs.base import get_config as ref_get_config
from repro.core.division_modes import DivisionConfig as RefDivisionConfig
from repro.models import attention as ref_attention
from repro.models import forward as ref_forward
from repro.models import layers as ref_layers
from repro.models import param_count as ref_param_count
from repro.models.model import encode as ref_encode
from repro.models.params import active_param_count as ref_active_param_count
from repro.serving import pad_cache_to as ref_pad_cache_to
from repro_torch import convert
from repro_torch.configs import base as cfg_base
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.division_modes import DivisionConfig
from repro_torch.models import (active_param_count, forward, init_params, layers,
                                param_count)
from repro_torch.models.model import encode
from repro_torch.serving import ServingEngine, pad_cache_to
from _ref_params import ref_init
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ["paper_fpdiv", "tinyllama_1_1b", "llama3_8b", "granite_8b", "gemma3_12b",
         "deepseek_moe_16b", "moonshot_v1_16b_a3b", "mamba2_780m", "jamba_1_5_large",
         "whisper_tiny", "llava_next_mistral_7b"]
MODES = ["exact", "taylor_pallas", "goldschmidt_pallas"]
LOGIT_RTOL = 1e-5


def _pair(arch, mode="exact", **kw):
    div = dict(mode=mode, schedule="paper")
    ref = dataclasses.replace(ref_smoke_config(arch), param_dtype="float32",
                              division=RefDivisionConfig(**div), **kw)
    port = dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                               division=DivisionConfig(**div), **kw)
    return ref, port


def _ref_init(cfg, seed):
    """The reference's ``init_params`` with its per-leaf key the same in
    every process (``_ref_params.ref_init``): with a per-process draw,
    jamba's f32 rounding spread against the reference went past
    ``LOGIT_RTOL`` on about 2% of the draws (ROADMAP F13)."""
    return ref_init(cfg, seed)


def _params(ref_cfg, port_cfg, seed=0):
    rp = _ref_init(ref_cfg, seed)
    return rp, convert.params_from_reference(jax.tree_util.tree_map(np.asarray, rp),
                                             port_cfg, "cpu")


def _close(got, want):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= LOGIT_RTOL, rel
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _inputs(cfg, toks, seed=5):
    """(reference kwargs, port kwargs) of a forward on ``toks`` (b, s):
    the tokens, or for an embedding-input model seeded prompt embeddings,
    and for an encoder-decoder seeded encoder frames."""
    rng = np.random.default_rng(seed)
    b, s = toks.shape
    ref, port = {}, {}
    if cfg.embed_inputs and not cfg.is_encoder_decoder:
        e = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
        ref["embeds"], port["embeds"] = jnp.asarray(e), torch.from_numpy(e)
    else:
        ref["tokens"], port["tokens"] = jnp.asarray(toks), torch.from_numpy(toks)
    if cfg.is_encoder_decoder:
        e = rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        ref["enc_embeds"], port["enc_embeds"] = jnp.asarray(e), torch.from_numpy(e)
    return ref, port


def _cache_kinds(cache):
    return {kind for g in cache["groups"] for lc in g["layers"] for kind in lc}


def _caches_close(got, want_np):
    """Every leaf of the port's cache against the reference's (as the port's
    layout), each to LOGIT_RTOL of its largest value."""
    for g, w in zip(got["groups"], want_np["groups"]):
        assert len(g["layers"]) == len(w["layers"])
        for lg, lw in zip(g["layers"], w["layers"]):
            assert set(lg) == set(lw)
            for kind in lg:
                for name, t in lg[kind].items():
                    ref = lw[kind][name].numpy()
                    assert t.shape == ref.shape and t.dtype == lw[kind][name].dtype
                    scale = np.abs(ref).max()
                    diff = np.abs(t.numpy() - ref).max()
                    assert diff <= LOGIT_RTOL * scale if scale else diff == 0, (kind, name)


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_reference_configs(arch):
    for mine, theirs in ((get_config(arch), ref_get_config(arch)),
                         (get_smoke_config(arch), ref_smoke_config(arch))):
        for f in dataclasses.fields(mine):
            if f.name == "division":
                assert dataclasses.asdict(mine.division) == dataclasses.asdict(theirs.division)
            else:
                assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
        assert [dataclasses.astuple(s) for s in mine.layer_specs()] == \
            [dataclasses.astuple(s) for s in theirs.layer_specs()]
        assert [(len(g.period), g.repeat) for g in mine.groups()] == \
            [(len(g.period), g.repeat) for g in theirs.groups()]
        assert mine.q_per_kv == theirs.q_per_kv
        assert param_count(mine) == ref_param_count(theirs)
        assert active_param_count(mine) == ref_active_param_count(theirs)
    assert get_config("tinyllama_1_1b").q_per_kv == 8


def test_unported_archs_raise_naming_the_roadmap_item():
    """Every architecture of the reference is ported: the registry resolves
    each, full and smoke, and its parameters and engine build; what the
    reference refuses is still refused (an unknown arch, a bad layer spec,
    serve() of an encoder-decoder or embedding-input model)."""
    assert cfg_base.PORTED_ARCHS == cfg_base.ARCH_IDS
    for arch in cfg_base.ARCH_IDS:
        assert get_config(arch).name == ref_get_config(arch).name
        cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32")
        params = init_params(cfg, torch.Generator().manual_seed(0))
        assert ServingEngine(cfg, params).cfg is cfg
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("no_such_model")
    with pytest.raises(ValueError, match="bad layer spec"):
        cfg_base.LayerSpec("rnn", "dense")
    for arch, what in (("whisper_tiny", "encoder-decoder"), ("llava_next_mistral_7b", "embed")):
        cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32")
        eng = ServingEngine(cfg, init_params(cfg, torch.Generator().manual_seed(0)))
        with pytest.raises(ValueError, match=what):
            eng.serve([])


def test_init_params_draws_from_the_generator_with_the_reference_scales():
    cfg = get_config("paper_fpdiv")
    a = init_params(cfg, torch.Generator().manual_seed(3))
    b = init_params(cfg, torch.Generator().manual_seed(3))
    assert torch.equal(a["lm_head"], b["lm_head"])
    assert a["embed"].dtype == torch.bfloat16 and a["final_norm"].dtype == torch.float32
    layers_ = a["groups"][0]["layers"]
    assert len(layers_) == 12 and torch.all(layers_[3]["mixer_norm"] == 1)
    assert layers_[0]["attn"]["wq"].shape == (768, 12, 64)
    assert layers_[0]["attn"]["wo"].shape == (12, 64, 768)
    assert abs(float(a["embed"].float().std()) - 1.0) < 0.01
    assert abs(float(layers_[0]["ffn"]["wo"].float().std()) * np.sqrt(2048) - 1.0) < 0.02
    assert not torch.equal(layers_[0]["attn"]["wq"], layers_[1]["attn"]["wq"])


def test_params_from_reference_carries_bf16_bits():
    cfg = ref_smoke_config("paper_fpdiv")
    rp = _ref_init(cfg, 1)
    pp = convert.params_from_reference(jax.tree_util.tree_map(np.asarray, rp),
                                       get_smoke_config("paper_fpdiv"), "cpu")
    want = np.asarray(rp["groups"][0]["layers"][0]["attn"]["wq"])      # (repeat, d, H, hd)
    for r in range(want.shape[0]):
        got = pp["groups"][0]["layers"][r]["attn"]["wq"]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want[r].view(np.int16))
    assert set(pp) == set(rp) and pp["final_norm"].dtype == torch.float32


# ------------------------------------------------------------ the forward

def test_rope_matches_the_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    want = ref_layers.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", MODES)
def test_forward_matches_the_reference_in_every_mode(arch, mode):
    """train, prefill (every leaf of its cache: attention K/V, SSM state
    and conv tails, cross K/V) and one decode step from the reference's own
    cache."""
    rc, pc = _pair(arch, mode)
    rp, pp = _params(rc, pc)
    toks = np.random.default_rng(1).integers(0, rc.vocab, (2, 32))
    rk, pk = _inputs(rc, toks)
    want, _, want_aux = ref_forward(rc, rp, mode="train", **rk)
    got, _, got_aux = forward(pc, pp, mode="train", **pk)
    _close(got, want)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)
    assert (float(want_aux) > 0) == bool(rc.n_experts)
    rk, pk = _inputs(rc, toks[:, :16])
    want, rcache, _ = ref_forward(rc, rp, mode="prefill", **rk)
    got, pcache, _ = forward(pc, pp, mode="prefill", **pk)
    _close(got, want)
    _caches_close(pcache, convert.cache_from_reference(
        jax.tree_util.tree_map(np.asarray, rcache), pc, "cpu"))
    kinds = {"attn"} if rc.family not in ("ssm", "hybrid") else {"mamba"}
    kinds |= {"attn"} if rc.family == "hybrid" else set()
    kinds |= {"cross"} if rc.is_encoder_decoder else set()
    assert _cache_kinds(pcache) == kinds
    rcache = ref_pad_cache_to(rcache, 16, 24, rc)
    cache = convert.cache_from_reference(jax.tree_util.tree_map(np.asarray, rcache), pc, "cpu")
    pos = np.array([16, 11], np.int32)
    want, _, _ = ref_forward(rc, rp, tokens=jnp.asarray(toks[:, 16:17]), cache=rcache,
                             pos=jnp.asarray(pos), mode="decode")
    got, _, _ = forward(pc, pp, tokens=torch.from_numpy(toks[:, 16:17]), cache=cache,
                        pos=torch.from_numpy(pos), mode="decode")
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_the_full_forward(arch):
    # MoE at capacity_factor 8: the full forward drops no token either. An
    # embedding-input model runs on the embeddings of the tokens it decodes.
    _, cfg = _pair(arch, "taylor_pallas", capacity_factor=8.0)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 32))
    _, kw = _inputs(cfg, toks)
    if "embeds" in kw:
        kw["embeds"] = params["embed"][torch.from_numpy(toks)]
    full, _, _ = forward(cfg, params, mode="train", **kw)
    _, kw16 = _inputs(cfg, toks[:, :16])
    if "embeds" in kw16:
        kw16["embeds"] = kw["embeds"][:, :16]
    _, cache, _ = forward(cfg, params, mode="prefill", **kw16)
    cache = pad_cache_to(cache, 16, 32, cfg)
    scale = float(full.abs().max())
    for t in range(16, 32):
        logits, cache, _ = forward(cfg, params, tokens=torch.from_numpy(toks[:, t:t + 1]),
                                   cache=cache, pos=t, mode="decode")
        assert float((logits[:, 0] - full[:, t]).abs().max()) / scale < 1e-5


def test_encoder_is_the_references_and_causal():
    """The encoder equals the reference's ``encode``, which runs its
    attention causal (its docstring says non-causal; ROADMAP F9): a later
    frame changes no earlier output."""
    rc, pc = _pair("whisper_tiny", "taylor_pallas")
    rp, pp = _params(rc, pc)
    e = np.random.default_rng(3).normal(size=(2, rc.encoder_seq, rc.d_model)).astype(np.float32)
    got = encode(pc, pp["encoder"], torch.from_numpy(e))
    want = np.asarray(ref_encode(rc, rp["encoder"], jnp.asarray(e)))
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= LOGIT_RTOL
    e2 = e.copy()
    e2[:, -1] += 1.0
    moved = encode(pc, pp["encoder"], torch.from_numpy(e2))
    torch.testing.assert_close(moved[:, :-1], got[:, :-1], rtol=0, atol=0)
    assert not torch.equal(moved[:, -1], got[:, -1])


def test_embedding_inputs_take_the_place_of_tokens():
    """A VLM's forward from the embeddings of its tokens is its forward
    from the tokens (decode reads tokens through the same table)."""
    _, pc = _pair("llava_next_mistral_7b", "taylor_pallas")
    pp = init_params(pc, torch.Generator().manual_seed(4))
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, pc.vocab, (2, 16)))
    by_tok, _, _ = forward(pc, pp, tokens=toks, mode="train")
    by_emb, _, _ = forward(pc, pp, embeds=pp["embed"][toks], mode="train")
    torch.testing.assert_close(by_emb, by_tok, rtol=0, atol=0)


def test_query_chunking_equals_one_chunk():
    _, cfg = _pair("paper_fpdiv", "taylor_pallas")
    params = init_params(cfg, torch.Generator().manual_seed(4))
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (2, 24)))
    whole, _, _ = forward(cfg, params, tokens=toks)
    chunked, _, _ = forward(dataclasses.replace(cfg, attn_chunk=8), params, tokens=toks)
    torch.testing.assert_close(chunked, whole, rtol=1e-6, atol=1e-6)


def test_unported_blocks_and_kv_layouts():
    """Every block kind builds now: a family="ssm" config gets Mamba blocks
    with no FFN, an encoder-decoder cross attention and an encoder; the GQA
    head repeat is the reference's; an unknown mode is refused."""
    cfg = _pair("paper_fpdiv")[1]
    params = init_params(cfg, torch.Generator().manual_seed(0))
    ssm = dataclasses.replace(cfg, family="ssm", ssm_state=8, ssm_heads=2, ssm_head_dim=8,
                              d_inner=16)
    block = init_params(ssm, torch.Generator().manual_seed(0))["groups"][0]["layers"][0]
    assert set(block) == {"mixer_norm", "mamba"}
    assert block["mamba"]["A_log"].dtype == torch.float32
    assert block["mamba"]["wx"].shape == (cfg.d_model, 16)
    encdec = dataclasses.replace(cfg, is_encoder_decoder=True, n_encoder_layers=3,
                                 encoder_seq=8)
    ep = init_params(encdec, torch.Generator().manual_seed(0))
    assert set(ep["groups"][0]["layers"][0]) == {"mixer_norm", "attn", "cross_norm", "cross",
                                                 "ffn_norm", "ffn"}
    assert len(ep["encoder"]["groups"][0]["layers"]) == 3
    k = torch.arange(2 * 3 * 2 * 4, dtype=torch.float32).reshape(2, 3, 2, 4)
    from repro_torch.models.attention import _repeat_kv

    want = ref_attention._repeat_kv(jnp.asarray(k.numpy()), 3)
    np.testing.assert_array_equal(_repeat_kv(k, 3).numpy(), want)
    with pytest.raises(ValueError, match="mode"):
        forward(cfg, params, tokens=torch.zeros((1, 2), dtype=torch.int64), mode="bogus")
