"""The port's models (dense, sliding-window, MoE) against the live reference,
on the same parameters.

The reference's ``init_params`` output goes through numpy to the port
(``convert.params_from_reference``), so both packages run the same weights;
the smoke configs run with ``param_dtype="float32"``. The packages sum their
matmuls and row reductions in different orders and use different exp, pow,
sin and cos implementations (torch's CPU kernels vs XLA's), so logits are
held to ``LOGIT_RTOL`` of the largest logit (measured: <= 6e-7) and greedy
choices must agree on every position. Sequence lengths are multiples of the
gemma smoke model's window (16), which its block-local attention needs.
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
from repro.models import init_params as ref_init_params
from repro.models import layers as ref_layers
from repro.models import param_count as ref_param_count
from repro.models.params import active_param_count as ref_active_param_count
from repro.serving import pad_cache_to as ref_pad_cache_to
from repro_torch import convert
from repro_torch.configs import base as cfg_base
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.division_modes import DivisionConfig
from repro_torch.models import (active_param_count, forward, init_params, layers,
                                param_count)
from repro_torch.serving import pad_cache_to

ARCHS = ["paper_fpdiv", "tinyllama_1_1b", "llama3_8b", "granite_8b", "gemma3_12b",
         "deepseek_moe_16b", "moonshot_v1_16b_a3b"]
MODES = ["exact", "taylor_pallas", "goldschmidt_pallas"]
LOGIT_RTOL = 1e-5


def _pair(arch, mode="exact", **kw):
    div = dict(mode=mode, schedule="paper")
    ref = dataclasses.replace(ref_smoke_config(arch), param_dtype="float32",
                              division=RefDivisionConfig(**div), **kw)
    port = dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                               division=DivisionConfig(**div), **kw)
    return ref, port


def _params(ref_cfg, port_cfg, seed=0):
    rp = ref_init_params(ref_cfg, jax.random.PRNGKey(seed))
    return rp, convert.params_from_reference(jax.tree_util.tree_map(np.asarray, rp),
                                             port_cfg, "cpu")


def _close(got, want):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= LOGIT_RTOL, rel
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


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
    for arch in cfg_base.ARCH_IDS:
        if arch in cfg_base.PORTED_ARCHS:
            continue
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 10"):
            get_smoke_config(arch)
    assert set(cfg_base.ARCH_IDS) - set(cfg_base.PORTED_ARCHS) == {
        "mamba2_780m", "jamba_1_5_large", "whisper_tiny", "llava_next_mistral_7b"}
    for arch, what in (("mamba2_780m", "SSM"), ("whisper_tiny", "encoder-decoder"),
                       ("llava_next_mistral_7b", "embedding inputs")):
        with pytest.raises(NotImplementedError, match=what):
            get_config(arch)
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("no_such_model")


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
    rp = ref_init_params(cfg, jax.random.PRNGKey(1))
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
    """train, prefill (with its cache) and one decode step from the
    reference's own cache."""
    rc, pc = _pair(arch, mode)
    rp, pp = _params(rc, pc)
    toks = np.random.default_rng(1).integers(0, rc.vocab, (2, 32))
    want, _, want_aux = ref_forward(rc, rp, tokens=jnp.asarray(toks), mode="train")
    got, _, got_aux = forward(pc, pp, tokens=torch.from_numpy(toks), mode="train")
    _close(got, want)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)
    assert (float(want_aux) > 0) == bool(rc.n_experts)
    want, rcache, _ = ref_forward(rc, rp, tokens=jnp.asarray(toks[:, :16]), mode="prefill")
    got, pcache, _ = forward(pc, pp, tokens=torch.from_numpy(toks[:, :16]), mode="prefill")
    _close(got, want)
    k_ref = np.asarray(rcache["groups"][0]["layers"][0]["attn"]["k"])
    g0 = pc.groups()[0]                 # its last repeat's first layer
    k_port = pcache["groups"][0]["layers"][(g0.repeat - 1) * len(g0.period)]["attn"]["k"].numpy()
    np.testing.assert_allclose(k_port, k_ref[-1] if k_ref.ndim == 5 else k_ref,
                               rtol=1e-5, atol=1e-5)
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
    # MoE at capacity_factor 8: the full forward drops no token either.
    _, cfg = _pair(arch, "taylor_pallas", capacity_factor=8.0)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 32)))
    full, _, _ = forward(cfg, params, tokens=toks, mode="train")
    _, cache, _ = forward(cfg, params, tokens=toks[:, :16], mode="prefill")
    cache = pad_cache_to(cache, 16, 32, cfg)
    scale = float(full.abs().max())
    for t in range(16, 32):
        logits, cache, _ = forward(cfg, params, tokens=toks[:, t:t + 1], cache=cache,
                                   pos=t, mode="decode")
        assert float((logits[:, 0] - full[:, t]).abs().max()) / scale < 1e-5


def test_query_chunking_equals_one_chunk():
    _, cfg = _pair("paper_fpdiv", "taylor_pallas")
    params = init_params(cfg, torch.Generator().manual_seed(4))
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (2, 24)))
    whole, _, _ = forward(cfg, params, tokens=toks)
    chunked, _, _ = forward(dataclasses.replace(cfg, attn_chunk=8), params, tokens=toks)
    torch.testing.assert_close(chunked, whole, rtol=1e-6, atol=1e-6)


def test_unported_blocks_and_kv_layouts():
    cfg = _pair("paper_fpdiv")[1]
    params = init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_params(dataclasses.replace(cfg, family="ssm"),
                    torch.Generator().manual_seed(0))
    k = torch.arange(2 * 3 * 2 * 4, dtype=torch.float32).reshape(2, 3, 2, 4)
    from repro_torch.models.attention import _repeat_kv

    want = ref_attention._repeat_kv(jnp.asarray(k.numpy()), 3)
    np.testing.assert_array_equal(_repeat_kv(k, 3).numpy(), want)
    with pytest.raises(ValueError, match="mode"):
        forward(cfg, params, tokens=torch.zeros((1, 2), dtype=torch.int64), mode="bogus")
