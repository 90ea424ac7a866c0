"""Model assembly: decoder stacks of attention, sliding-window and Mamba-2
mixers with dense, MoE or no FFNs, the encoder-decoder's encoder and cross
attention, and embedding inputs.

The PyTorch counterpart of ``src/repro/models/model.py``. The reference
lowers each group of layers as one ``lax.scan`` over stacked parameters;
here a Python loop runs a group's ``repeat * period`` layers in order (see
:mod:`.params` for the layout).

Modes: ``train`` (no cache), ``prefill`` (emit cache), ``decode`` (carry
cache). Sliding-window layers keep a W-slot ring cache: slot = position %
W; attention K/V are updated in place (see :mod:`.attention`), a Mamba
layer's state and conv window are replaced each step, and an
encoder-decoder's cross K/V are computed at prefill and read as they are.

In ``train`` with ``cfg.remat`` and autograd on, each decoder block runs
under ``torch.utils.checkpoint`` (the reference checkpoints each scan body):
the backward pass recomputes the block from its input, so its kernels run
twice. The encoder and the final norm are not recomputed, as in the
reference.

Under an active mesh whose ``model`` axis holds more than one rank
(``sharding.rules.use_mesh``) the attention, MLP, Mamba-2 and vocab weights
run split over it, and wherever the experts' specs put them on a live axis
the MoE FFN's experts run split too (``models/parallel.py``,
``models/moe.py``): each rank takes its blocks of the parameters
(DTensors, the global tree or its own blocks), the logits are its vocab
block, and the cache holds its KV heads and Mamba-2 heads. The tokens
given are the whole batch on every rank, unless
``sharding.rules.split_tokens`` says they are the rank's block of it (the
train step). A leaf that its spec puts on a batch axis (FSDP) is the
rank's block of it, put together at the top of each block (under remat,
again in the recompute) and where the embedding, final norm and LM head
are read; the gathered copy lives while its block runs.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.configs.base import LayerSpec, ModelConfig
from .attention import (abstract_cache_attn, decode_attention, decode_positions, enter,
                        full_attention, init_cache_attn, project_kv, sliding_attention)
from .layers import embed_tokens, gated_mlp, lm_logits, rms_norm
from .mamba2 import abstract_cache_mamba, decode_mamba, init_cache_mamba, mamba_mixer
from .moe import moe_ffn, where
from .parallel import local_params, tensor_parallel
from .params import torch_dtype

__all__ = ["block_forward", "encode", "forward", "make_cache", "group_layers"]


def group_layers(group) -> List[LayerSpec]:
    """The group's layers in order: its period, ``repeat`` times."""
    return [s for _ in range(group.repeat) for s in group.period]


def _ring_from_prefill(k, window: int, lengths=None):
    """Arrange prefill K (or V) ``(b, s, ...)`` into ring order slot = pos % W.

    Without ``lengths`` the ring holds the last W positions (zero-padded
    when s < W). With per-request ``lengths`` (a right-padded batch) row i
    holds its last W real positions lengths[i]-W .. lengths[i]-1, so pad
    tokens never enter the ring; positions < 0 (a prompt shorter than the
    window) leave zero slots that decode's validity mask excludes.
    """
    b, s = k.shape[0], k.shape[1]
    ring = torch.zeros((b, window, *k.shape[2:]), dtype=k.dtype, device=k.device)
    if lengths is None:
        if s <= window:
            ring[:, :s] = k
            return ring
        slots = torch.remainder(torch.arange(s - window, s, device=k.device), window)
        ring[:, slots] = k[:, -window:]
        return ring
    pos = (lengths.to(torch.int64)[:, None] - window
           + torch.arange(window, device=k.device)[None, :])          # (b, W)
    ok = (pos >= 0).reshape(b, window, *[1] * (k.dim() - 2))
    idx = pos.clamp_min(0).reshape(b, window, *[1] * (k.dim() - 2)).expand(
        b, window, *k.shape[2:])
    gathered = torch.where(ok, torch.gather(k, 1, idx), 0)
    # pos covers W consecutive ints per row, so mod W is a bijection onto
    # the slots: the zeroed (negative) entries land on slots no real one takes.
    ring[torch.arange(b, device=k.device)[:, None], torch.remainder(pos, window)] = gathered
    return ring


def block_forward(bp: Dict, x, spec: LayerSpec, cfg: ModelConfig, positions,
                  *, mode: str, cache=None, pos=None, enc_out=None, lengths=None, tp=None,
                  at=None):
    """One block; returns (x, new_cache, aux). ``enc_out`` (train and
    prefill of an encoder-decoder): the encoder's output, which the cross
    attention projects to K/V. ``lengths`` (prefill only): the real prompt
    lengths of a right-padded batch, which make pad tokens SSM no-ops and
    keep them out of sliding-window rings. ``tp``: the rank's tensor-parallel
    plan (``models/parallel.py``), ``bp`` its blocks; ``at``: where the MoE
    FFN routes (``moe.where``)."""
    div = cfg.division
    if tp is not None and tp.fsdp:
        bp = tp.gather_block(bp, spec, "cross" in bp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: Dict[str, Any] = {}
    h = rms_norm(x, bp["mixer_norm"], div, cfg.norm_eps)
    if spec.mixer == "mamba":
        if mode == "decode":
            mh, new_cache["mamba"] = decode_mamba(bp["mamba"], h, cache["mamba"], cfg, tp)
        elif mode == "prefill":
            mh, new_cache["mamba"] = mamba_mixer(bp["mamba"], h, cfg, return_state=True,
                                                 lengths=lengths, tp=tp)
        else:
            mh = mamba_mixer(bp["mamba"], h, cfg, tp=tp)
        x = x + mh
    else:
        window = cfg.sliding_window if spec.mixer == "swa" else 0
        if mode == "decode":
            ah, new_cache["attn"] = decode_attention(bp["attn"], h, cache["attn"],
                                                     pos, cfg, window=window, tp=tp)
        else:
            fn = sliding_attention if window else full_attention
            ah, (k, v) = fn(bp["attn"], h, positions, cfg, return_kv=True, tp=tp)
            if mode == "prefill":
                if window:
                    k = _ring_from_prefill(k, window, lengths)
                    v = _ring_from_prefill(v, window, lengths)
                dt = torch_dtype(cfg.param_dtype)
                new_cache["attn"] = {"k": k.to(dt), "v": v.to(dt)}
        x = x + ah

    if "cross" in bp:  # encoder-decoder cross attention (no rope on its K/V)
        hc = rms_norm(x, bp["cross_norm"], div, cfg.norm_eps)
        if mode == "decode":
            kv = (cache["cross"]["ck"], cache["cross"]["cv"])
            ch, _ = decode_attention(bp["cross"], hc, None, pos, cfg, kv_override=kv,
                                     tp=tp)
            new_cache["cross"] = cache["cross"]
        else:
            ck, cv = project_kv(bp["cross"], enter(enc_out, tp), tp)
            ch = full_attention(bp["cross"], hc, positions, cfg, causal=False,
                                kv_override=(ck, cv), tp=tp)
            if mode == "prefill":
                new_cache["cross"] = {"ck": ck, "cv": cv}
        x = x + ch

    if spec.ffn != "none":
        h2 = rms_norm(x, bp["ffn_norm"], div, cfg.norm_eps)
        if spec.ffn == "moe":
            ff, a = moe_ffn(bp["ffn"], h2, cfg, at)
            aux = aux + a
        else:
            ff = gated_mlp(bp["ffn"], h2, tp)
        x = x + ff
    return x, new_cache, aux


def _remat_block(*args, **kw):
    """block_forward whose activations the backward pass recomputes. A block
    draws no random numbers, so the recompute needs no RNG state."""
    return checkpoint(block_forward, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def _top(params, name: str, tp):
    """A top-level leaf as the model reads it: gathered where it is stored
    as the rank's block over a batch axis."""
    return params[name] if tp is None else tp.gather_top(params[name], name)


def encode(cfg: ModelConfig, enc_params, enc_embeds, tp=None):
    """The encoder over stub frontend embeddings (b, s, d_model): attention
    and dense blocks, then the final norm. Its attention is causal: the
    reference's ``encode`` runs ``full_attention`` with its default
    ``causal=True`` (ROADMAP F9). ``tp``: as :func:`block_forward`'s, with
    ``enc_params`` the rank's blocks."""
    b, s, _ = enc_embeds.shape
    x = enc_embeds.to(torch_dtype(cfg.param_dtype))
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    spec = LayerSpec("attn", "dense")
    for lp in enc_params["groups"][0]["layers"]:
        x, _, _ = block_forward(lp, x, spec, cfg, positions, mode="train", tp=tp)
    return rms_norm(x, _top(enc_params, "final_norm", tp), cfg.division, cfg.norm_eps)


def forward(cfg: ModelConfig, params, *, tokens=None, embeds=None, cache=None, pos=None,
            mode: str = "train", enc_embeds=None, lengths=None):
    """Returns (logits (b, s, V) f32, new_cache, aux f32 scalar).

    ``embeds`` (b, s, d_model) take the place of ``tokens`` for an
    embedding-input model (not an encoder-decoder); ``enc_embeds`` feed an
    encoder-decoder's encoder in train and prefill (decode reads the cross
    K/V from the cache). ``pos`` (decode) is a scalar or a per-request (b,)
    vector. ``lengths`` (prefill) marks per-request real prompt lengths of a
    right-padded batch: pad positions become SSM no-ops and are kept out of
    sliding-window rings.

    Under an active mesh with a ``model`` axis above 1 the logits are the
    rank's vocab block (all of them where ``vocab`` does not split) and the
    cache holds the rank's KV heads.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    tp = tensor_parallel(cfg)
    if tp is not None:
        params = local_params(cfg, params, tp)
    enc_out = None
    if cfg.is_encoder_decoder and mode != "decode":
        enc_out = encode(cfg, params["encoder"], enc_embeds, tp)
    if embeds is not None and cfg.embed_inputs and not cfg.is_encoder_decoder:
        x = embeds.to(torch_dtype(cfg.param_dtype))
    else:
        x = embed_tokens(_top(params, "embed", tp), tokens, cfg, tp)
    b, s = x.shape[0], x.shape[1]
    if mode == "decode":
        pos = decode_positions(pos, b, x.device)
        positions = pos[:, None]
        lengths = None
    else:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
        if lengths is not None:
            lengths = torch.as_tensor(lengths, dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    at = where(cfg) if any(s.ffn == "moe" for s in cfg.layer_specs()) else None
    block = (_remat_block if cfg.remat and mode == "train" and torch.is_grad_enabled()
             else block_forward)
    new_groups = []
    for gi, group in enumerate(cfg.groups()):
        layers = params["groups"][gi]["layers"]
        caches = []
        for li, spec in enumerate(group_layers(group)):
            lc = cache["groups"][gi]["layers"][li] if mode == "decode" else None
            x, nc, a = block(layers[li], x, spec, cfg, positions,
                             mode=mode, cache=lc, pos=pos,
                             enc_out=enc_out, lengths=lengths, tp=tp, at=at)
            caches.append(nc)
            aux = aux + a
        new_groups.append({"layers": caches})
    x = rms_norm(x, _top(params, "final_norm", tp), cfg.division, cfg.norm_eps)
    head = "embed" if cfg.tie_embeddings else "lm_head"
    logits = lm_logits({head: _top(params, head, tp)}, x, cfg, tp)
    new_cache = {"groups": new_groups} if mode in ("prefill", "decode") else None
    return logits, new_cache, aux


def make_cache(cfg: ModelConfig, batch: int, max_len: int, device=None,
               abstract: bool = False, fake_mode=None):
    """Zero decode cache in the parameters' grouped layout: ``max_len`` slots
    for full-attention layers, W-slot rings for sliding-window layers, the
    SSM state and conv windows for Mamba layers, and an encoder-decoder's
    ``encoder_seq``-long cross K/V. ``abstract``: the same tree as stand-ins
    that allocate nothing (``repro_torch.tree.abstract``; ``fake_mode``'s
    fake tensors on ``device``, or ``meta`` tensors). Under an active mesh
    with a ``model`` axis above 1, the rank's KV heads and Mamba-2 heads."""
    dt = torch_dtype(cfg.param_dtype)
    tp = tensor_parallel(cfg)
    if abstract:
        attn = lambda *a: abstract_cache_attn(*a, device=device, fake_mode=fake_mode, tp=tp)
        mamba = lambda *a: abstract_cache_mamba(*a, device=device, fake_mode=fake_mode, tp=tp)
        zeros = lambda shape: tree.abstract(shape, dt, device, fake_mode)
    else:
        attn = lambda *a: init_cache_attn(*a, device=device, tp=tp)
        mamba = lambda *a: init_cache_mamba(*a, device=device, tp=tp)
        zeros = lambda shape: torch.zeros(shape, dtype=dt, device=device)
    groups = []
    for g in cfg.groups():
        layers = []
        for spec in group_layers(g):
            if spec.mixer == "mamba":
                lc = {"mamba": mamba(cfg, batch, dt)}
            else:
                window = cfg.sliding_window if spec.mixer == "swa" else 0
                lc = {"attn": attn(cfg, batch, max_len, window, dt)}
            if cfg.is_encoder_decoder:
                kv = cfg.n_kv_heads if tp is None else tp.kv_local
                shape = (batch, cfg.encoder_seq, kv, cfg.head_dim)
                lc["cross"] = {"ck": zeros(shape), "cv": zeros(shape)}
            layers.append(lc)
        groups.append({"layers": layers})
    return {"groups": groups}
