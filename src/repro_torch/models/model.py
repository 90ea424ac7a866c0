"""Model assembly for dense decoder-only stacks.

The PyTorch counterpart of ``src/repro/models/model.py`` for the ``attn`` +
``dense`` block. The reference lowers each group of layers as one
``lax.scan`` over stacked parameters; here a Python loop runs a group's
``repeat * period`` layers in order (see :mod:`.params` for the layout).
Mamba, MoE, sliding-window and cross-attention blocks are not ported yet and
raise.

Modes: ``train`` (no cache), ``prefill`` (emit cache), ``decode`` (carry
cache; updated in place, see :mod:`.attention`).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from .attention import (decode_attention, decode_positions, full_attention,
                        init_cache_attn)
from .layers import embed_tokens, gated_mlp, lm_logits, rms_norm
from .params import torch_dtype

__all__ = ["block_forward", "forward", "make_cache", "group_layers"]

_NOT_PORTED = "ROADMAP Queue 1 item 10"


def group_layers(group) -> List[LayerSpec]:
    """The group's layers in order: its period, ``repeat`` times."""
    return [s for _ in range(group.repeat) for s in group.period]


def block_forward(bp: Dict, x, spec: LayerSpec, cfg: ModelConfig, positions,
                  *, mode: str, cache=None, pos=None):
    """One block; returns (x, new_cache)."""
    if spec.mixer != "attn":
        raise NotImplementedError(
            f"{spec.mixer} mixers are not ported yet ({_NOT_PORTED})")
    if spec.ffn != "dense":
        raise NotImplementedError(
            f"{spec.ffn} FFN blocks are not ported yet ({_NOT_PORTED})")
    if "cross" in bp:
        raise NotImplementedError(
            f"cross attention is not ported yet ({_NOT_PORTED})")
    div = cfg.division
    new_cache: Dict[str, Any] = {}
    h = rms_norm(x, bp["mixer_norm"], div, cfg.norm_eps)
    if mode == "decode":
        ah, new_cache["attn"] = decode_attention(bp["attn"], h, cache["attn"],
                                                 pos, cfg)
    else:
        ah, (k, v) = full_attention(bp["attn"], h, positions, cfg,
                                    return_kv=True)
        if mode == "prefill":
            dt = torch_dtype(cfg.param_dtype)
            new_cache["attn"] = {"k": k.to(dt), "v": v.to(dt)}
    x = x + ah
    h2 = rms_norm(x, bp["ffn_norm"], div, cfg.norm_eps)
    return x + gated_mlp(bp["ffn"], h2), new_cache


def forward(cfg: ModelConfig, params, *, tokens, cache=None, pos=None,
            mode: str = "train"):
    """Returns (logits (b, s, V) f32, new_cache, aux).

    ``pos`` (decode) is a scalar or a per-request (b,) vector. The
    reference's ``lengths`` (prefill) only reshapes sliding-window rings and
    SSM state, neither of which a dense model has, so it is not taken here.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    x = embed_tokens(params["embed"], tokens, cfg)
    b, s = tokens.shape
    if mode == "decode":
        pos = decode_positions(pos, b, x.device)
        positions = pos[:, None]
    else:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
    new_groups = []
    for gi, group in enumerate(cfg.groups()):
        layers = params["groups"][gi]["layers"]
        caches = []
        for li, spec in enumerate(group_layers(group)):
            lc = cache["groups"][gi]["layers"][li] if mode == "decode" else None
            x, nc = block_forward(layers[li], x, spec, cfg, positions,
                                  mode=mode, cache=lc, pos=pos)
            caches.append(nc)
        new_groups.append({"layers": caches})
    x = rms_norm(x, params["final_norm"], cfg.division, cfg.norm_eps)
    logits = lm_logits(params, x, cfg)
    new_cache = {"groups": new_groups} if mode in ("prefill", "decode") else None
    return logits, new_cache, torch.zeros((), dtype=torch.float32)


def make_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Zero decode cache in the parameters' grouped layout."""
    dt = torch_dtype(cfg.param_dtype)
    groups = []
    for g in cfg.groups():
        layers = []
        for spec in group_layers(g):
            if spec.mixer != "attn":
                raise NotImplementedError(
                    f"{spec.mixer} caches are not ported yet ({_NOT_PORTED})")
            layers.append({"attn": init_cache_attn(cfg, batch, max_len, dt,
                                                   device)})
        groups.append({"layers": layers})
    return {"groups": groups}
