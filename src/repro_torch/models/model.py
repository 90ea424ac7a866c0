"""Model assembly for decoder-only stacks: attention or sliding-window
mixers, dense or MoE FFNs.

The PyTorch counterpart of ``src/repro/models/model.py`` for the ``attn`` and
``swa`` mixers and the ``dense`` and ``moe`` FFNs. The reference lowers each
group of layers as one ``lax.scan`` over stacked parameters; here a Python
loop runs a group's ``repeat * period`` layers in order (see :mod:`.params`
for the layout). SSM (mamba) mixers, cross attention and embedding inputs
are not ported yet and raise.

Modes: ``train`` (no cache), ``prefill`` (emit cache), ``decode`` (carry
cache; updated in place, see :mod:`.attention`). Sliding-window layers keep
a W-slot ring cache: slot = position % W.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from .attention import (decode_attention, decode_positions, full_attention,
                        init_cache_attn, sliding_attention)
from .layers import embed_tokens, gated_mlp, lm_logits, rms_norm
from .moe import moe_ffn
from .params import torch_dtype

__all__ = ["block_forward", "forward", "make_cache", "group_layers"]

_NOT_PORTED = "ROADMAP Queue 1 item 10"


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
                  *, mode: str, cache=None, pos=None, lengths=None):
    """One block; returns (x, new_cache, aux). ``lengths`` (prefill only):
    the real prompt lengths of a right-padded batch, which keep pad tokens
    out of sliding-window rings."""
    if spec.mixer not in ("attn", "swa"):
        raise NotImplementedError(
            f"{spec.mixer} mixers (SSM) are not ported yet ({_NOT_PORTED})")
    if spec.ffn not in ("dense", "moe"):
        raise NotImplementedError(
            f"{spec.ffn} FFN blocks (SSM) are not ported yet ({_NOT_PORTED})")
    if "cross" in bp:
        raise NotImplementedError(
            f"cross attention (encoder-decoder) is not ported yet ({_NOT_PORTED})")
    div = cfg.division
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: Dict[str, Any] = {}
    window = cfg.sliding_window if spec.mixer == "swa" else 0
    h = rms_norm(x, bp["mixer_norm"], div, cfg.norm_eps)
    if mode == "decode":
        ah, new_cache["attn"] = decode_attention(bp["attn"], h, cache["attn"],
                                                 pos, cfg, window=window)
    else:
        fn = sliding_attention if window else full_attention
        ah, (k, v) = fn(bp["attn"], h, positions, cfg, return_kv=True)
        if mode == "prefill":
            if window:
                k = _ring_from_prefill(k, window, lengths)
                v = _ring_from_prefill(v, window, lengths)
            dt = torch_dtype(cfg.param_dtype)
            new_cache["attn"] = {"k": k.to(dt), "v": v.to(dt)}
    x = x + ah
    h2 = rms_norm(x, bp["ffn_norm"], div, cfg.norm_eps)
    if spec.ffn == "moe":
        ff, a = moe_ffn(bp["ffn"], h2, cfg)
        aux = aux + a
    else:
        ff = gated_mlp(bp["ffn"], h2)
    return x + ff, new_cache, aux


def forward(cfg: ModelConfig, params, *, tokens, cache=None, pos=None,
            mode: str = "train", lengths=None):
    """Returns (logits (b, s, V) f32, new_cache, aux f32 scalar).

    ``pos`` (decode) is a scalar or a per-request (b,) vector. ``lengths``
    (prefill) marks per-request real prompt lengths of a right-padded batch:
    pad positions are kept out of sliding-window rings.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    x = embed_tokens(params["embed"], tokens, cfg)
    b, s = tokens.shape
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
    new_groups = []
    for gi, group in enumerate(cfg.groups()):
        layers = params["groups"][gi]["layers"]
        caches = []
        for li, spec in enumerate(group_layers(group)):
            lc = cache["groups"][gi]["layers"][li] if mode == "decode" else None
            x, nc, a = block_forward(layers[li], x, spec, cfg, positions,
                                     mode=mode, cache=lc, pos=pos,
                                     lengths=lengths)
            caches.append(nc)
            aux = aux + a
        new_groups.append({"layers": caches})
    x = rms_norm(x, params["final_norm"], cfg.division, cfg.norm_eps)
    logits = lm_logits(params, x, cfg)
    new_cache = {"groups": new_groups} if mode in ("prefill", "decode") else None
    return logits, new_cache, aux


def make_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Zero decode cache in the parameters' grouped layout: ``max_len`` slots
    for full-attention layers, W-slot rings for sliding-window layers."""
    dt = torch_dtype(cfg.param_dtype)
    groups = []
    for g in cfg.groups():
        layers = []
        for spec in group_layers(g):
            if spec.mixer not in ("attn", "swa"):
                raise NotImplementedError(
                    f"{spec.mixer} caches (SSM) are not ported yet ({_NOT_PORTED})")
            window = cfg.sliding_window if spec.mixer == "swa" else 0
            layers.append({"attn": init_cache_attn(cfg, batch, max_len, window,
                                                   dt, device)})
        groups.append({"layers": layers})
    return {"groups": groups}
