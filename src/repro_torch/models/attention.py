"""Full causal attention (GQA) for training/prefill and one-token decode.

The PyTorch counterpart of the full-attention parts of
``src/repro/models/attention.py``, with its layouts: ``wq`` is ``(d, H,
hd)``, ``wo`` is ``(H, hd, d)``, activations ``(b, s, h, hd)``. Softmax
denominators go through the division unit (``division_modes.softmax`` on
the materialised f32 scores). The reference's sharding annotations are
dropped (one card). Sliding-window attention waits for its model slice.

The decode KV cache is updated in place (``index_put_``), where the JAX
reference builds a new cache array: the cache passed to
:func:`decode_attention` is the cache it returns.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import division_modes as dm
from repro_torch.kernels.flash_attention import NEG_INF
from .layers import rope

__all__ = ["NEG_INF", "rope_apply", "full_attention", "init_cache_attn",
           "decode_positions", "decode_attention"]


def _proj(x, w):
    """(b, s, d) @ (d, h, hd) -> (b, s, h, hd)."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])


def _out_proj(out, wo):
    """(b, s, h, hd) @ (h, hd, d) -> (b, s, d)."""
    return out.reshape(*out.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1])


def _repeat_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(
        b, s, kv * n_rep, hd)


def _sdpa(q, k, v, mask, div: dm.DivisionConfig, scale: float):
    """q: (b,qs,h,hd), k/v: (b,ks,h,hd), mask: broadcastable to (b,h,qs,ks)."""
    scores = torch.einsum("bqhk,bthk->bhqt", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    scores = torch.where(mask, scores, NEG_INF)
    probs = dm.softmax(scores, axis=-1, cfg=div)
    return torch.einsum("bhqt,bthk->bqhk", probs.to(v.dtype), v)


def rope_apply(x, positions, cfg: ModelConfig):
    return rope(x, positions, cfg.rope_theta)


def full_attention(p, x, positions, cfg: ModelConfig, *, return_kv: bool = False):
    """Training/prefill causal attention, query-chunked above cfg.attn_chunk.

    With ``return_kv`` it also returns the post-rope ``(k, v)`` before the
    GQA repeat, which prefill stores in the cache (the reference recomputes
    them and lets XLA merge the two).
    """
    b, s, _ = x.shape
    scale = 1.0 / math.sqrt(cfg.head_dim)
    q = rope_apply(_proj(x, p["wq"]), positions, cfg)
    k = rope_apply(_proj(x, p["wk"]), positions, cfg)
    v = _proj(x, p["wv"])
    kr, vr = _repeat_kv(k, cfg.q_per_kv), _repeat_kv(v, cfg.q_per_kv)

    def attend(qc, qpos):
        mask = qpos[:, None, :, None] >= positions[:, None, None, :]
        return _sdpa(qc, kr, vr, mask, cfg.division, scale)

    chunk = cfg.attn_chunk
    if s <= chunk or s % chunk != 0:
        out = attend(q, positions)
    else:
        out = torch.cat([attend(q[:, i:i + chunk], positions[:, i:i + chunk])
                         for i in range(0, s, chunk)], dim=1)
    out = _out_proj(out, p["wo"])
    return (out, (k, v)) if return_kv else out


def init_cache_attn(cfg: ModelConfig, batch: int, max_len: int,
                    dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_positions(pos, batch: int, device=None) -> torch.Tensor:
    """Decode ``pos`` as a (batch,) int32 vector: a scalar (every request at
    one position) or a per-request (batch,) vector."""
    pos_v = torch.as_tensor(pos, dtype=torch.int32, device=device).reshape(-1)
    if pos_v.shape[0] == 1:
        pos_v = pos_v.expand(batch)
    return pos_v


def decode_attention(p, x, cache, pos, cfg: ModelConfig):
    """One-token decode. x: (b, 1, d); cache k/v: (b, L, kv, hd); pos: a
    scalar or a per-request (b,) vector of absolute positions.

    Request i writes its k/v at slot pos_i (in place) and attends to slots
    0..pos_i, so pad slots of a padded batch above pos_i are never seen.
    Returns (out, cache).
    """
    b = x.shape[0]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    pos_v = decode_positions(pos, b, x.device)
    posv = pos_v[:, None]
    q = rope_apply(_proj(x, p["wq"]), posv, cfg)
    k_new = rope_apply(_proj(x, p["wk"]), posv, cfg)
    v_new = _proj(x, p["wv"])
    bidx = torch.arange(b, device=x.device)
    slot = pos_v.long()
    cache["k"][bidx, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, slot] = v_new[:, 0].to(cache["v"].dtype)
    k_all = _repeat_kv(cache["k"], cfg.q_per_kv)
    v_all = _repeat_kv(cache["v"], cfg.q_per_kv)
    idx = torch.arange(cache["k"].shape[1], device=x.device)
    mask = (idx[None, :] <= pos_v[:, None])[:, None, None, :]
    out = _sdpa(q, k_all, v_all, mask, cfg.division, scale)
    return _out_proj(out, p["wo"]), cache
