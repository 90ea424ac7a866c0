"""Shared layer primitives. Every normalisation goes through division_modes.

The PyTorch counterpart of ``src/repro/models/layers.py``, with its layouts.
The reference contracts bf16 operands "with f32 accumulation"
(``preferred_element_type=jnp.float32``) where the result is wanted in f32;
here that is a matmul of the operands cast to f32 (bf16 products are exact
in f32, so it is the same function up to the order of the sum). Its other
contractions keep the operands' dtype, as ``torch.einsum`` does.

With ``tp`` (a ``models.parallel.TensorParallel``) the MLP runs on the
rank's ``mlp`` columns and the embedding and LM head on its ``vocab``
block, where their specs split them (``models/parallel.py``); under a
sequence split (``tp.seq``) the caller gathers their input and scatters
their output.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import division_modes as dm

__all__ = ["rms_norm", "rope", "gated_mlp", "embed_tokens", "lm_logits"]


def rms_norm(x, w, div: dm.DivisionConfig, eps: float = 1e-6):
    """RMSNorm through the division unit's consumer dispatch: the kernel
    modes run the fused kernel, every other mode the twin."""
    return dm.rmsnorm(x, w, div, eps=eps)


def rope(x, positions, theta: float):
    """Rotary embeddings. x: (B, S, H, hd); positions: (B, S) int."""
    half = x.shape[-1] // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=x.device), exps)
    angles = positions[..., None].to(torch.float32) * freqs      # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xf1, xf2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def gated_mlp(p, x, tp=None):
    """SwiGLU MLP: wo(silu(wg x) * (wi x)). Split over ``mlp``: ``wi`` and
    ``wg`` by columns, ``wo`` by rows, its partial sums added over the
    ranks in the product's dtype."""
    split = tp is not None and tp.mlp
    if split:
        x = tp.into(x)
    h = x @ p["wi"]
    g = F.silu((x @ p["wg"]).to(torch.float32))
    out = (g.to(h.dtype) * h) @ p["wo"]
    return tp.out(out) if split else out


def embed_tokens(embed, tokens, cfg: ModelConfig, tp=None):
    """Rows of the table. Split over ``vocab``: the rank's rows, zero for
    a token outside its block, summed over the ranks (exactly: one term
    is not zero)."""
    if tp is None or not tp.vocab:
        return embed[tokens]
    n = embed.shape[0]
    local = tokens - tp.vocab_offset(n)
    mine = (local >= 0) & (local < n)
    rows = embed[torch.where(mine, local, 0)]
    return tp.out(torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                  device=rows.device)))


def lm_logits(params, x, cfg: ModelConfig, tp=None):
    """f32 logits; split over ``vocab``, the rank's block of them."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if tp is not None and tp.vocab:
        x = tp.into(x)
    return x.to(torch.float32) @ head.to(torch.float32)
