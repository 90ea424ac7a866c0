"""Pieces the plain references share: float32 leaves (or their float8
rounding, the control's precision), RMSNorm, rotary embeddings, causal
attention and the SwiGLU MLP, as their papers state them."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0          # the largest float8_e4m3fn


def setup() -> None:
    """Float32 matrix products in float32, never TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def leaf(t: torch.Tensor, quant: str = None) -> torch.Tensor:
    """A weight in float32. With ``quant="fp8"`` a 16-bit leaf is first
    rounded to float8 e4m3 under one scale a tensor (its largest magnitude
    at 448), as a deployment that serves float8 weights would hold it;
    float32 leaves (the router, norms, the SSM's per-head terms) stay."""
    if quant is None or t.dtype == torch.float32:
        return t.to(torch.float32)
    if quant != "fp8":
        raise ValueError(f"unknown precision {quant!r}")
    tf = t.to(torch.float32)
    scale = tf.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (tf / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x, theta: float):
    """Rotary embedding of (T, H, hd) at positions 0 .. T-1, the two halves
    of each head rotated as one complex number (the GPT-NeoX layout)."""
    T, half = x.shape[0], x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def causal_attention(x, p, s, quant=None):
    """Multi-head causal self-attention of (T, d) with weights ``wq`` (d, H,
    hd), ``wk``/``wv`` (d, KV, hd), ``wo`` (H, hd, d); exact softmax."""
    T, d = x.shape
    H, KV, hd = s["n_heads"], s["n_kv_heads"], s["head_dim"]
    q = (x @ leaf(p["wq"], quant).reshape(d, H * hd)).view(T, H, hd)
    k = (x @ leaf(p["wk"], quant).reshape(d, KV * hd)).view(T, KV, hd)
    v = (x @ leaf(p["wv"], quant).reshape(d, KV * hd)).view(T, KV, hd)
    q, k = rope(q, s["rope_theta"]), rope(k, s["rope_theta"])
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=1)
        v = v.repeat_interleave(H // KV, dim=1)
    out = torch.empty_like(q)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    for h in range(H):               # one head's (T, T) scores at a time
        sc = (q[:, h] @ k[:, h].T) / math.sqrt(hd)
        sc = sc.masked_fill(~causal, float("-inf"))
        out[:, h] = torch.softmax(sc, dim=-1) @ v[:, h]
    return out.reshape(T, H * hd) @ leaf(p["wo"], quant).reshape(H * hd, d)


def swiglu(x, wi, wg, wo):
    return (F.silu(x @ wg) * (x @ wi)) @ wo


def mlp(x, p, quant=None):
    return swiglu(x, leaf(p["wi"], quant), leaf(p["wg"], quant), leaf(p["wo"], quant))


def layers(w):
    """The blocks in order, across the tree's groups."""
    return [lp for g in w["groups"] for lp in g["layers"]]
