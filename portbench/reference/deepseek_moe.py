"""Plain reference of a DeepSeekMoE decoder (arXiv:2401.06066) as the
configuration runs it: pre-norm blocks of causal multi-head attention
with rotary embeddings, SwiGLU feed-forward (the leading ``first_dense``
layers dense, the rest a mixture of ``n_experts`` routed experts of which
``experts_per_tok`` serve a token, plus ``n_shared_experts`` shared ones
as one wide expert), a final RMSNorm and an untied LM head.

Routing: softmax over the router's float32 logits, the top ``k`` in order
of probability (the lower expert first among equals), their gates divided
by their sum. The capacity rule (Switch / GShard) holds for a prompt: of
its T tokens, each expert takes at most C = max(ceil(T k / E * cf),
min(T k, 8)) (token, choice) pairs, first come first served in token
order, choices in order of probability; a pair past C adds nothing. A
token served after the prompt is routed alone, where C >= k drops nothing.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import causal_attention, layers, leaf, mlp, rms_norm, swiglu


def capacity(s, T: int) -> int:
    k, E = s["experts_per_tok"], s["n_experts"]
    return max(math.ceil(T * k / E * s["capacity_factor"]), min(T * k, 8))


def moe(x, p, s, n_prompt: int, quant=None):
    T, _ = x.shape
    E, k = s["n_experts"], s["experts_per_tok"]
    probs = torch.softmax(x @ p["router"].to(torch.float32), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    gates = vals / vals.sum(-1, keepdim=True)
    keep = torch.ones(T, k, dtype=torch.bool, device=x.device)
    if n_prompt:
        flat = idx[:n_prompt].reshape(-1)
        onehot = F.one_hot(flat, E)
        pos = (torch.cumsum(onehot, 0) * onehot).sum(-1) - 1
        keep[:n_prompt] = (pos < capacity(s, n_prompt)).view(n_prompt, k)
    out = torch.zeros_like(x)
    for e in range(E):
        hit = (idx == e) & keep
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        g = (gates * hit)[rows].sum(-1, keepdim=True)
        y = swiglu(x[rows], leaf(p["wi"][e], quant), leaf(p["wg"][e], quant),
                   leaf(p["wo"][e], quant))
        out.index_add_(0, rows, g * y)
    if s.get("n_shared_experts"):
        out = out + mlp(x, p["shared"], quant)
    return out


def served_logits(w, s, tokens, n_prompt: int, quant=None):
    """Float32 logits (len(tokens) - n_prompt + 1, V) at positions
    n_prompt - 1 .. len(tokens) - 1: those that chose each served token,
    the prompt being ``tokens[:n_prompt]``."""
    dev = w["embed"].device
    ids = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    x = leaf(w["embed"], quant)[ids] if quant else w["embed"][ids].to(torch.float32)
    eps = s["norm_eps"]
    for i, lp in enumerate(layers(w)):
        x = x + causal_attention(rms_norm(x, lp["mixer_norm"].float(), eps), lp["attn"], s, quant)
        h = rms_norm(x, lp["ffn_norm"].float(), eps)
        if i < s.get("first_dense", 0) or not s.get("n_experts"):
            x = x + mlp(h, lp["ffn"], quant)
        else:
            x = x + moe(h, lp["ffn"], s, n_prompt, quant)
    x = rms_norm(x[n_prompt - 1:], w["final_norm"].float(), eps)
    return x @ leaf(w["lm_head"], quant)
