"""Model FLOPs of served requests, from the configuration's widths.

What a request needs, not what the program happens to compute: every
matrix product at 2 FLOPs a multiply-add for each token the model reads
(the prompt's tokens at prefill, every fed-back token at decode), the
routed experts at ``experts_per_tok`` of ``n_experts`` and the shared ones
whole; attention's score and value products over the keys each token
sees (causal: position i sees i + 1); the Mamba-2 SSD scan as its chunked
algorithm computes it (arXiv:2405.21060, listing 1: the chunk's C B^T and
masked product by ``ssm_chunk`` keys, the chunk states and the carried
state's output) at prefill, and the state's update and read at decode;
the LM head once for each token served, the only logits a user gets.
The embedding's gather is no FLOP.
"""
from __future__ import annotations

from typing import Dict


def _mlp(d: int, f: int) -> int:
    return 3 * d * f                                  # wi, wg, wo


def layer_macs(s: Dict) -> Dict[str, int]:
    """Multiply-adds a token of each layer kind's matrix products."""
    d = s["d_model"]
    out = {}
    if s.get("n_heads"):
        out["attn"] = d * s["head_dim"] * (2 * s["n_heads"] + 2 * s["n_kv_heads"])
    if s.get("d_ff_dense") or s.get("d_ff"):
        out["dense"] = _mlp(d, s.get("d_ff_dense") or s["d_ff"])
    if s.get("n_experts"):
        out["moe"] = (d * s["n_experts"]
                      + s["experts_per_tok"] * _mlp(d, s["d_ff_expert"])
                      + _mlp(d, s["n_shared_experts"] * s["d_ff_expert"]))
    if s.get("d_inner"):
        din, n, h = s["d_inner"], s["ssm_state"], s["ssm_heads"]
        out["mamba"] = d * (2 * din + 2 * n + h) + din * d + s["conv_width"] * (din + 2 * n)
    return out


def kinds(s: Dict):
    """Each layer's (mixer, ffn): the deepseek-style leading dense layers,
    then MoE; attention-free models run Mamba-2 mixers with no FFN."""
    if s.get("d_inner"):
        return [("mamba", None)] * s["n_layers"]
    lead = s.get("first_dense", 0)
    ffn = "moe" if s.get("n_experts") else "dense"
    return [("attn", "dense" if i < lead else ffn) for i in range(s["n_layers"])]


def active_macs(s: Dict) -> int:
    """Multiply-adds a token of every layer's matrix products, without the
    LM head and the positional terms."""
    m = layer_macs(s)
    return sum(m[mix] + (m[ffn] if ffn else 0) for mix, ffn in kinds(s))


def _attn_keys(n_prompt: int, n_fed: int) -> int:
    """Keys seen, summed over the tokens read: positions 0 .. n-1 see 1 .. n."""
    n = n_prompt + n_fed
    return n * (n + 1) // 2


def request_flops(s: Dict, n_prompt: int, n_new: int) -> float:
    """FLOPs of one request: a prompt of ``n_prompt`` tokens, ``n_new``
    tokens served (the last one is never fed back)."""
    fed = max(0, n_new - 1)
    tokens = n_prompt + fed
    flops = 2.0 * active_macs(s) * tokens + 2.0 * s["d_model"] * s["vocab"] * n_new
    ks = kinds(s)
    n_attn = sum(1 for mix, _ in ks if mix == "attn")
    if n_attn:
        flops += n_attn * 4.0 * s["n_heads"] * s["head_dim"] * _attn_keys(n_prompt, fed)
    n_mamba = sum(1 for mix, _ in ks if mix == "mamba")
    if n_mamba:
        q, n = s["ssm_chunk"], s["ssm_state"]
        hp = s["ssm_heads"] * s["ssm_head_dim"]
        prefill = 2.0 * q * n + 2.0 * q * hp + 4.0 * hp * n     # a prompt token
        decode = 4.0 * hp * n                                    # a fed-back token
        flops += n_mamba * (prefill * n_prompt + decode * fed)
    return flops
