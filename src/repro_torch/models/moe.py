"""Mixture-of-Experts FFN: top-k routing with capacity-based dense dispatch.

The PyTorch counterpart of ``src/repro/models/moe.py``. Routing divisions go
through the paper's unit: the router softmax (f32 logits) and the top-k
renormalisation are both ``division_modes`` call sites, so a kernel mode
runs the softmax kernel on ``(T, E)`` rows and the reciprocal kernel on the
``(T, 1)`` top-k sums.

Dispatch is the capacity-C scheme (Switch/GShard): tokens take positions in
per-expert buffers of capacity C = max(ceil(T*k/E * cf), min(T*k, 8)),
first come first served in token order; tokens over capacity drop to the
residual path. ``moe_dispatch`` picks how the positions are found:
``cumsum`` (a one-hot running count) or ``sort`` (a stable sort by expert,
the rank within the expert's run); both give the same positions. ``local``
is the reference's shard-local dispatch: capacity floors at min(T*k, 4)
and counts per batch shard. Under an active mesh each rank is one shard of
the reference's D = pod x data shards (``_local_shard_count``): it
dispatches its own Tl = T/D tokens at the per-shard capacity
max(ceil(Tl*k/E * cf), min(Tl*k, 4)), and the expert counts and
router-probability sums behind the aux loss are all-reduced over the batch
axes, so the aux loss is the global batch's, as GSPMD makes the
reference's. Without a mesh, D = 1.

Capacity depends on the whole batch, so in a padded prefill the pad tokens
take capacity as they do in the reference. Load-balance aux loss (Switch
eq. 4): aux = E * sum_e f_e * P_e, times ``router_aux_weight``.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import division_modes as dm
from .layers import gated_mlp

__all__ = ["top_k", "moe_ffn", "capacity"]

DISPATCHES = ("cumsum", "sort", "local")


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of the last axis, largest first, the lower index first
    among equal values (as ``jax.lax.top_k``; ``torch.topk`` promises no
    order for ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg: ModelConfig, T: int) -> int:
    """Slots per expert for T tokens: the cf bound, floored so that small
    token counts (decode steps) drop nothing."""
    k, E = cfg.experts_per_tok, cfg.n_experts
    if cfg.moe_dispatch == "local":
        return max(math.ceil(T * k / E * cfg.capacity_factor), min(T * k, 4))
    return max(math.ceil(T * k / E * cfg.capacity_factor), min(T * k, 8))


def _positions(flat_e: torch.Tensor, E: int, dispatch: str) -> torch.Tensor:
    """Each (token, choice)'s 0-based position in its expert's buffer, in
    token order."""
    n = flat_e.shape[0]
    if dispatch == "cumsum":
        onehot = F.one_hot(flat_e, E)                              # (T*k, E)
        return (torch.cumsum(onehot, 0) * onehot).sum(-1) - 1
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, torch.arange(E, device=flat_e.device))
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(n, device=flat_e.device) - first[sorted_e]
    return pos


def _experts(p: Dict, buf: torch.Tensor) -> torch.Tensor:
    """The gated expert MLP over (E, C, d) buffers: silu in f32, then the
    cast, as the reference."""
    h = torch.bmm(buf, p["wi"])
    g = F.silu(torch.bmm(buf, p["wg"]).to(torch.float32))
    return torch.bmm(g.to(h.dtype) * h, p["wo"])


def _local_shard_count():
    """(mesh, batch axes, D) of ``moe_dispatch='local'`` under the active
    mesh; (None, (), 1) without one."""
    from repro_torch.sharding import rules as shr

    mesh = shr.active_mesh()
    if mesh is None:
        return None, (), 1
    axes = shr.batch_axes(mesh)
    return mesh, axes, shr.axes_size(mesh, axes)


def _dispatch(p: Dict, xt: torch.Tensor, gates: torch.Tensor, idx: torch.Tensor,
              cfg: ModelConfig):
    """The routed experts' output (T, d) for these T tokens and each
    expert's count of kept (token, choice) pairs (E,) f32."""
    T, d = xt.shape
    E, k = cfg.n_experts, cfg.experts_per_tok
    C = capacity(cfg, T)
    flat_e = idx.reshape(T * k)
    flat_g = gates.reshape(T * k)
    pos = _positions(flat_e, E, "cumsum" if cfg.moe_dispatch == "cumsum" else "sort")
    keep = (pos >= 0) & (pos < C)
    pos = pos.clamp(0, C - 1)

    # Dispatch: each kept (token, choice) owns one (expert, slot) row of the
    # (E*C, d) buffer, so writing the kept rows gives the reference's
    # scatter-add of zeros for the rest. The dropped ones all write a spare
    # row past the buffer's end, which no expert reads: no shape depends on
    # the routing (no mask selection, which would sync the host and which a
    # fake tensor cannot size).
    src = torch.arange(T * k, device=xt.device) // k
    rows = torch.where(keep, flat_e * C + pos, E * C)
    buf = torch.zeros((E * C + 1, d), dtype=xt.dtype, device=xt.device)
    buf[rows] = xt[src]
    eo = _experts(p, buf[:E * C].view(E, C, d))

    tok_out = eo[flat_e, pos]                                          # (T*k, d)
    tok_out = tok_out * (flat_g * keep).to(tok_out.dtype)[:, None]
    out = tok_out.reshape(T, k, d).sum(dim=1)
    counts = torch.zeros((E,), dtype=torch.float32, device=xt.device).index_add_(
        0, flat_e, keep.to(torch.float32))
    return out, counts


def moe_ffn(p: Dict, x: torch.Tensor, cfg: ModelConfig):
    """x: (b, s, d) -> (out (b, s, d), aux loss f32 scalar)."""
    if cfg.moe_dispatch not in DISPATCHES:
        raise ValueError(f"moe_dispatch {cfg.moe_dispatch!r} not in {DISPATCHES}")
    b, s, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_tok
    T = b * s
    xt = x.reshape(T, d)

    logits = xt.to(torch.float32) @ p["router"].to(torch.float32)      # (T, E)
    probs = dm.softmax(logits, axis=-1, cfg=cfg.division)
    gate_vals, idx = top_k(probs, k)                                   # (T, k)
    denom = torch.sum(gate_vals, dim=-1, keepdim=True)
    gates = gate_vals * dm.recip(denom, cfg.division)                  # (T, k)

    out, counts = _dispatch(p, xt, gates, idx, cfg)
    if cfg.n_shared_experts:
        out = out + gated_mlp(p["shared"], xt)

    mesh, axes, D = _local_shard_count() if cfg.moe_dispatch == "local" else (None, (), 1)
    if D > 1:
        from repro_torch.sharding import comm

        # The global batch's aux: counts and probability sums over every
        # shard (the sum carries its gradient back to each shard's router).
        counts = comm.all_reduce(counts, mesh, axes)
        P_e = comm.all_reduce_sum_grad(torch.sum(probs, dim=0), mesh, axes) / (T * D)
    else:
        P_e = torch.mean(probs, dim=0)
    f_e = counts / (T * D * k) * E
    aux = E * torch.sum(f_e * P_e) * cfg.router_aux_weight
    return out.reshape(b, s, d), aux
