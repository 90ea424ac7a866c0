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
is the reference's shard-local dispatch: the global batch is cut into the
reference's D = pod x data row blocks (when D divides its T), each with
its own positions and capacity max(ceil(Tl*k/E * cf), min(Tl*k, 4)).

Under an active mesh the semantics stay the reference's on the global
batch. Where the rows a rank is given are its block of the batch
(``sharding.rules.split_tokens``: the train step), T is the global token
count: each rank counts its (token, choice) pairs per expert, an all-gather
of the counts gives it the pairs of the ranks before it (batch-major, pod
first), and its positions start there. The aux loss is the global batch's:
the kept counts and the probability sums are summed over the batch axes.

The experts lie where their specs put them (``models/parallel.py``
``ExpertParallel``). Split over an axis that also splits the tokens
(``experts`` on ``data`` in training), a rank fills an (E, C, d) buffer with
its own kept rows (a global position owns one row, so the ranks' rows never
collide), an all-to-all hands each expert's owner its block, which sums
the pieces it receives, runs the experts, and an all-gather brings the
outputs back (``comm.exchange``, ``comm.gather_blocks``; under ``local`` the
shards' buffers are exchanged side by side and come back by the reverse
all-to-all). Split over an axis on which the tokens are whole (serving
under ``experts -> data``, ``ep_model``, any ``model`` split), a rank runs
only its own experts' rows and the partial outputs are summed over that
axis. ``expert_mlp`` splits ``wi``/``wg`` by columns and ``wo`` by rows,
and its partial sums join the same sum (``comm.reduce_from_split``, with
``copy_to_split`` on the dispatched rows and the gates).

Capacity depends on the whole batch, so in a padded prefill the pad tokens
take capacity as they do in the reference. Load-balance aux loss (Switch
eq. 4): aux = E * sum_e f_e * P_e, times ``router_aux_weight``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import division_modes as dm
from .layers import gated_mlp

__all__ = ["top_k", "moe_ffn", "capacity", "where", "route", "Route"]

DISPATCHES = ("cumsum", "sort", "local")


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of the last axis, largest first, the lower index first
    among equal values (as ``jax.lax.top_k``; ``torch.topk`` promises no
    order for ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg: ModelConfig, T: int) -> int:
    """Slots per expert for T tokens (of one shard under ``local``): the cf
    bound, floored so that small token counts (decode steps) drop nothing."""
    k, E = cfg.experts_per_tok, cfg.n_experts
    if cfg.moe_dispatch == "local":
        return max(math.ceil(T * k / E * cfg.capacity_factor), min(T * k, 4))
    return max(math.ceil(T * k / E * cfg.capacity_factor), min(T * k, 8))


def _positions(flat_e: torch.Tensor, E: int, dispatch: str) -> torch.Tensor:
    """Each (token, choice)'s 0-based position in its expert's buffer, in
    token order, within each row of ``flat_e`` (R, n)."""
    R, n = flat_e.shape
    if dispatch == "cumsum":
        onehot = F.one_hot(flat_e, E)                              # (R, n, E)
        return (torch.cumsum(onehot, 1) * onehot).sum(-1) - 1
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, order)
    experts = torch.arange(E, device=flat_e.device).expand(R, E).contiguous()
    first = torch.searchsorted(sorted_e, experts)
    ranks = torch.arange(n, device=flat_e.device) - torch.gather(first, -1, sorted_e)
    return torch.empty_like(flat_e).scatter_(-1, order, ranks)


def _experts(p: Dict, buf: torch.Tensor) -> torch.Tensor:
    """The gated expert MLP over (E, C, d) buffers: silu in f32, then the
    cast, as the reference."""
    h = torch.bmm(buf, p["wi"])
    g = F.silu(torch.bmm(buf, p["wg"]).to(torch.float32))
    return torch.bmm(g.to(h.dtype) * h, p["wo"])


@dataclass(frozen=True)
class Route:
    """Where one call's rows and experts lie. ``tok``: the batch axes the
    rows are split over (this rank ``tok_index`` of ``n_tok``); ``shards``:
    the reference's capacity shards in this rank's rows (``local``), or 1
    where one shard holds the global batch and spans all ranks of ``tok``
    (``span``); ``t_shard``: the tokens of a shard, which set C; ``ep``:
    the experts' axes (None: whole on every rank)."""

    mesh: Any
    tok: Tuple[str, ...]
    n_tok: int
    tok_index: int
    shards: int
    t_shard: int
    ep: Optional[Any]
    span: bool = False

    @property
    def exchange(self) -> bool:
        """The experts are split over an axis that splits the rows too."""
        return self.ep is not None and self.ep.experts in self.tok

    @property
    def partial(self) -> Tuple[str, ...]:
        """The axes over which this rank's routed output is a partial sum,
        in mesh order."""
        from repro_torch.sharding import rules as shr

        if self.ep is None:
            return ()
        axes = {self.ep.mlp} | ({self.ep.experts} if not self.exchange else set())
        return tuple(ax for ax in shr.mesh_shape(self.mesh) if ax in axes)


def where(cfg: ModelConfig):
    """What a call routes by, read from the active mesh where the model runs:
    (mesh, the batch axes its rows are split over, the experts' axes), or
    None without a mesh. ``models.forward`` reads it once and hands it to
    each layer: remat's recompute runs in the backward pass, which autograd
    may run on another thread, where no mesh is active."""
    from repro_torch.sharding import rules as shr
    from .parallel import tensor_parallel

    mesh = shr.active_mesh()
    if mesh is None:
        return None
    tp = tensor_parallel(cfg, mesh)
    return mesh, shr.token_axes(), None if tp is None else tp.moe


def route(cfg: ModelConfig, T: int, at=None) -> Route:
    """The layout of a call on T of this rank's tokens, placed as ``at``
    (:func:`where`'s; read here when None)."""
    from repro_torch.sharding import rules as shr

    at = where(cfg) if at is None else at
    if at is None:
        return Route(None, (), 1, 0, 1, T, None)
    mesh, tok, ep = at
    sizes = shr.mesh_shape(mesh)
    n_tok, index = 1, 0
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())) if tok else {}
    for ax in tok:
        n_tok, index = n_tok * sizes[ax], index * sizes[ax] + coord[ax]
    T_glob = T * n_tok
    shards, t_shard = 1, T_glob
    D = shr.axes_size(mesh, shr.batch_axes(mesh))
    if cfg.moe_dispatch == "local" and D > 1 and T_glob % D == 0:
        # The reference's D row blocks of the global batch: this rank holds
        # D / n_tok of them (its rows are split over a prefix of the batch
        # axes, whose size divides D).
        shards, t_shard = D // n_tok, T_glob // D
    return Route(mesh, tok, n_tok, index, shards, t_shard, ep, span=t_shard > T)


def _assign(flat_e: torch.Tensor, cfg: ModelConfig, r: Route):
    """(positions, kept) of this rank's (token, choice) pairs ``flat_e``
    (T*k,): each pair's slot in its expert's buffer of its shard, clamped to
    the capacity, and whether it is within it."""
    from repro_torch.sharding import comm

    E, C = cfg.n_experts, capacity(cfg, r.t_shard)
    pos = _positions(flat_e.reshape(r.shards, -1), E,
                     "cumsum" if cfg.moe_dispatch == "cumsum" else "sort").reshape(-1)
    if r.span:
        # One shard over the ranks of ``tok``: this rank's positions start
        # after the pairs of the ranks before it (all-gather of the counts).
        load = torch.zeros((1, E), dtype=torch.int64, device=flat_e.device).index_add_(
            1, flat_e, torch.ones_like(flat_e)[None])
        before = comm.all_gather(load, r.mesh, r.tok)[:r.tok_index].sum(0)
        pos = pos + before.to(pos.device)[flat_e]
    return pos.clamp(max=C - 1), pos < C


def _dispatch(p: Dict, xt: torch.Tensor, gates: torch.Tensor, idx: torch.Tensor,
              cfg: ModelConfig, r: Optional[Route] = None):
    """The routed experts' output (T, d) for these T tokens -- this rank's
    part of it where ``r.partial`` names axes -- and each expert's count of
    kept (token, choice) pairs among them (E,) f32."""
    from repro_torch.sharding import comm

    T, d = xt.shape
    E, k = cfg.n_experts, cfg.experts_per_tok
    r = route(cfg, T) if r is None else r
    S, C = r.shards, capacity(cfg, r.t_shard)
    flat_e = idx.reshape(T * k)
    flat_g = gates.reshape(T * k)
    pos, keep = _assign(flat_e, cfg, r)

    n_split = r.ep.n_split if r.ep is not None and r.ep.experts else 1
    E_loc = E // n_split
    base = 0 if r.exchange or n_split == 1 else r.ep.index * E_loc
    E_here = E if r.exchange else E_loc
    mine = (flat_e >= base) & (flat_e < base + E_here)
    use = keep & mine
    shard = torch.arange(T * k, device=xt.device) // (k * (T // S))

    # Dispatch: each kept (token, choice) owns one (expert, shard, slot) row
    # of the (E*S*C, d) buffer, so writing the kept rows gives the
    # reference's scatter-add of zeros for the rest. The others all write a
    # spare row past the buffer's end, which no expert reads: no shape
    # depends on the routing (no mask selection, which would sync the host
    # and which a fake tensor cannot size).
    src = torch.arange(T * k, device=xt.device) // k
    row = ((flat_e - base) * S + shard) * C + pos
    n_rows = E_here * S * C
    buf = torch.zeros((n_rows + 1, d), dtype=xt.dtype, device=xt.device)
    buf[torch.where(use, row, n_rows)] = xt[src]
    buf = buf[:n_rows].view(E_here, S, C, d)
    if r.exchange:
        ax, n = r.ep.experts, n_split
        got = comm.exchange(buf, r.mesh, ax).view(n, E_loc, S, C, d)
        if r.span:
            # One buffer of global positions: the ranks' pieces hold
            # disjoint rows, so their sum is exact.
            eo = _experts(p, got.sum(0).view(E_loc, C, d))
            eo = comm.gather_blocks(eo, r.mesh, ax)
        else:
            # The shards' buffers side by side, back by the reverse exchange.
            eo = _experts(p, got.transpose(0, 1).reshape(E_loc, n * S * C, d))
            eo = eo.view(E_loc, n, S, C, d).transpose(0, 1).reshape(E, S, C, d)
            eo = comm.exchange(eo, r.mesh, ax)
    else:
        eo = _experts(p, buf.view(E_here, S * C, d))
    eo = eo.reshape(n_rows, d)

    tok_out = eo[torch.where(mine, row, 0)]                            # (T*k, d)
    tok_out = tok_out * (flat_g * use).to(tok_out.dtype)[:, None]
    out = tok_out.reshape(T, k, d).sum(dim=1)
    counts = torch.zeros((E,), dtype=torch.float32, device=xt.device).index_add_(
        0, flat_e, keep.to(torch.float32))
    return out, counts


def moe_ffn(p: Dict, x: torch.Tensor, cfg: ModelConfig, at=None):
    """x: (b, s, d) -> (out (b, s, d), aux loss f32 scalar). ``p``: the
    layer's leaves, this rank's blocks where ``at`` splits them; ``at``:
    :func:`where`'s placement (read from the active mesh when None)."""
    from repro_torch.sharding import comm

    if cfg.moe_dispatch not in DISPATCHES:
        raise ValueError(f"moe_dispatch {cfg.moe_dispatch!r} not in {DISPATCHES}")
    b, s, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_tok
    T = b * s
    xt = x.reshape(T, d)
    r = route(cfg, T, at)

    logits = xt.to(torch.float32) @ p["router"].to(torch.float32)      # (T, E)
    probs = dm.softmax(logits, axis=-1, cfg=cfg.division)
    gate_vals, idx = top_k(probs, k)                                   # (T, k)
    denom = torch.sum(gate_vals, dim=-1, keepdim=True)
    gates = gate_vals * dm.recip(denom, cfg.division)                  # (T, k)

    # The routed rows and gates feed a partial sum over ``part``: their
    # gradients are the sum of the ranks' (the router's own path, and the
    # aux's, are whole on every rank).
    part = r.partial
    xe = comm.copy_to_split(xt, r.mesh, part) if part else xt
    ge = comm.copy_to_split(gates, r.mesh, part) if part else gates
    out, counts = _dispatch(p, xe, ge, idx, cfg, r)
    if cfg.n_shared_experts:
        sh = (r.ep.shared,) if r.ep is not None and r.ep.shared else ()
        if sh and sh == part:
            # The shared experts' partial sums join the routed ones.
            out = comm.reduce_from_split(out + gated_mlp(p["shared"], xe), r.mesh, part)
        else:
            if part:
                out = comm.reduce_from_split(out, r.mesh, part)
            xs = comm.copy_to_split(xt, r.mesh, sh) if sh else xt
            shared = gated_mlp(p["shared"], xs)
            out = out + (comm.reduce_from_split(shared, r.mesh, sh) if sh else shared)
    elif part:
        out = comm.reduce_from_split(out, r.mesh, part)

    T_glob = T * r.n_tok
    if r.tok:
        # The global batch's aux: counts and probability sums over every
        # rank's rows (the sum carries its gradient back to each rank's
        # router).
        counts = comm.all_reduce(counts, r.mesh, r.tok)
        P_e = comm.all_reduce_sum_grad(torch.sum(probs, dim=0), r.mesh, r.tok) / T_glob
    else:
        P_e = torch.mean(probs, dim=0)
    f_e = counts / (T_glob * k) * E
    aux = E * torch.sum(f_e * P_e) * cfg.router_aux_weight
    return out.reshape(b, s, d), aux
