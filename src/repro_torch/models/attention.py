"""Attention (GQA): full causal and sliding-window for training/prefill,
cross attention on precomputed K/V, and one-token decode against a full
cache, a W-sized ring or the cross K/V.

The PyTorch counterpart of ``src/repro/models/attention.py``, with its
layouts: ``wq`` is ``(d, H,
hd)``, ``wo`` is ``(H, hd, d)``, activations ``(b, s, h, hd)``. Softmax
denominators go through the division unit (``division_modes.softmax`` on
the materialised f32 scores). Sliding-window attention is block-local, as
in the reference: each W-sized query block sees the previous and its own
key block, O(S*W). Cross attention takes its K/V as given (no rope on
them or on its queries) and masks nothing.

The reference's ``shard_dim`` annotations become ``tp`` (a
``models.parallel.TensorParallel``): where ``heads`` is split, a rank
projects its own query heads and the KV heads they read
(:func:`project_q`, :func:`project_kv`), attends over them, and its output
projection's partial sums are added over the ranks; its cache holds those
KV heads. Without ``tp``, or with heads replicated, every head is local.

The decode KV cache is updated in place (``index_put_``), where the JAX
reference builds a new cache array: the cache passed to
:func:`decode_attention` is the cache it returns.

A cache whose sequence lies on a mesh axis (``models.parallel.SeqSplit``:
``model`` under ``kvseq``, ``data`` for a batch-1 long context) holds the
rank's block of the slots. Decode then runs a split softmax
(:func:`_split_sdpa`): the rank's scores over its slots, their maximum
over the ranks (exact), the exponentials and their sum in the consumer
kernels' order, summed over the ranks, one reciprocal through the
division unit, and the rank's ``probs @ V`` partials summed over the
ranks; only the sums' order differs from the whole row's. Validity is
reckoned on the global slot index, and only the rank that holds the new
token's slot writes it. Under ``kvseq`` the cache holds every KV head:
the rank gathers the query heads and the new token's K/V heads, attends
with all of them and keeps its own heads' rows for the output projection.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.core import division_modes as dm
from repro_torch.kernels.flash_attention import NEG_INF
from .layers import rope

__all__ = ["NEG_INF", "rope_apply", "enter", "enter_whole", "project_q", "project_kv",
           "kv_whole", "full_attention", "sliding_attention", "init_cache_attn",
           "abstract_cache_attn", "decode_positions", "decode_attention"]


def _proj(x, w):
    """(b, s, d) @ (d, h, hd) -> (b, s, h, hd)."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])


def _out_proj(out, wo):
    """(b, s, h, hd) @ (h, hd, d) -> (b, s, d)."""
    return out.reshape(*out.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1])


def _repeat_kv(k, n_rep: int, tp=None):
    """Each query head's K (or V): the GQA repeat, or on a rank whose query
    heads read only some of its KV heads, those picked by index."""
    idx = None if tp is None else tp.kv_index(k.device)
    if idx is not None:
        return k.index_select(2, idx)
    if n_rep == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(
        b, s, kv * n_rep, hd)


def _split(tp) -> bool:
    return tp is not None and tp.heads


def enter(x, tp=None):
    """``x`` as the split projections read it: its gradient is summed over
    the ranks (once per input, however many projections read it), or under
    a sequence split by the gather that made it (``tp.into``)."""
    return tp.into(x) if _split(tp) else x


def enter_whole(x, tp=None):
    """A value whole on every rank (the encoder's output) as the split
    projections read it: its gradient summed over the ranks."""
    return tp.copy(x) if _split(tp) else x


def project_q(p, x, tp=None):
    """The rank's query heads of ``x`` (b, s, d), entered
    (:func:`enter`): (b, s, h_local, hd)."""
    return _proj(x, p["wq"])


def project_kv(p, x, tp=None):
    """The rank's K and V heads of ``x`` (b, s, d), entered
    (``tp.kv_range``): its block of the split weights, or the heads it reads
    of replicated ones, whose gradients are then summed over the ranks."""
    if not _split(tp) or tp.kv:
        return _proj(x, p["wk"]), _proj(x, p["wv"])
    lo, hi = tp.kv_range()
    return tuple(_proj(x, tp.copy(p[n])[:, lo:hi]) for n in ("wk", "wv"))


def kv_whole(p, x, k, v, tp=None, positions=None, cfg: ModelConfig = None):
    """Every KV head of the rank's ``(k, v)`` projected from ``x`` (no
    gradient): its blocks gathered over the ranks where ``kv_heads`` is
    split, projected again from the whole weights where the rank projected
    the heads its queries read (roped at ``positions`` when given), as
    they are where heads are not split."""
    if not _split(tp):
        return k, v
    if tp.kv:
        return tp.gather(k, 2), tp.gather(v, 2)
    k, v = _proj(x, p["wk"]), _proj(x, p["wv"])
    return (k if positions is None else rope_apply(k, positions, cfg)), v


def _attn_out(out, p, tp=None):
    """The output projection; split over heads, its partial sums added over
    the ranks in the product's dtype (or left to a sequence split's
    reduce-scatter)."""
    y = _out_proj(out, p["wo"])
    return tp.out(y) if _split(tp) else y


def _sdpa(q, k, v, mask, div: dm.DivisionConfig, scale: float):
    """q: (b,qs,h,hd), k/v: (b,ks,h,hd), mask: broadcastable to (b,h,qs,ks),
    or None where every key is seen."""
    scores = torch.einsum("bqhk,bthk->bhqt", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = dm.softmax(scores, axis=-1, cfg=div)
    return torch.einsum("bhqt,bthk->bqhk", probs.to(v.dtype), v)


def rope_apply(x, positions, cfg: ModelConfig):
    return rope(x, positions, cfg.rope_theta)


def full_attention(p, x, positions, cfg: ModelConfig, *, causal: bool = True,
                   kv_override=None, return_kv: bool = False, tp=None):
    """Training/prefill attention, query-chunked above cfg.attn_chunk:
    causal self-attention, or (``kv_override``: the precomputed cross
    ``(k, v)``, not roped, nor are the queries) cross attention, which masks
    nothing; ``causal=False`` unmasks self-attention too.

    With ``return_kv`` it also returns the post-rope ``(k, v)`` before the
    GQA repeat, which prefill stores in the cache (the reference recomputes
    them and lets XLA merge the two).
    """
    b, s, _ = x.shape
    scale = 1.0 / math.sqrt(cfg.head_dim)
    x = enter(x, tp)
    if kv_override is not None:
        q = project_q(p, x, tp)
        k, v = kv_override
    else:
        q = rope_apply(project_q(p, x, tp), positions, cfg)
        k, v = project_kv(p, x, tp)
        k = rope_apply(k, positions, cfg)
    kr, vr = _repeat_kv(k, cfg.q_per_kv, tp), _repeat_kv(v, cfg.q_per_kv, tp)
    masked = causal and kv_override is None

    def attend(qc, qpos):
        mask = qpos[:, None, :, None] >= positions[:, None, None, :] if masked else None
        return _sdpa(qc, kr, vr, mask, cfg.division, scale)

    chunk = cfg.attn_chunk
    if s <= chunk or s % chunk != 0:
        out = attend(q, positions)
    else:
        out = torch.cat([attend(q[:, i:i + chunk], positions[:, i:i + chunk])
                         for i in range(0, s, chunk)], dim=1)
    out = _attn_out(out, p, tp)
    return (out, (k, v)) if return_kv else out


def _sliding_mask(nb: int, w: int, device) -> torch.Tensor:
    """(nb, w, 2w): query i of a block sees keys i-w+1 .. i of the previous
    and its own block; block 0 has no previous block (the phantom block)."""
    qpos = torch.arange(w, device=device)
    kpos = torch.arange(2 * w, device=device) - w
    base = (qpos[:, None] >= kpos[None, :]) & (qpos[:, None] - kpos[None, :] < w)
    first = kpos[None, :] >= 0
    bidx = torch.arange(nb, device=device)
    return base[None] & (first | (bidx[:, None, None] > 0))


def sliding_attention(p, x, positions, cfg: ModelConfig, *,
                      return_kv: bool = False, tp=None):
    """Block-local sliding-window attention: O(S*W) compute and memory.

    A sequence no longer than the window is plain causal attention;
    otherwise its length must be a multiple of the window (the serving
    engine pads prompts to it). ``return_kv`` as in :func:`full_attention`.
    """
    b, s, _ = x.shape
    w = cfg.sliding_window
    scale = 1.0 / math.sqrt(cfg.head_dim)
    x = enter(x, tp)
    q = rope_apply(project_q(p, x, tp), positions, cfg)
    k, v = project_kv(p, x, tp)
    k = rope_apply(k, positions, cfg)
    kr, vr = _repeat_kv(k, cfg.q_per_kv, tp), _repeat_kv(v, cfg.q_per_kv, tp)
    if s <= w:
        mask = positions[:, None, :, None] >= positions[:, None, None, :]
        out = _sdpa(q, kr, vr, mask, cfg.division, scale)
    else:
        if s % w:
            raise ValueError(f"seq {s} must be a multiple of window {w}")
        nb = s // w
        h, hd = q.shape[2], q.shape[3]
        qb = q.reshape(b, nb, w, h, hd)
        # Each key/value block after the one before it (zeros before block 0):
        # (b, nb, 2w, h, hd).
        k2, v2 = (torch.cat([torch.cat([torch.zeros_like(t[:, :1]), t[:, :-1]], 1), t], 2)
                  for t in (kr.reshape(b, nb, w, h, hd), vr.reshape(b, nb, w, h, hd)))
        scores = torch.einsum("bnqhk,bnthk->bnhqt", qb.to(torch.float32),
                              k2.to(torch.float32)) * scale
        mask = _sliding_mask(nb, w, x.device)
        scores = torch.where(mask[None, :, None], scores, NEG_INF)
        probs = dm.softmax(scores, axis=-1, cfg=cfg.division)
        out = torch.einsum("bnhqt,bnthk->bnqhk", probs.to(v2.dtype), v2)
        out = out.reshape(b, s, h, hd)
    out = _attn_out(out, p, tp)
    return (out, (k, v)) if return_kv else out


def cache_heads(cfg: ModelConfig, tp=None, seq=None) -> int:
    """The KV heads a rank's cache leaf holds: all of them where its
    sequence lies on ``model`` (``kvseq``) or nothing is split, else those
    it projects (``tp.kv_range``)."""
    if tp is None or (seq is not None and seq.axis == "model"):
        return cfg.n_kv_heads
    return tp.kv_local


def _cache_shape(cfg: ModelConfig, batch: int, max_len: int, window: int, tp=None,
                 seq=None):
    slots = window if window > 0 else max_len
    return (batch, slots // (seq.n if seq is not None else 1), cache_heads(cfg, tp, seq),
            cfg.head_dim)


def init_cache_attn(cfg: ModelConfig, batch: int, max_len: int, window: int = 0,
                    dtype=torch.bfloat16, device=None, tp=None,
                    seq=None) -> Dict[str, torch.Tensor]:
    """Zero K/V: ``max_len`` slots, or a ``window``-slot ring when > 0; the
    rank's KV heads under ``tp``, its block of the slots under ``seq`` (a
    ``models.parallel.SeqSplit``)."""
    shape = _cache_shape(cfg, batch, max_len, window, tp, seq)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def abstract_cache_attn(cfg: ModelConfig, batch: int, max_len: int, window: int = 0,
                        dtype=torch.bfloat16, device=None, fake_mode=None, tp=None,
                        seq=None):
    """:func:`init_cache_attn`'s tree as stand-ins that allocate nothing
    (``repro_torch.tree.abstract``)."""
    shape = _cache_shape(cfg, batch, max_len, window, tp, seq)
    return {"k": tree.abstract(shape, dtype, device, fake_mode),
            "v": tree.abstract(shape, dtype, device, fake_mode)}


def decode_positions(pos, batch: int, device=None) -> torch.Tensor:
    """Decode ``pos`` as a (batch,) int32 vector: a scalar (every request at
    one position) or a per-request (batch,) vector."""
    pos_v = torch.as_tensor(pos, dtype=torch.int32, device=device).reshape(-1)
    if pos_v.shape[0] == 1:
        pos_v = pos_v.expand(batch)
    return pos_v


def _split_sdpa(q, k, v, mask, div: dm.DivisionConfig, scale: float, seq):
    """:func:`_sdpa` over the rank's block of the keys (``seq``, a
    ``models.parallel.SeqSplit``), combined over the ranks: the split
    softmax (``division_modes.split_softmax``: the scores' maximum and the
    exponentials' row sums all-reduced, one reciprocal of the sum through
    the division unit) and the ranks' ``probs @ V`` partials summed. A rank
    whose keys are all masked adds zeros; a row masked on every rank comes
    out as zeros, as ``division_modes.softmax`` gives it."""
    from repro_torch.sharding import comm

    axes = (seq.axis,)
    scores = torch.einsum("bqhk,bthk->bhqt", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if mask is not None:
        scores = torch.where(mask, scores, -torch.inf)
    probs = dm.split_softmax(
        scores, div, lambda t: comm.all_reduce(t, seq.mesh, axes, op="max"),
        lambda t: comm.all_reduce(t, seq.mesh, axes))
    out = torch.einsum("bhqt,bthk->bqhk", probs.to(v.dtype), v)
    return comm.all_reduce(out, seq.mesh, axes)


def _attend(q, k, v, mask, cfg: ModelConfig, scale: float, seq):
    if seq is None:
        return _sdpa(q, k, v, mask, cfg.division, scale)
    return _split_sdpa(q, k, v, mask, cfg.division, scale, seq)


def decode_attention(p, x, cache, pos, cfg: ModelConfig, *, window: int = 0,
                     kv_override=None, tp=None, seq=None):
    """One-token decode. x: (b, 1, d); cache k/v: (b, L, kv, hd); pos: a
    scalar or a per-request (b,) vector of absolute positions.

    With ``kv_override`` (the cross ``(k, v)``) the query attends to every
    cross key, unroped, and ``cache`` is returned as it came.

    Full-attention layers (``window`` 0): request i writes its k/v at slot
    pos_i (in place) and attends to slots 0..pos_i, so pad slots of a padded
    batch above pos_i are never seen. Sliding-window layers treat the cache
    as a ring of L = W slots: slot pos_i % L, and slot j is valid when the
    position it holds, pos_i - ((pos_i - j) mod L), is not negative (softmax
    does not depend on the ring's order). ``seq`` (a
    ``models.parallel.SeqSplit``): the cache (or the cross K/V) is the
    rank's block of the slots, and the softmax is combined over the ranks
    (:func:`_split_sdpa`). Returns (out, cache).
    """
    b = x.shape[0]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    x = enter(x, tp)
    # kvseq: every KV head on every rank, the query heads gathered to read them.
    whole = seq is not None and seq.axis == "model" and _split(tp)
    rep = None if whole else tp
    if kv_override is not None:
        q = project_q(p, x, tp)
        if whole:
            q = tp.gather(q, 2)
        k_all, v_all = (_repeat_kv(t, cfg.q_per_kv, rep) for t in kv_override)
        out = _attend(q, k_all, v_all, None, cfg, scale, seq)
        return _attn_out(tp.own_heads(out) if whole else out, p, tp), cache
    pos_v = decode_positions(pos, b, x.device)
    posv = pos_v[:, None]
    q = rope_apply(project_q(p, x, tp), posv, cfg)
    k_new, v_new = project_kv(p, x, tp)
    k_new = rope_apply(k_new, posv, cfg)
    if whole:
        q = tp.gather(q, 2)
        k_new, v_new = kv_whole(p, x, k_new, v_new, tp, posv, cfg)
    bidx = torch.arange(b, device=x.device)
    L = cache["k"].shape[1]
    if seq is None:
        slot = (torch.remainder(pos_v, L) if window > 0 else pos_v).long()
        cache["k"][bidx, slot] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][bidx, slot] = v_new[:, 0].to(cache["v"].dtype)
        idx, G = torch.arange(L, device=x.device), L
    else:
        # The rank's block [lo, lo + L) of G global slots: the rank that
        # holds the new token's slot writes it, the others write back what
        # they hold.
        G, lo = L * seq.n, L * seq.index
        slot = (torch.remainder(pos_v, G) if window > 0 else pos_v).long() - lo
        mine = ((slot >= 0) & (slot < L))[:, None, None]
        at = slot.clamp(0, L - 1)
        for name, new in (("k", k_new), ("v", v_new)):
            c = cache[name]
            c[bidx, at] = torch.where(mine, new[:, 0].to(c.dtype), c[bidx, at])
        idx = lo + torch.arange(L, device=x.device)
    k_all = _repeat_kv(cache["k"], cfg.q_per_kv, rep)
    v_all = _repeat_kv(cache["v"], cfg.q_per_kv, rep)
    if window > 0:
        held = pos_v[:, None] - torch.remainder(pos_v[:, None] - idx[None, :], G)
        valid = held >= 0
    else:
        valid = idx[None, :] <= pos_v[:, None]
    mask = valid[:, None, None, :]
    out = _attend(q, k_all, v_all, mask, cfg, scale, seq)
    return _attn_out(tp.own_heads(out) if whole else out, p, tp), cache
