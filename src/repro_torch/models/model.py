"""Model assembly: decoder stacks of attention, sliding-window and Mamba-2
mixers with dense, MoE or no FFNs, the encoder-decoder's encoder and cross
attention, and embedding inputs.

The PyTorch counterpart of ``src/repro/models/model.py``. The reference
lowers each group of layers as one ``lax.scan`` over stacked parameters;
here a Python loop runs a group's ``repeat * period`` layers in order (see
:mod:`.params` for the layout).

Modes: ``train`` (no cache), ``prefill`` (emit cache), ``decode`` (carry
cache). Sliding-window layers keep a W-slot ring cache: slot = position %
W; attention K/V are updated in place (see :mod:`.attention`), a Mamba
layer's state and conv window are replaced each step, and an
encoder-decoder's cross K/V are computed at prefill and read as they are.

In ``train`` with ``cfg.remat`` and autograd on, each decoder block runs
under ``torch.utils.checkpoint`` (the reference checkpoints each scan body):
the backward pass recomputes the block from its input, so its kernels run
twice. The encoder and the final norm are not recomputed, as in the
reference.

Under an active mesh whose ``model`` axis holds more than one rank
(``sharding.rules.use_mesh``) the attention, MLP, Mamba-2 and vocab weights
run split over it, and wherever the experts' specs put them on a live axis
the MoE FFN's experts run split too (``models/parallel.py``,
``models/moe.py``): each rank takes its blocks of the parameters
(DTensors, the global tree or its own blocks), the logits are its vocab
block, and the cache holds its KV heads and Mamba-2 heads. The tokens
given are the whole batch on every rank, unless
``sharding.rules.split_tokens`` says they are the rank's block of it (the
train step). A leaf that its spec puts on a batch axis (FSDP) is the
rank's block of it, put together at the top of each block (under remat,
again in the recompute) and where the embedding, final norm and LM head
are read; the gathered copy lives while its block runs.

Where ``sharding_rules["__seq_shard__"]`` names ``model`` and the
sequence divides by its size (train and prefill), the residual stream
between blocks is the rank's block of the sequence (Megatron-LM's
sequence parallelism, ``models.parallel.seq_parallel``): the embedding's
output is reduce-scattered over it (or cut, where the vocab is whole),
each RMSNorm runs on the rank's rows (its weight's gradient summed over
the ranks), each sub-layer reads the all-gathered sequence and its output
is reduce-scattered back to the rank's rows where its product is split
over ``model`` (attention and cross attention over heads, the MLP over
``mlp``, the Mamba-2 mixer by heads), or cut to them where every rank
computes it whole (a replicated sub-layer, the MoE FFN, which sums its own
partials); the final norm's rows are gathered before the LM head. Rings,
SSM pad masks and prefill K/V are made from the gathered sequence. A
decode cache whose sequence lies on an axis (``kvseq``, or ``data`` for a
batch-1 long context: ``sharding.rules.cache_seq_axis``) holds the rank's
block of the slots, and decode combines the softmax over that axis
(``models/attention.py``).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.configs.base import LayerSpec, ModelConfig
from .attention import (abstract_cache_attn, cache_heads, decode_attention, decode_positions,
                        enter_whole, full_attention, init_cache_attn, kv_whole, project_kv,
                        sliding_attention)
from .layers import embed_tokens, gated_mlp, lm_logits, rms_norm
from .mamba2 import abstract_cache_mamba, decode_mamba, init_cache_mamba, mamba_mixer
from .moe import moe_ffn, where
from .parallel import (AXIS, kv_full_split, kv_heads_whole, kv_split, local_params,
                       seq_parallel, tensor_parallel)
from .params import torch_dtype

__all__ = ["block_forward", "encode", "forward", "make_cache", "cache_layout", "group_layers"]


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
                  *, mode: str, cache=None, pos=None, enc_out=None, lengths=None, tp=None,
                  at=None, seqs=None):
    """One block; returns (x, new_cache, aux). ``enc_out`` (train and
    prefill of an encoder-decoder): the encoder's output, which the cross
    attention projects to K/V. ``lengths`` (prefill only): the real prompt
    lengths of a right-padded batch, which make pad tokens SSM no-ops and
    keep them out of sliding-window rings. ``tp``: the rank's tensor-parallel
    plan (``models/parallel.py``), ``bp`` its blocks; with ``tp.seq`` ``x``
    is the rank's block of the sequence. ``at``: where the MoE FFN routes
    (``moe.where``). ``seqs`` (decode): the ``SeqSplit`` of the layer's
    self-attention cache (``"attn"``) and cross K/V (``"cross"``), None
    where whole."""
    div = cfg.division
    if tp is not None and tp.fsdp:
        bp = tp.gather_block(bp, spec, "cross" in bp)
    split_seq = tp is not None and tp.seq
    seqs = seqs or {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: Dict[str, Any] = {}

    def norm(w):
        # Under a sequence split the weight sees the rank's rows only.
        return rms_norm(x, tp.copy(w) if split_seq else w, div, cfg.norm_eps)

    def sub(split: bool, fn, h):
        """(y, extra) = fn(h), y back on the rank's rows of the sequence."""
        if not split_seq:
            return fn(h)
        from repro_torch.sharding import comm

        y, extra = fn(comm.gather_seq(h, tp.mesh, AXIS, 1, split))
        return comm.scatter_seq(y, tp.mesh, AXIS, 1, split), extra

    whole_kv = mode == "prefill" and kv_heads_whole(cfg, tp)
    h = norm(bp["mixer_norm"])
    if spec.mixer == "mamba":
        ssm = tp is not None and tp.ssm
        if mode == "decode":
            mh, new_cache["mamba"] = decode_mamba(bp["mamba"], h, cache["mamba"], cfg, tp)
        elif mode == "prefill":
            mh, new_cache["mamba"] = sub(ssm, lambda hg: mamba_mixer(
                bp["mamba"], hg, cfg, return_state=True, lengths=lengths, tp=tp), h)
        else:
            mh, _ = sub(ssm, lambda hg: (mamba_mixer(bp["mamba"], hg, cfg, tp=tp), None), h)
        x = x + mh
    else:
        window = cfg.sliding_window if spec.mixer == "swa" else 0
        if mode == "decode":
            ah, new_cache["attn"] = decode_attention(bp["attn"], h, cache["attn"], pos, cfg,
                                                     window=window, tp=tp,
                                                     seq=seqs.get("attn"))
        else:
            fn = sliding_attention if window else full_attention

            def attend(hg):
                ah, (k, v) = fn(bp["attn"], hg, positions, cfg, return_kv=True, tp=tp)
                if whole_kv:
                    k, v = kv_whole(bp["attn"], hg, k, v, tp, positions, cfg)
                return ah, (k, v)

            ah, (k, v) = sub(tp is not None and tp.heads, attend, h)
            if mode == "prefill":
                if window:
                    k = _ring_from_prefill(k, window, lengths)
                    v = _ring_from_prefill(v, window, lengths)
                dt = torch_dtype(cfg.param_dtype)
                new_cache["attn"] = {"k": k.to(dt), "v": v.to(dt)}
        x = x + ah

    if "cross" in bp:  # encoder-decoder cross attention (no rope on its K/V)
        hc = norm(bp["cross_norm"])
        if mode == "decode":
            kv = (cache["cross"]["ck"], cache["cross"]["cv"])
            ch, _ = decode_attention(bp["cross"], hc, None, pos, cfg, kv_override=kv,
                                     tp=tp, seq=seqs.get("cross"))
            new_cache["cross"] = cache["cross"]
        else:
            ck, cv = project_kv(bp["cross"], enter_whole(enc_out, tp), tp)
            ch, _ = sub(tp is not None and tp.heads, lambda hg: (full_attention(
                bp["cross"], hg, positions, cfg, causal=False, kv_override=(ck, cv), tp=tp),
                None), hc)
            if mode == "prefill":
                if whole_kv:
                    ck, cv = kv_whole(bp["cross"], enc_out, ck, cv, tp)
                new_cache["cross"] = {"ck": ck, "cv": cv}
        x = x + ch

    if spec.ffn != "none":
        h2 = norm(bp["ffn_norm"])
        if spec.ffn == "moe":
            # The MoE FFN sums its own partials: every rank's output is whole.
            ff, a = sub(False, lambda hg: moe_ffn(bp["ffn"], hg, cfg, at), h2)
            aux = aux + a
        else:
            ff, _ = sub(tp is not None and tp.mlp,
                        lambda hg: (gated_mlp(bp["ffn"], hg, tp), None), h2)
        x = x + ff
    return x, new_cache, aux


def _remat_block(*args, **kw):
    """block_forward whose activations the backward pass recomputes. A block
    draws no random numbers, so the recompute needs no RNG state."""
    return checkpoint(block_forward, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def _top(params, name: str, tp):
    """A top-level leaf as the model reads it: gathered where it is stored
    as the rank's block over a batch axis."""
    return params[name] if tp is None else tp.gather_top(params[name], name)


def encode(cfg: ModelConfig, enc_params, enc_embeds, tp=None):
    """The encoder over stub frontend embeddings (b, s, d_model): attention
    and dense blocks, then the final norm. Its attention is causal: the
    reference's ``encode`` runs ``full_attention`` with its default
    ``causal=True`` (ROADMAP F9). ``tp``: as :func:`block_forward`'s, with
    ``enc_params`` the rank's blocks."""
    b, s, _ = enc_embeds.shape
    x = enc_embeds.to(torch_dtype(cfg.param_dtype))
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    spec = LayerSpec("attn", "dense")
    for lp in enc_params["groups"][0]["layers"]:
        x, _, _ = block_forward(lp, x, spec, cfg, positions, mode="train", tp=tp)
    return rms_norm(x, _top(enc_params, "final_norm", tp), cfg.division, cfg.norm_eps)


def forward(cfg: ModelConfig, params, *, tokens=None, embeds=None, cache=None, pos=None,
            mode: str = "train", enc_embeds=None, lengths=None):
    """Returns (logits (b, s, V) f32, new_cache, aux f32 scalar).

    ``embeds`` (b, s, d_model) take the place of ``tokens`` for an
    embedding-input model (not an encoder-decoder); ``enc_embeds`` feed an
    encoder-decoder's encoder in train and prefill (decode reads the cross
    K/V from the cache). ``pos`` (decode) is a scalar or a per-request (b,)
    vector. ``lengths`` (prefill) marks per-request real prompt lengths of a
    right-padded batch: pad positions become SSM no-ops and are kept out of
    sliding-window rings.

    Under an active mesh with a ``model`` axis above 1 the logits are the
    rank's vocab block (all of them where ``vocab`` does not split) and the
    cache holds the rank's KV heads.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    tp = tensor_parallel(cfg)
    if tp is not None:
        params = local_params(cfg, params, tp)
    enc_out = None
    if cfg.is_encoder_decoder and mode != "decode":
        enc_out = encode(cfg, params["encoder"], enc_embeds, tp)
    from_embeds = embeds is not None and cfg.embed_inputs and not cfg.is_encoder_decoder
    tps = seq_parallel(cfg, tp, (embeds if from_embeds else tokens).shape[1], mode)
    split_seq = tps is not None and tps.seq
    if from_embeds:
        x = embeds.to(torch_dtype(cfg.param_dtype))
    else:
        x = embed_tokens(_top(params, "embed", tp), tokens, cfg, tps)
    b, s = x.shape[0], x.shape[1]
    if split_seq:
        from repro_torch.sharding import comm

        x = comm.scatter_seq(x, tps.mesh, AXIS, 1, tps.vocab and not from_embeds)
    seqs = None
    if mode == "decode":
        pos = decode_positions(pos, b, x.device)
        positions = pos[:, None]
        lengths = None
        seqs = cache_layout(cfg, b, 1)
    else:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
        if lengths is not None:
            lengths = torch.as_tensor(lengths, dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    at = where(cfg) if any(s.ffn == "moe" for s in cfg.layer_specs()) else None
    block = (_remat_block if cfg.remat and mode == "train" and torch.is_grad_enabled()
             else block_forward)
    new_groups = []
    for gi, group in enumerate(cfg.groups()):
        layers = params["groups"][gi]["layers"]
        caches = []
        for li, spec in enumerate(group_layers(group)):
            lc = cache["groups"][gi]["layers"][li] if mode == "decode" else None
            ls = None if seqs is None else {
                "attn": seqs["ring" if spec.mixer == "swa" else "full"],
                "cross": seqs["cross"]}
            x, nc, a = block(layers[li], x, spec, cfg, positions,
                             mode=mode, cache=lc, pos=pos,
                             enc_out=enc_out, lengths=lengths, tp=tps, at=at, seqs=ls)
            caches.append(nc)
            aux = aux + a
        new_groups.append({"layers": caches})
    final = _top(params, "final_norm", tp)
    x = rms_norm(x, tps.copy(final) if split_seq else final, cfg.division, cfg.norm_eps)
    if split_seq:
        x = comm.gather_seq(x, tps.mesh, AXIS, 1, tps.vocab)
    head = "embed" if cfg.tie_embeddings else "lm_head"
    logits = lm_logits({head: _top(params, head, tp)}, x, cfg, tps)
    new_cache = {"groups": new_groups} if mode in ("prefill", "decode") else None
    return logits, new_cache, aux


def _rows(batch: int, mesh) -> int:
    """The global batch of ``batch`` rows given to this rank: its block of
    the batch under ``rules.split_tokens``, the whole otherwise."""
    from repro_torch.sharding import rules as shr

    return batch * shr.axes_size(mesh, shr.token_axes())


def cache_layout(cfg: ModelConfig, batch: int, max_len: int, mesh=None):
    """The ``SeqSplit`` (or None) of a decode cache's full-attention K/V
    (``"full"``), rings (``"ring"``) and cross K/V (``"cross"``) on ``mesh``
    for a decode batch of ``batch`` global rows; without ``mesh``, on the
    active mesh for ``batch`` rows given to this rank (its block of the
    batch under ``rules.split_tokens``) (``sharding.rules.cache_seq_axis``);
    and the full-attention K/V's global slots (``"slots"``). Where the axis
    does not divide ``max_len`` the slots are rounded up to a multiple of
    it (the reference holds them whole; the slots past ``max_len`` are
    never valid), so a decode step reads the layout from the mesh and the
    batch alone (``parallel.kv_full_split``)."""
    from repro_torch.sharding import rules as shr

    if mesh is None:
        mesh = shr.active_mesh()
        if mesh is not None:
            batch = _rows(batch, mesh)
    if mesh is None:
        return {"full": None, "ring": None, "cross": None, "slots": max_len}
    full = kv_full_split(cfg, mesh, batch)
    return {"full": full,
            "ring": kv_split(cfg, mesh, batch, cfg.sliding_window) if cfg.sliding_window
            else None,
            "cross": kv_split(cfg, mesh, batch, cfg.encoder_seq) if cfg.is_encoder_decoder
            else None,
            "slots": max_len if full is None else -(-max_len // full.n) * full.n}


def make_cache(cfg: ModelConfig, batch: int, max_len: int, device=None,
               abstract: bool = False, fake_mode=None):
    """Zero decode cache in the parameters' grouped layout: ``max_len`` slots
    for full-attention layers, W-slot rings for sliding-window layers, the
    SSM state and conv windows for Mamba layers, and an encoder-decoder's
    ``encoder_seq``-long cross K/V. ``abstract``: the same tree as stand-ins
    that allocate nothing (``repro_torch.tree.abstract``; ``fake_mode``'s
    fake tensors on ``device``, or ``meta`` tensors). Under an active mesh
    with a ``model`` axis above 1, the rank's KV heads and Mamba-2 heads;
    where the cache's layout puts a K/V leaf's sequence on an axis
    (:func:`cache_layout`), the rank's block of its slots (and, on
    ``model``, every KV head). ``batch``: the rows given to this rank.

    This is the one source of the cache's layout. It is the reference's
    (``cache_specs`` of ``src/repro/launch/dryrun.py``) but for three
    deliberate differences: where the KV heads do not divide over a split
    ``model`` axis, a rank holds the KV heads its query heads read (the
    reference keeps them whole); the Mamba-2 ``conv_B`` / ``conv_C``
    windows are whole on every rank (each rank computes the one group's B
    and C); a full-attention ``max_len`` that the sequence's axis does not
    divide is rounded up to a multiple of it (the reference holds it
    whole)."""
    dt = torch_dtype(cfg.param_dtype)
    tp = tensor_parallel(cfg)
    lay = cache_layout(cfg, batch, max_len)
    if abstract:
        attn = lambda *a, seq: abstract_cache_attn(*a, device=device, fake_mode=fake_mode,
                                                   tp=tp, seq=seq)
        mamba = lambda *a: abstract_cache_mamba(*a, device=device, fake_mode=fake_mode, tp=tp)
        zeros = lambda shape: tree.abstract(shape, dt, device, fake_mode)
    else:
        attn = lambda *a, seq: init_cache_attn(*a, device=device, tp=tp, seq=seq)
        mamba = lambda *a: init_cache_mamba(*a, device=device, tp=tp)
        zeros = lambda shape: torch.zeros(shape, dtype=dt, device=device)
    cross = lay["cross"]
    groups = []
    for g in cfg.groups():
        layers = []
        for spec in group_layers(g):
            if spec.mixer == "mamba":
                lc = {"mamba": mamba(cfg, batch, dt)}
            else:
                window = cfg.sliding_window if spec.mixer == "swa" else 0
                lc = {"attn": attn(cfg, batch, lay["slots"], window, dt,
                                   seq=lay["ring" if window else "full"])}
            if cfg.is_encoder_decoder:
                shape = (batch, cfg.encoder_seq // (cross.n if cross else 1),
                         cache_heads(cfg, tp, cross), cfg.head_dim)
                lc["cross"] = {"ck": zeros(shape), "cv": zeros(shape)}
            layers.append(lc)
        groups.append({"layers": layers})
    return {"groups": groups}
