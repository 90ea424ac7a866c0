"""Serving engine: prefill + batched greedy decode with per-layer-kind caches.

The PyTorch counterpart of ``src/repro/serving/engine.py``: full-length K/V
for global attention layers, W-slot ring caches for sliding-window layers,
the O(1) SSM state and conv windows for Mamba layers, and an
encoder-decoder's cross K/V. Eager PyTorch takes the place of ``jax.jit``;
attention K/V and inserted rows are written in place (the reference
rebuilds them) while a Mamba layer's state is replaced each step, so after
:func:`decode_step` read the cache it returns.

Padded-prompt correctness: prompts of unequal length are right-padded to a
multiple of the window and the SSM chunk (the block-local attention's and
the chunked scan's alignment), but padding never leaks into the output:
prefill gathers each request's logit at ``len(prompt) - 1``, keeps pad
tokens out of the rings and makes them SSM no-ops (``lengths``), and
decode runs at per-request positions, so request i's token t lands at
absolute position ``len(prompt_i) + t`` and attends to nothing above it.
``generate_batch`` is therefore token-identical to single-request
``generate`` (where the matmuls do not depend on the batch's shape, as on
the CPU in f32, and where MoE capacity drops nothing: pad tokens take
capacity, as in the reference).

Embedding-input (VLM) configs prefill from ``embeds`` and encoder-decoder
configs from ``enc_embeds`` plus token prompts, through
``generate_batch`` / ``generate``; ``serve()`` refuses both, as the
reference does.

Under an active mesh that splits some leaf -- a ``model`` axis above 1,
or the experts on ``data`` (``sharding.rules.use_mesh``) -- the engine runs
the split model
(``models/parallel.py``): each rank holds its vocab block of the logits
and its KV heads of the cache, and the greedy choice is a split argmax
(the largest logit over the ranks, on ties the lowest vocab index, as
``torch.argmax`` takes it). Every rank is given the whole batch: under the
MoE models' ``experts -> data`` each rank routes every token, runs its own
experts' rows and the partial outputs are summed over ``data``
(``models/moe.py``), so the batch is the reference's global one and the
greedy argmax is unchanged. Where the cache's layout puts a K/V leaf's
sequence on an axis (``kvseq``, or ``data`` for a batch-1 long context:
``models.make_cache``), a prefill's cache is cut to the rank's block of
the slots (``convert.cache_block``) in place of :func:`pad_cache_to`, and
decode combines the softmax over that axis.

``ServingEngine.serve`` is the continuous-batching loop: admit a request
into a free slot (single-row prefill + cache row insert), decode all active
slots in lockstep, release on EOS / ``max_new``, refill from the queue. The
division unit is a serving knob (``division=``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.division_modes import DivisionConfig
from repro_torch.models import forward, make_cache
from repro_torch.models.model import group_layers
from repro_torch.models.parallel import AXIS, local_params, tensor_parallel

__all__ = ["alignment", "prefill", "decode_step", "pad_cache_to", "greedy", "Request",
           "ServingEngine"]


def alignment(cfg: ModelConfig) -> int:
    """Prompt lengths pad to a multiple of this: the window, which the
    block-local sliding attention needs, and for SSM and hybrid models its
    lcm with ``ssm_chunk``, which the chunked scan needs."""
    a = cfg.sliding_window if cfg.sliding_window else 1
    if cfg.family in ("ssm", "hybrid"):
        a = math.lcm(a, cfg.ssm_chunk)
    return a


def prefill(cfg: ModelConfig, params, tokens, *, enc_embeds=None, embeds=None,
            lengths=None):
    """Returns (last_logits (B, V), cache). Seq must respect the alignment.
    Embedding-input configs prefill from ``embeds`` (B, S, d_model),
    encoder-decoders from ``tokens`` and ``enc_embeds`` (B, encoder_seq,
    d_model). With per-request ``lengths`` the logits are gathered at each
    request's last real position ``lengths[i] - 1`` and pad positions are
    masked out of the caches; without, the final position is used."""
    kw = {"enc_embeds": enc_embeds} if cfg.is_encoder_decoder else {}
    if cfg.embed_inputs and not cfg.is_encoder_decoder:
        kw["embeds"] = embeds
    else:
        kw["tokens"] = tokens
    logits, cache, _ = forward(cfg, params, mode="prefill", lengths=lengths, **kw)
    if lengths is None:
        return logits[:, -1], cache
    lv = torch.as_tensor(lengths, device=logits.device).long()
    return logits[torch.arange(logits.shape[0], device=logits.device), lv - 1], cache


def decode_step(cfg: ModelConfig, params, cache, tokens, pos):
    """One decode step. tokens: (B, 1); pos: scalar or per-request (B,)
    vector of absolute positions. -> (logits (B, V), cache)."""
    logits, new_cache, _ = forward(cfg, params, tokens=tokens, cache=cache,
                                   pos=pos, mode="decode")
    return logits[:, 0], new_cache


def pad_cache_to(cache, from_len: int, to_len: int, cfg: ModelConfig):
    """Grow the full-attention K/V caches from ``from_len`` to ``to_len``
    slots along the sequence axis (axis -3), chosen by walking the cache
    beside ``cfg.groups()``: only ``attn`` layers' K/V are padded;
    sliding-window rings keep their W slots, even where W == from_len, and
    SSM state, conv windows and cross K/V pass through."""
    if to_len < from_len:
        raise ValueError(f"pad_cache_to: to_len {to_len} < from_len {from_len}")
    if to_len == from_len:
        return cache

    def pad(a):
        tail = torch.zeros((*a.shape[:-3], to_len - from_len, *a.shape[-2:]),
                           dtype=a.dtype, device=a.device)
        return torch.cat([a, tail], dim=-3)

    new_groups = []
    for g, gc in zip(cfg.groups(), cache["groups"]):
        layers = []
        for spec, lc in zip(group_layers(g), gc["layers"]):
            lc = dict(lc)
            if spec.mixer == "attn" and "attn" in lc:
                lc["attn"] = {k: pad(v) for k, v in lc["attn"].items()}
            layers.append(lc)
        new_groups.append({"layers": layers})
    return {"groups": new_groups}


def greedy(logits, tp=None) -> torch.Tensor:
    """The greedy tokens (B, 1) int32 of ``logits`` (B, V): ``torch.argmax``,
    or over a vocab split (``tp``) the largest of the ranks' maxima, the
    lowest global index on ties (each rank's first maximum, the first
    rank's among equal ones)."""
    if tp is None or not tp.vocab:
        return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    from repro_torch.sharding import comm

    idx = torch.argmax(logits, dim=-1)
    val = torch.gather(logits, -1, idx[:, None])[:, 0]
    glob = idx + tp.vocab_offset(logits.shape[-1])
    # f32 values and int indices below 2^53 are exact in f64: one gather.
    pairs = comm.all_gather(torch.stack([val.to(torch.float64), glob.to(torch.float64)])[None],
                            tp.mesh, (AXIS,))                              # (ranks, 2, B)
    best = torch.argmax(pairs[:, 0], dim=0)                             # first rank of the max
    return pairs[best, 1, torch.arange(pairs.shape[2], device=pairs.device)].to(
        torch.int32)[:, None]


def _insert_cache_row(cache, row, slot: int, cfg: ModelConfig):
    """Write single-request cache ``row`` (batch 1) into batch slot ``slot``,
    in place (the batch axis is 0 in every leaf: layers are not stacked).
    Full-attention rows arrive grown to ``max_len``, rings at W, SSM state
    and conv windows at their fixed sizes: those of the batch cache's
    leaves."""
    for gc, rc in zip(cache["groups"], row["groups"]):
        for lc, lr in zip(gc["layers"], rc["layers"]):
            for kind, leaves in lc.items():
                for name, a in leaves.items():
                    a[slot] = lr[kind][name][0].to(a.dtype)
    return cache


@dataclasses.dataclass
class Request:
    tokens: List[int]
    max_new: int = 32
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    """Greedy-decoding engine: static batching (``generate`` /
    ``generate_batch``) and continuous batching (``serve``).

    ``division`` swaps the division unit the whole path runs on; ``eos_id``
    enables early stop on that token. Work runs on the parameters' device.
    """

    def __init__(self, cfg: ModelConfig, params, *, max_len: int = 256,
                 division: Optional[DivisionConfig] = None,
                 eos_id: Optional[int] = None):
        if division is not None:
            cfg = dataclasses.replace(cfg, division=division)
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.eos_id = eos_id
        self.device = params["embed"].device
        self._local = None      # (plan, the rank's blocks of params)

    def _params(self):
        """The parameters as the model reads them: under a tensor-parallel
        plan the rank's blocks, taken once per plan."""
        tp = tensor_parallel(self.cfg)
        if tp is None:
            return self.params
        if self._local is None or self._local[0] is not tp:
            self._local = (tp, local_params(self.cfg, self.params, tp))
        return self._local[1]

    def _prefill_tok(self, tokens, lengths):
        return prefill(self.cfg, self._params(), tokens, lengths=lengths)

    def _prefill_emb(self, embeds, lengths):
        return prefill(self.cfg, self._params(), None, embeds=embeds, lengths=lengths)

    def _prefill_enc(self, tokens, enc_embeds, lengths):
        return prefill(self.cfg, self._params(), tokens, enc_embeds=enc_embeds,
                       lengths=lengths)

    def _fit(self, cache, from_len: int, batch: int):
        """A prefill's cache grown to ``max_len`` slots; under an active
        mesh, the rank's blocks of it (``convert.cache_block``) for a decode
        batch of ``batch`` rows."""
        from repro_torch.sharding import rules as shr

        mesh = shr.active_mesh()
        if mesh is None:
            return pad_cache_to(cache, from_len, self.max_len, self.cfg)
        from repro_torch.convert import cache_block

        return cache_block(cache, self.cfg, mesh, max_len=self.max_len, batch=batch)

    def _decode(self, cache, tokens, pos):
        return decode_step(self.cfg, self._params(), cache, tokens, pos)

    @property
    def _align(self) -> int:
        return alignment(self.cfg)

    def _pad_to(self, s_max: int) -> int:
        return -(-s_max // self._align) * self._align

    def _check_fits(self, s_max: int, max_new: int, pad_to: int):
        need = max(pad_to, s_max + max_new)
        if need > self.max_len:
            raise ValueError(
                f"prompt ({s_max}) + max_new ({max_new}) needs {need} cache "
                f"slots but max_len is {self.max_len}")

    def _argmax(self, logits) -> torch.Tensor:
        return greedy(logits, tensor_parallel(self.cfg))

    # ----------------------------------------------------------- static batch

    def generate_batch(self, prompts, max_new: int = 32, *, enc_embeds=None,
                       embeds=None):
        """Batched requests of unequal length: right-pad to the aligned
        longest, prefill once, then decode all slots in lockstep at
        per-request positions. Returns a list of generated-token lists.

        Embedding-input (VLM) configs take ``embeds``, a list of per-request
        ``(len_i, d_model)`` arrays or tensors, in place of ``prompts``
        (decode reads the generated tokens). Encoder-decoder configs also
        take ``enc_embeds`` (B, encoder_seq, d_model)."""
        cfg = self.cfg
        vlm = cfg.embed_inputs and not cfg.is_encoder_decoder
        if vlm:
            if embeds is None:
                raise ValueError(
                    f"config '{cfg.name}' has embed_inputs=True: pass "
                    "embeds=[...(len_i, d_model) arrays] (prompt tokens have "
                    "no embedding path at prefill)")
            lens = [int(e.shape[0]) for e in embeds]
        else:
            if not prompts:
                raise ValueError("generate_batch: empty prompt list")
            if any(len(p) == 0 for p in prompts):
                raise ValueError("generate_batch: empty prompt")
            lens = [len(p) for p in prompts]
        if cfg.is_encoder_decoder and enc_embeds is None:
            raise ValueError(
                f"config '{cfg.name}' is encoder-decoder: pass "
                "enc_embeds=(B, encoder_seq, d_model)")
        B, s_max = len(lens), max(lens)
        pad_to = self._pad_to(s_max)
        self._check_fits(s_max, max_new, pad_to)
        lengths = torch.tensor(lens, dtype=torch.int32, device=self.device)
        if vlm:
            emb = torch.zeros((B, pad_to, cfg.d_model), dtype=torch.float32,
                              device=self.device)
            for i, e in enumerate(embeds):
                emb[i, :lens[i]] = torch.as_tensor(e, dtype=torch.float32)
            last_logits, cache = self._prefill_emb(emb, lengths)
        else:
            toks = np.zeros((B, pad_to), np.int64)
            for i, p in enumerate(prompts):
                toks[i, :len(p)] = p      # zero right-pad; pads are masked out
            toks = torch.from_numpy(toks).to(self.device)
            if cfg.is_encoder_decoder:
                last_logits, cache = self._prefill_enc(
                    toks, torch.as_tensor(enc_embeds, device=self.device), lengths)
            else:
                last_logits, cache = self._prefill_tok(toks, lengths)
        cache = self._fit(cache, pad_to, B)
        pos_v = lengths                   # request i's first new token: len_i
        tok = self._argmax(last_logits)
        outs: List[List[int]] = [[] for _ in range(B)]
        stopped = [False] * B
        for _ in range(max_new):
            for i, t in enumerate(tok[:, 0].tolist()):
                if not stopped[i]:
                    outs[i].append(t)
                    if self.eos_id is not None and t == self.eos_id:
                        stopped[i] = True
            if all(stopped):
                break
            logits, cache = self._decode(cache, tok, pos_v)
            tok = self._argmax(logits)
            pos_v = pos_v + 1
        return outs

    def generate(self, prompt_tokens=None, max_new: int = 32, *, enc_embeds=None,
                 embeds=None):
        """Single-request generate: the batch-of-one ``generate_batch``
        (``enc_embeds`` may come without its batch axis)."""
        if enc_embeds is not None and np.ndim(enc_embeds) == 2:
            enc_embeds = torch.as_tensor(enc_embeds)[None]
        prompts = None if prompt_tokens is None else [list(prompt_tokens)]
        embs = None if embeds is None else [embeds]
        return self.generate_batch(prompts, max_new, enc_embeds=enc_embeds,
                                   embeds=embs)[0]

    # ------------------------------------------------------ continuous batch

    def serve(self, requests: Sequence[Request], *, slots: int = 2):
        """Continuous batching: admit requests into free slots (single-row
        prefill + cache-row insert), decode all active slots in lockstep,
        release each on EOS / its own ``max_new``, refill from the queue.
        Mutates and returns the ``Request`` objects (``out``/``done``)."""
        cfg = self.cfg
        if cfg.embed_inputs and not cfg.is_encoder_decoder:
            raise ValueError(
                f"serve() prefills token prompts; embed-input config "
                f"'{cfg.name}' must use generate/generate_batch with embeds=")
        if cfg.is_encoder_decoder:
            raise ValueError(
                f"serve() does not carry per-slot encoder state; "
                f"encoder-decoder config '{cfg.name}' must use "
                "generate/generate_batch with enc_embeds=")
        for r in requests:
            if not r.tokens:
                raise ValueError("serve: empty prompt")
            self._check_fits(len(r.tokens), r.max_new, self._pad_to(len(r.tokens)))
        B = slots
        cache = make_cache(cfg, B, self.max_len, self.device)
        pos_v = np.zeros((B,), np.int32)
        cur = np.zeros((B, 1), np.int32)
        active: List[Optional[Request]] = [None] * B
        queue = list(requests)

        def admit(slot: int, req: Request):
            s = len(req.tokens)
            pad_to = self._pad_to(s)
            toks = torch.zeros((1, pad_to), dtype=torch.int64)
            toks[0, :s] = torch.tensor(req.tokens)
            last, row = self._prefill_tok(toks.to(self.device), [s])
            row = self._fit(row, pad_to, B)
            _insert_cache_row(cache, row, slot, cfg)
            cur[slot, 0] = int(self._argmax(last[:1])[0, 0])
            pos_v[slot] = s
            active[slot] = req

        while True:
            for i in range(B):
                if active[i] is None and queue:
                    admit(i, queue.pop(0))
            if not any(a is not None for a in active):
                break
            # record this step's token; release finished slots before decode
            for i in range(B):
                req = active[i]
                if req is None:
                    continue
                t = int(cur[i, 0])
                req.out.append(t)
                if len(req.out) >= req.max_new or (
                        self.eos_id is not None and t == self.eos_id):
                    req.done = True
                    active[i] = None
                    pos_v[i] = 0   # an idle slot decodes garbage at pos 0;
                    # its row is overwritten on the next admit
            if not any(a is not None for a in active) and not queue:
                break
            logits, cache = self._decode(
                cache, torch.from_numpy(cur).to(self.device),
                torch.from_numpy(pos_v).to(self.device))
            cur = self._argmax(logits).cpu().numpy()
            pos_v = pos_v + 1
        return list(requests)
