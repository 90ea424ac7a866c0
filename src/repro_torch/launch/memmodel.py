"""Analytic HBM-traffic model for the memory term of the roofline.

The port of ``src/repro/launch/memmodel.py``, formula for formula: given
the same config, shape and mesh shape, :func:`hbm_traffic` returns the
reference's dict, key for key. It models what crosses HBM per device per
step:

  weights      local shard read per microbatch (x2 for backward), plus
               gather-write+read for FSDP ('data'-sharded) leaves
  grads        f32 accumulator read+write per microbatch
  optimizer    param rw + m/v rw + grad read, once per step
  activations  per-layer tensor traffic (residuals, projections, FFN/MoE
               buffers, SSD chunk tensors); train multiplies by 4
               (fwd 1 + bwd 2 + remat recompute 1)
  scores       attention probability matrices (and the SSD chunk scores),
               counted only when ``fused_attention`` is False
  kv cache     decode: full local cache read + one-token write
  logits       f32 logits write/read for CE loss (+ grad) / sampling

On the H100: the port's models materialise the f32 scores and run the
softmax kernel on them, so the score term is real traffic there. A fused
attention kernel (``kernels/flash_attention.py``, ``cfg.use_flash_kernel``)
keeps a block's scores in shared memory and registers, where the
reference's TPU kernel kept them in VMEM; either way they never reach HBM,
and the term is 0.

The shardings are the config's specs (``sharding/rules.spec_for`` over
``rules_for(cfg)``) on ``mesh``: a ``DeviceMesh`` or any object whose
``.shape`` maps axis names to sizes. With the reference's rules the model
says what the reference's layout would move: leaves on ``model`` and the
FSDP leaves on ``data`` (jamba's, deepseek's and moonshot's ``embed`` and
``experts``, even at ``model = 1``) count as local shards. The port's
program keeps every parameter replicated (ROADMAP Queue 1 item 18), so
the dry run passes a config whose rules replicate them
(``dryrun.replicated``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch import tree
from repro_torch.configs.base import ModelConfig, ShapeConfig, rules_for
from repro_torch.models.params import model_specs, torch_dtype
from repro_torch.sharding.rules import mesh_shape, spec_for

__all__ = ["hbm_traffic"]


def _axis_size(mesh, name):
    return mesh_shape(mesh).get(name, 1)


def _itemsize(name: str) -> int:
    return torch_dtype(name).itemsize


def _param_traffic(cfg: ModelConfig, mesh, n_micro: int, kind: str) -> Dict:
    """Weight-read / grad / optimizer traffic from the actual shardings."""
    rules = rules_for(cfg)
    w_read = 0.0      # per microbatch
    count_local = 0.0
    pbytes = _itemsize(cfg.param_dtype)
    sbytes = _itemsize(cfg.opt_state_dtype)
    for p in tree.leaves(model_specs(cfg)):
        s = spec_for(p.shape, p.axes, rules, mesh)
        shard_factor = 1
        data_sharded = False
        for part in s:
            if part is None:
                continue
            for ax in (part if isinstance(part, tuple) else (part,)):
                shard_factor *= _axis_size(mesh, ax)
                if ax in ("data", "pod"):
                    data_sharded = True
        n_local = int(np.prod(p.shape)) / shard_factor
        count_local += n_local
        lb = n_local * (_itemsize(p.dtype) if p.dtype else pbytes)
        w_read += lb
        if data_sharded:
            # FSDP: all-gather writes + reads the model-sharded-only tensor
            w_read += 2 * lb * (shard_factor // _prod_model(mesh, s))
    if kind == "train":
        weights = w_read * n_micro * 2          # fwd + bwd weight reads
        grads = count_local * 4 * 2 * n_micro   # f32 accumulator rw
        opt = count_local * (2 * pbytes + 4 * sbytes + 4)
    else:
        weights = w_read
        grads = 0.0
        opt = 0.0
    return {"weights": weights, "grads": grads, "opt": opt}


def _prod_model(mesh, spec):
    f = 1
    for part in spec:
        if part is None:
            continue
        for ax in (part if isinstance(part, tuple) else (part,)):
            if ax == "model":
                f *= _axis_size(mesh, ax)
    return f


def hbm_traffic(cfg: ModelConfig, shape: ShapeConfig, mesh, *, n_micro: int = 1,
                fused_attention: bool = False) -> Dict:
    """Per-device, per-step HBM bytes, with component breakdown."""
    M = _axis_size(mesh, "model")
    D = _axis_size(mesh, "data") * _axis_size(mesh, "pod")
    B, S = shape.global_batch, shape.seq_len
    kind = "train" if shape.kind == "train" else "inference"
    act_mult = 4.0 if kind == "train" else 1.0   # fwd + 2 bwd + 1 remat
    bf2 = 2.0

    batch_local = max(1, B // D) if B >= D else B  # batch=1: replicated
    if shape.kind == "decode":
        t = batch_local * 1                       # tokens/device/step
        s_kv = S                                  # cache length attended
    else:
        t = batch_local * S / max(1, n_micro) if kind == "train" \
            else batch_local * S
        s_kv = S
    d = cfg.d_model

    pt = _param_traffic(cfg, mesh, n_micro, kind)

    acts = 0.0
    scores = 0.0
    cache = 0.0

    def _loc(n, m):
        """Local share: n/m when shardable, else replicated (full n)."""
        return n / m if (n and n % m == 0) else n

    for spec in cfg.layer_specs():
        # residual stream + norms: ~8 x (t, d) bf16 accesses
        a = 8 * t * d * bf2
        if spec.mixer == "mamba":
            din_loc = _loc(cfg.d_inner, M)
            h_loc = _loc(cfg.ssm_heads, M)
            q = min(cfg.ssm_chunk, S)
            a += 6 * t * din_loc * bf2 + 4 * t * cfg.ssm_state * bf2
            # SSD intra-chunk decay/score tensors: (nc, q, q) per head local
            if shape.kind != "decode":
                scores_l = 4 * h_loc * t * q * 4.0
                scores += scores_l if not fused_attention else 0.0
            else:
                cache += h_loc * cfg.ssm_head_dim * cfg.ssm_state * 4 * 2 \
                    * batch_local
            a += 2 * t * din_loc * bf2  # gated norm + out proj activations
        else:
            h_loc = _loc(cfg.n_heads, M)
            kv_loc = _loc(cfg.n_kv_heads, M)
            hd = cfg.head_dim
            a += (2 * t * h_loc * hd + 4 * t * kv_loc * hd) * bf2
            window = cfg.sliding_window if spec.mixer == "swa" else 0
            s_att = min(window, s_kv) * 2 if window else s_kv
            if shape.kind == "decode":
                L = min(window, S) if window else S
                if cfg.sharding_rules.get("__kv_seq_shard__"):
                    L = L / M  # flash-decoding: cache seq sharded over model
                cache += 2 * batch_local * L * kv_loc * hd * bf2  # k+v read
                scores += (0 if fused_attention else
                           4 * batch_local * h_loc * L * 4.0)
            else:
                scores += (0 if fused_attention else
                           4 * h_loc * t * s_att * 4.0)
        if spec.ffn == "dense":
            f_loc = _loc(cfg.dense_ff, M)
            a += (4 * t * f_loc + 2 * t * d) * bf2
        elif spec.ffn == "moe":
            E, k = cfg.n_experts, cfg.experts_per_tok
            f_loc = _loc(cfg.d_ff_expert, M)
            # dispatched tokens per device ~ t*k (capacity ~1.25)
            a += 2 * t * k * d * bf2 * 1.25          # dispatch + combine
            a += 4 * t * k * f_loc * bf2 * 1.25      # expert MLP acts
            a += t * E * 4.0                         # router logits f32
            if cfg.n_shared_experts:
                a += 4 * t * cfg.n_shared_experts * f_loc * bf2
        acts += a
    # t was per-microbatch for train: scale to the full step
    acts *= act_mult * (n_micro if kind == "train" else 1)
    scores *= act_mult * (n_micro if kind == "train" else 1)

    v_loc = _loc(cfg.vocab, M)
    logits = (3 if kind == "train" else 1) * t * v_loc * 4.0
    if kind == "train":
        logits *= n_micro

    total = (pt["weights"] + pt["grads"] + pt["opt"] + acts + scores + cache
             + logits)
    return {
        "weights_bytes": pt["weights"], "grads_bytes": pt["grads"],
        "opt_bytes": pt["opt"], "activation_bytes": acts,
        "score_bytes": scores, "cache_bytes": cache, "logits_bytes": logits,
        "fused_attention": fused_attention,
        "total_bytes": total,
    }
