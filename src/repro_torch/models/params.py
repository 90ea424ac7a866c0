"""Parameter specs and concrete init for every block: attention, Mamba-2,
cross attention, dense and MoE FFNs, and the encoder.

The PyTorch counterpart of ``src/repro/models/params.py``. Parameters are a
plain dict tree with the reference's grouping, ``{"embed", "groups":
[{"layers": [...]}], "final_norm", "lm_head", "encoder": {"groups",
"final_norm"}}``, except that a group's ``repeat`` copies are separate
entries of ``layers`` (index ``r * period + i``) instead of leaves stacked
on a leading axis: the port loops over layers where the reference scans.
``convert.params_from_reference`` maps one layout onto the other. Each
spec carries the leaf's logical axes (``axes``, read by
``sharding/rules.py``): the reference's, less its stacked ``layers`` axis.

``abstract_params`` gives the tree's stand-ins (shape and dtype, no
storage: ``meta`` tensors, or a ``FakeTensorMode``'s on a device) that the
dry run traces the programs on, as the reference's ``ShapeDtypeStruct``
tree. ``init_params`` draws from a ``torch.Generator`` with the
reference's scales and dtypes. The two packages' random streams differ (and the reference's
per-leaf key hashes the leaf's path with a per-process salt), so equal
parameters come from the converter, never from equal seeds.

With ``shardings`` (``sharding.rules.param_shardings``) both give each
rank its block only: ``init_params`` draws every leaf's global values from
the generator, one leaf at a time, and keeps the rank's block as a DTensor
(the same values on every rank, without the whole tree on any);
``abstract_params`` gives stand-ins of the block's shape.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs.base import LayerSpec, ModelConfig

__all__ = ["ParamSpec", "model_specs", "logical_axes", "init_params", "abstract_params",
           "param_count", "active_param_count", "torch_dtype"]


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axes (sharding/rules.py)
    init: str = "normal"           # normal | zeros | ones
    scale: Optional[float] = None  # stddev for normal; default 1/sqrt(shape[0])
    dtype: Optional[str] = None    # overrides cfg.param_dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")

    @property
    def expert(self) -> bool:
        """A routed expert's leaf (it carries the 'experts' axis)."""
        return "experts" in self.axes


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _attn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s_in, s_out = 1.0 / np.sqrt(d), 1.0 / np.sqrt(H * hd)
    return {"wq": ParamSpec((d, H, hd), ("embed", "heads", "head_dim"), scale=s_in),
            "wk": ParamSpec((d, KV, hd), ("embed", "kv_heads", "head_dim"), scale=s_in),
            "wv": ParamSpec((d, KV, hd), ("embed", "kv_heads", "head_dim"), scale=s_in),
            "wo": ParamSpec((H, hd, d), ("heads", "head_dim", "embed"), scale=s_out)}


def _mlp_specs(cfg: ModelConfig, d_ff: int) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    return {"wi": ParamSpec((d, d_ff), ("embed", "mlp"), scale=1.0 / np.sqrt(d)),
            "wg": ParamSpec((d, d_ff), ("embed", "mlp"), scale=1.0 / np.sqrt(d)),
            "wo": ParamSpec((d_ff, d), ("mlp", "embed"), scale=1.0 / np.sqrt(d_ff))}


def _moe_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    out: Dict[str, Any] = {
        "router": ParamSpec((d, E), ("embed", None), scale=1.0 / np.sqrt(d),
                            dtype="float32"),
        "wi": ParamSpec((E, d, f), ("experts", "embed", "expert_mlp"), scale=1.0 / np.sqrt(d)),
        "wg": ParamSpec((E, d, f), ("experts", "embed", "expert_mlp"), scale=1.0 / np.sqrt(d)),
        "wo": ParamSpec((E, f, d), ("experts", "expert_mlp", "embed"), scale=1.0 / np.sqrt(f))}
    if cfg.n_shared_experts:
        out["shared"] = _mlp_specs(cfg, cfg.n_shared_experts * cfg.d_ff_expert)
    return out


def _mamba_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, din, n, h, w = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.conv_width
    s = 1.0 / np.sqrt(d)
    return {"wz": ParamSpec((d, din), ("embed", "ssm_inner"), scale=s),
            "wx": ParamSpec((d, din), ("embed", "ssm_inner"), scale=s),
            "wB": ParamSpec((d, n), ("embed", "ssm_state"), scale=s),
            "wC": ParamSpec((d, n), ("embed", "ssm_state"), scale=s),
            "wdt": ParamSpec((d, h), ("embed", "ssm_heads"), scale=s),
            "conv_x": ParamSpec((w, din), ("conv", "ssm_inner"), scale=1.0 / np.sqrt(w)),
            "conv_B": ParamSpec((w, n), ("conv", "ssm_state"), scale=1.0 / np.sqrt(w)),
            "conv_C": ParamSpec((w, n), ("conv", "ssm_state"), scale=1.0 / np.sqrt(w)),
            "A_log": ParamSpec((h,), ("ssm_heads",), init="zeros", dtype="float32"),
            "D": ParamSpec((h,), ("ssm_heads",), init="ones", dtype="float32"),
            "dt_bias": ParamSpec((h,), ("ssm_heads",), init="zeros", dtype="float32"),
            "norm": ParamSpec((din,), ("ssm_inner",), init="ones", dtype="float32"),
            "wout": ParamSpec((din, d), ("ssm_inner", "embed"), scale=1.0 / np.sqrt(din))}


def _norm(cfg: ModelConfig) -> ParamSpec:
    return ParamSpec((cfg.d_model,), ("embed",), init="ones", dtype="float32")


def _block_specs(cfg: ModelConfig, spec: LayerSpec, cross: bool = False) -> Dict[str, Any]:
    """A block: its mixer (attention or Mamba), the cross attention of an
    encoder-decoder's decoder, and its FFN unless ``ffn == "none"``."""
    out: Dict[str, Any] = {"mixer_norm": _norm(cfg)}
    if spec.mixer == "mamba":
        out["mamba"] = _mamba_specs(cfg)
    else:
        out["attn"] = _attn_specs(cfg)
    if cross:
        out["cross_norm"] = _norm(cfg)
        out["cross"] = _attn_specs(cfg)
    if spec.ffn != "none":
        out["ffn_norm"] = _norm(cfg)
        out["ffn"] = (_moe_specs(cfg) if spec.ffn == "moe"
                      else _mlp_specs(cfg, cfg.dense_ff))
    return out


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The spec tree of a model. A VLM keeps its text embedding table
    (decode reads generated tokens; only prefill takes embeddings); an
    encoder-decoder adds ``n_encoder_layers`` attention/dense blocks and
    their final norm under ``encoder``."""
    d, V = cfg.d_model, cfg.vocab
    out: Dict[str, Any] = {}
    if not cfg.embed_inputs or cfg.is_encoder_decoder or cfg.family == "vlm":
        out["embed"] = ParamSpec((V, d), ("vocab", "embed"), scale=1.0)
    out["groups"] = [{"layers": [_block_specs(cfg, s, cross=cfg.is_encoder_decoder)
                                 for _ in range(g.repeat) for s in g.period]}
                     for g in cfg.groups()]
    out["final_norm"] = _norm(cfg)
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamSpec((d, V), ("embed", "vocab"), scale=1.0 / np.sqrt(d))
    if cfg.is_encoder_decoder:
        enc = LayerSpec("attn", "dense")
        out["encoder"] = {"groups": [{"layers": [_block_specs(cfg, enc)
                                                 for _ in range(cfg.n_encoder_layers)]}],
                          "final_norm": _norm(cfg)}
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None, shardings=None):
    """Concrete init on the generator's device (or ``device``): normal(0, 1)
    in f32 times the spec's scale, then cast, as the reference does. With
    ``shardings`` (a NamedSharding tree) each leaf is the DTensor of the
    rank's block of those values."""
    from repro_torch.sharding import rules as shr

    device = generator.device if device is None else torch.device(device)

    def leaf(p: ParamSpec, sh=None):
        dt = torch_dtype(p.dtype or cfg.param_dtype)
        if p.init == "zeros":
            x = torch.zeros(p.shape, dtype=dt, device=device)
        elif p.init == "ones":
            x = torch.ones(p.shape, dtype=dt, device=device)
        else:
            scale = p.scale if p.scale is not None else 1.0 / np.sqrt(p.shape[0])
            x = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                            device=generator.device)
            x.mul_(np.float32(scale))
        if sh is None:
            return x.to(device=device, dtype=dt)
        # The block alone stays, cast from the f32 draw: a copy, so the
        # global draw is freed, and no cast of the whole leaf is made.
        return _dtensor(shr.local_block(x, sh).to(device=device, dtype=dt, copy=True), sh)

    if shardings is None:
        return tree.map_tree(leaf, model_specs(cfg))
    return tree.map_tree(leaf, model_specs(cfg), shardings)


def _dtensor(block: torch.Tensor, sh):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(block, sh.mesh, sh.placements, run_check=False)


def abstract_params(cfg: ModelConfig, device=None, fake_mode=None, shardings=None):
    """The parameter tree as stand-ins that allocate nothing
    (:func:`repro_torch.tree.abstract`): ``meta`` tensors, or ``fake_mode``'s
    fake tensors on ``device``; with ``shardings``, of the shape of one
    rank's block."""
    from repro_torch.sharding import rules as shr

    def leaf(p: ParamSpec, sh=None):
        shape = p.shape if sh is None else shr.local_shape(p.shape, sh)
        return tree.abstract(shape, torch_dtype(p.dtype or cfg.param_dtype), device, fake_mode)

    if shardings is None:
        return tree.map_tree(leaf, model_specs(cfg))
    return tree.map_tree(leaf, model_specs(cfg), shardings)


def logical_axes(cfg: ModelConfig):
    """Each parameter's logical axes, in the port's tree layout: the
    reference's with its stacked ``layers`` axis left out."""
    return tree.map_tree(lambda p: p.axes, model_specs(cfg))


def _leaves(cfg: ModelConfig):
    return tree.leaves(model_specs(cfg))


def param_count(cfg: ModelConfig) -> int:
    return sum(int(np.prod(p.shape)) for p in _leaves(cfg))


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: the top-k routed experts and the
    shared ones), reckoned as the reference reckons it."""
    total = param_count(cfg)
    if not cfg.n_experts:
        return total
    expert_total = sum(int(np.prod(p.shape)) for p in _leaves(cfg) if p.expert)
    frac = cfg.experts_per_tok / cfg.n_experts
    return int(total - expert_total * (1.0 - frac))
