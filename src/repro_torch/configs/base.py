"""Model configs: layer pattern, grouping and the registry.

The PyTorch counterpart of ``src/repro/configs/base.py``. ``ModelConfig``
keeps the reference's fields that the ported models and the layer pattern
read, with the same defaults and derived pattern (``layer_specs``,
``groups``, ``q_per_kv``), so a config means the same model in both
packages, the training fields (``opt_state_dtype``, ``remat``,
``train_microbatch_size``) and the sharding rules (``sharding_rules``
over :data:`DEFAULT_RULES`, resolved by :func:`rules_for`) included, and the
dry run's knobs (``use_flash_kernel``, ``notes``).

Shapes are the reference's four (seq_len, global_batch) cells
(:data:`LM_SHAPES`); :func:`shapes_for` lists an architecture's cells,
the 500k-token decode only where :func:`long_context_ok`.

The registry resolves every architecture of the reference.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.division_modes import DivisionConfig

__all__ = ["MIXERS", "FFNS", "LayerSpec", "Group", "ModelConfig", "ShapeConfig",
           "LM_SHAPES", "SUBQUADRATIC_FAMILIES", "long_context_ok", "shapes_for",
           "ARCH_IDS", "PORTED_ARCHS", "canon", "get_config", "get_smoke_config",
           "DEFAULT_RULES", "rules_for"]

MIXERS = ("attn", "swa", "mamba")
FFNS = ("dense", "moe", "none")


@dataclass(frozen=True)
class LayerSpec:
    mixer: str
    ffn: str

    def __post_init__(self):
        if self.mixer not in MIXERS or self.ffn not in FFNS:
            raise ValueError(f"bad layer spec {self.mixer}/{self.ffn}")


@dataclass(frozen=True)
class Group:
    """``repeat`` copies of the layer ``period`` (one lax.scan in the
    reference; a Python loop here)."""

    period: Tuple[LayerSpec, ...]
    repeat: int


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # --- layer pattern ---
    attn_period: int = 1
    attn_offset: int = 0
    moe_period: int = 0
    moe_offset: int = 0
    first_dense: int = 0
    # --- attention ---
    sliding_window: int = 0
    global_every: int = 0
    rope_theta: float = 10_000.0
    # --- moe ---
    n_experts: int = 0
    experts_per_tok: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    d_ff_dense: int = 0            # dense-FFN width when it differs
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_dispatch: str = "cumsum"   # cumsum | sort | local (per batch shard)
    # --- ssm (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    d_inner: int = 0
    ssm_chunk: int = 256
    conv_width: int = 4
    # --- enc-dec ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 0           # stub frontend: precomputed frames
    # --- io ---
    embed_inputs: bool = False     # vlm stub: prefill takes embeddings
    tie_embeddings: bool = False
    # --- numerics / training ---
    param_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    norm_eps: float = 1e-6
    division: DivisionConfig = field(default_factory=lambda: DivisionConfig(mode="taylor"))
    sharding_rules: Dict[str, Optional[str]] = field(default_factory=dict)
    remat: bool = True              # recompute each block's activations in backward
    train_microbatch_size: int = 4  # sequences per data-shard per microbatch
    attn_chunk: int = 2048          # query-chunked attention threshold/size
    # --- dry run (launch/dryrun.py, launch/memmodel.py) ---
    use_flash_kernel: bool = False  # fused attention: the HBM model counts no scores
    notes: str = ""

    def layer_specs(self) -> List[LayerSpec]:
        specs = []
        for i in range(self.n_layers):
            if self.family == "ssm":
                mixer = "mamba"
            elif self.attn_period > 1:
                mixer = "attn" if i % self.attn_period == self.attn_offset else "mamba"
            elif self.sliding_window > 0 and self.global_every > 0:
                mixer = "attn" if i % self.global_every == self.global_every - 1 else "swa"
            else:
                mixer = "attn"
            if self.family == "ssm":
                ffn = "none"
            elif self.moe_period > 0 and i >= self.first_dense \
                    and i % self.moe_period == self.moe_offset:
                ffn = "moe"
            else:
                ffn = "dense"
            specs.append(LayerSpec(mixer, ffn))
        return specs

    def groups(self) -> List[Group]:
        """Greedy periodic grouping: the shortest period p for which the
        pattern (after ``first_dense`` leading layers) is p-periodic."""
        specs = self.layer_specs()
        lead, rest = specs[: self.first_dense], specs[self.first_dense:]
        out: List[Group] = [Group(tuple(lead), 1)] if lead else []
        m = len(rest)
        for p in range(1, m + 1):
            if m % p == 0 and all(rest[i] == rest[i % p] for i in range(m)):
                out.append(Group(tuple(rest[:p]), m // p))
                return out
        out.append(Group(tuple(rest), 1))
        return out

    @property
    def dense_ff(self) -> int:
        return self.d_ff_dense or self.d_ff

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


LM_SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

# Architectures whose every attention layer is full attention skip
# long_500k; SSM, hybrid and mostly-sliding-window ones run it.
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def long_context_ok(cfg: ModelConfig) -> bool:
    if cfg.family in SUBQUADRATIC_FAMILIES:
        return True
    return cfg.sliding_window > 0 and cfg.global_every > 0


def shapes_for(cfg: ModelConfig) -> List[ShapeConfig]:
    out = [LM_SHAPES["train_4k"], LM_SHAPES["prefill_32k"], LM_SHAPES["decode_32k"]]
    if long_context_ok(cfg):
        out.append(LM_SHAPES["long_500k"])
    return out


ARCH_IDS = [
    "mamba2_780m", "granite_8b", "llama3_8b", "gemma3_12b", "tinyllama_1_1b",
    "llava_next_mistral_7b", "whisper_tiny", "jamba_1_5_large",
    "moonshot_v1_16b_a3b", "deepseek_moe_16b", "paper_fpdiv",
]
# Every module each architecture runs is ported.
PORTED_ARCHS = list(ARCH_IDS)


def canon(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def _module(arch: str):
    name = canon(arch)
    if name not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE_CONFIG


# Default logical-axis -> mesh-axis rules; an arch's ``sharding_rules``
# override them axis by axis.
DEFAULT_RULES: Dict[str, Optional[str]] = {
    "embed": None,
    "heads": "model",
    "kv_heads": "model",      # dropped automatically when not divisible
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,
    "ssm_inner": "model",
    "ssm_heads": "model",
    "ssm_state": None,
    "conv": None,
    "layers": None,
}


def rules_for(cfg: ModelConfig) -> Dict[str, Optional[str]]:
    rules = dict(DEFAULT_RULES)
    rules.update(cfg.sharding_rules)
    return rules
