"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16 experts top-2, Mamba:attention 7:1
(arXiv:2403.19887).

Period 8: attention at position 4 of each 8 layers, Mamba elsewhere; MoE
FFN on odd layers, dense on even. ~397B parameters, ~94B active per token.
The same model as ``src/repro/configs/jamba_1_5_large.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24_576,
    vocab=65_536,
    attn_period=8, attn_offset=4,
    moe_period=2, moe_offset=1,
    n_experts=16, experts_per_tok=2,
    d_ff_expert=24_576,
    ssm_state=128, ssm_heads=128, ssm_head_dim=128, d_inner=16_384,
    opt_state_dtype="bfloat16",
    sharding_rules={
        "embed": "data", "experts": "data", "expert_mlp": "model",
        "mlp": "model", "heads": "model", "vocab": "model",
        "ssm_inner": "model", "ssm_heads": "model",
    },
    train_microbatch_size=1,
)

SMOKE_CONFIG = ModelConfig(
    name="jamba-smoke",
    family="hybrid",
    n_layers=8,
    d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128,
    vocab=256,
    attn_period=8, attn_offset=4,
    moe_period=2, moe_offset=1,
    n_experts=4, experts_per_tok=2,
    d_ff_expert=128,
    ssm_state=16, ssm_heads=4, ssm_head_dim=16, d_inner=64,
    ssm_chunk=16,
    remat=False,
)
