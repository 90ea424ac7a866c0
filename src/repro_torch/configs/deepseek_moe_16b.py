"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (kv=16) vocab=102400;
2 shared + 64 routed experts of d_ff 1408, top-6, fine-grained
(arXiv:2401.06066).

The first layer is dense (d_ff 10944), the other 27 are MoE: ~16.4B
parameters, ~2.8B active per token. The same model as
``src/repro/configs/deepseek_moe_16b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408,
    vocab=102_400,
    moe_period=1, moe_offset=0,
    first_dense=1,
    n_experts=64, experts_per_tok=6,
    n_shared_experts=2,
    d_ff_expert=1408,
    d_ff_dense=10_944,
    train_microbatch_size=4,
    sharding_rules={"experts": "data", "expert_mlp": "model"},
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=64,
    vocab=512,
    moe_period=1, moe_offset=0,
    first_dense=1,
    n_experts=8, experts_per_tok=2,
    n_shared_experts=2,
    d_ff_expert=64,
    d_ff_dense=128,
    remat=False,
)
