"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (kv=16) vocab=163840;
2 shared + 64 routed experts of d_ff 1408, top-6, the first layer dense
(d_ff 11264), per the Moonlight architecture
(hf:moonshotai/Moonlight-16B-A3B).

With 48 layers this totals ~28B parameters rather than the 16B the name
suggests; the reference follows the assigned spec and so does the port.
The same model as ``src/repro/configs/moonshot_v1_16b_a3b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408,
    vocab=163_840,
    moe_period=1, moe_offset=0,
    first_dense=1,
    n_experts=64, experts_per_tok=6,
    n_shared_experts=2,
    d_ff_expert=1408,
    d_ff_dense=11_264,
    train_microbatch_size=4,
    sharding_rules={"experts": "data", "expert_mlp": "model"},
)

SMOKE_CONFIG = ModelConfig(
    name="moonshot-smoke",
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
