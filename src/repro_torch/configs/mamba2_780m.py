"""mamba2-780m [ssm]: 48L d_model=1536, attention-free, vocab=50280,
ssm_state=128 (SSD, arXiv:2405.21060).

d_inner = 2 * d_model, head_dim 64: 48 SSM heads. Tied embeddings. The
division unit runs in the gated RMSNorm's rsqrt (and the block norms); a
pure-SSM block has no softmax. The same model as
``src/repro/configs/mamba2_780m.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0, n_kv_heads=1, head_dim=0,
    d_ff=0,
    vocab=50_280,
    ssm_state=128,
    ssm_heads=48,
    ssm_head_dim=64,
    d_inner=3072,
    tie_embeddings=True,
    train_microbatch_size=8,
    notes="attn-free; long_500k runs (O(1) state); vocab 50280 not divisible "
          "by 16 -> embedding replicated (77M bf16, 154MB).",
)

SMOKE_CONFIG = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=0, n_kv_heads=1, head_dim=0,
    d_ff=0,
    vocab=257,
    ssm_state=16,
    ssm_heads=4,
    ssm_head_dim=16,
    d_inner=64,
    ssm_chunk=16,
    tie_embeddings=True,
    remat=False,
)
