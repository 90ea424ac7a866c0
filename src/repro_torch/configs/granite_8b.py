"""granite-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=49152, a Llama-architecture code model (arXiv:2405.04324). The same
model as ``src/repro/configs/granite_8b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14_336,
    vocab=49_152,
    train_microbatch_size=4,
)

SMOKE_CONFIG = ModelConfig(
    name="granite-smoke",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128,
    vocab=256,
    remat=False,
)
