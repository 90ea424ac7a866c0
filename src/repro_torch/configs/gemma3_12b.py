"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) head_dim=256
d_ff=15360 vocab=262144, tied embeddings.

5:1 local:global attention: sliding window 1024 on five layers of every
six, one global layer per six, so 40 of the 48 layers decode against
W-sized ring caches. The same model as ``src/repro/configs/gemma3_12b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15_360,
    vocab=262_144,
    sliding_window=1024,
    global_every=6,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    train_microbatch_size=2,
)

SMOKE_CONFIG = ModelConfig(
    name="gemma3-smoke",
    family="dense",
    n_layers=6,
    d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128,
    vocab=512,
    sliding_window=16,
    global_every=3,
    tie_embeddings=True,
    remat=False,
)
