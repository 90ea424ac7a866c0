"""llava-next-mistral-7b [vlm]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, the language backbone.

The vision tower is a stub: prefill takes precomputed patch and text
embeddings (B, S, d_model); decode reads generated tokens through the
text embedding table, which the model keeps. The untied lm_head maps
d_model to 32000. The same model as
``src/repro/configs/llava_next_mistral_7b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14_336,
    vocab=32_000,
    embed_inputs=True,
    train_microbatch_size=4,
)

SMOKE_CONFIG = ModelConfig(
    name="llava-smoke",
    family="vlm",
    n_layers=3,
    d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128,
    vocab=256,
    embed_inputs=True,
    remat=False,
)
