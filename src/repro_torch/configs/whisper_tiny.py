"""whisper-tiny [audio]: encoder-decoder, 4+4L d_model=384 6H (kv=6)
d_ff=1536 vocab=51865 (arXiv:2212.04356).

The conv frontend is a stub: prefill takes precomputed frame embeddings
(B, 1500, 384). Decoder self-attention is causal with a K/V cache; the
cross-attention K/V are projected once at prefill and cached. Gated-SiLU
MLPs and RoPE stand in for Whisper's GELU MLPs and learned positions, as in
the reference. The same model as ``src/repro/configs/whisper_tiny.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6, n_kv_heads=6, head_dim=64,
    d_ff=1536,
    vocab=51_865,
    is_encoder_decoder=True,
    n_encoder_layers=4,
    encoder_seq=1500,
    tie_embeddings=True,
    train_microbatch_size=16,
    notes="heads=6 not divisible by model axis 16 -> attention replicated "
          "over 'model'; mlp dim 1536 shards (96/shard).",
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128,
    vocab=256,
    is_encoder_decoder=True,
    n_encoder_layers=2,
    encoder_seq=32,
    tie_embeddings=True,
    remat=False,
)
