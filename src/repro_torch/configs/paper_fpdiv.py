"""paper-fpdiv: the paper's own demo config, a ~134M dense LM whose every
division site runs the Taylor-series unit ('paper' powering schedule, n=2 at
24 bits). The same model as ``src/repro/configs/paper_fpdiv.py``.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.division_modes import DivisionConfig

CONFIG = ModelConfig(
    name="paper-fpdiv",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=2048,
    vocab=32_000,
    division=DivisionConfig(mode="taylor", precision_bits=24, n_iters=2,
                            schedule="paper"),
    train_microbatch_size=16,
)

SMOKE_CONFIG = ModelConfig(
    name="paper-fpdiv-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128,
    vocab=256,
    division=DivisionConfig(mode="taylor", precision_bits=24, n_iters=2,
                            schedule="paper"),
    remat=False,
)
