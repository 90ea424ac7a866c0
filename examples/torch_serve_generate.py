"""Serving through the PyTorch port: prefill + batched greedy decode across
cache types.

The counterpart of ``examples/serve_generate.py`` on ``repro_torch``:
generates from three architecture families (full attention, sliding-window,
SSM) and serves a batch of unequal prompts, every divide through the unit
in the config's mode. ``--device cuda`` is the default; ``--device cpu``
runs the smoke models on the CPU.

Run: PYTHONPATH=src python examples/torch_serve_generate.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import init_params
from repro_torch.serving import ServingEngine


def engine_for(arch: str, device) -> ServingEngine:
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    return ServingEngine(cfg, params, max_len=128)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    for arch in ["tinyllama_1_1b", "gemma3_12b", "mamba2_780m"]:
        engine = engine_for(arch, dev)
        out = engine.generate(list(range(1, 33)), max_new=12)
        print(f"{engine.cfg.name:18s} ({engine.cfg.family:6s}) prompt=32 toks -> {out}")

    # batched requests: one prefill + lockstep decode across 4 slots
    engine = engine_for("tinyllama_1_1b", dev)
    prompts = [list(range(1, 17)), list(range(5, 29)), list(range(40, 72)), [7, 8, 9]]
    for p, o in zip(prompts, engine.generate_batch(prompts, max_new=8)):
        print(f"batched: prompt len {len(p):2d} -> {o}")


if __name__ == "__main__":
    main()
