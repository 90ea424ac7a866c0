"""Training through the PyTorch port: a small LM with every division site on
the paper's unit, with checkpointing and auto-resume.

The counterpart of ``examples/train_lm.py`` on ``repro_torch``. Defaults to
a ~10M-param model; ``--arch paper_fpdiv`` trains the 134M paper demo
config. ``--division taylor_pallas`` (the default) runs the unit's Hopper
kernels on ``--device cuda`` (the default) and their plain versions on
``--device cpu``.

Run: PYTHONPATH=src python examples/torch_train_lm.py --steps 300 [--device cpu]
"""
import argparse
import dataclasses

from repro_torch.configs import ModelConfig, get_config
from repro_torch.core.division_modes import DivisionConfig
from repro_torch.data import DataConfig
from repro_torch.models import param_count
from repro_torch.train.loop import LoopConfig, run

QUICK_LM = ModelConfig(
    name="quickstart-lm-10m",
    family="dense",
    n_layers=4,
    d_model=256,
    n_heads=8, n_kv_heads=4, head_dim=32,
    d_ff=1024,
    vocab=8192,
    remat=False,
    division=DivisionConfig(mode="taylor", n_iters=2, precision_bits=24),
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="quick")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--division", default="taylor_pallas",
                    choices=["exact", "taylor", "taylor_pallas", "ilm"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = QUICK_LM if args.arch == "quick" else get_config(args.arch)
    cfg = dataclasses.replace(cfg, division=DivisionConfig(mode=args.division))
    print(f"training {cfg.name}: {param_count(cfg)/1e6:.1f}M params, "
          f"division mode = {args.division}, device = {args.device}")
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                          global_batch=args.global_batch, seed=0)
    loop = LoopConfig(total_steps=args.steps, ckpt_every=100,
                      ckpt_dir=args.ckpt_dir, log_every=20)
    out = run(cfg, loop, data_cfg, device=args.device)
    losses = out["losses"]
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f} over {out['last_step']} steps")
    if losses[-1] >= losses[0]:
        raise SystemExit("training did not improve loss")


if __name__ == "__main__":
    main()
