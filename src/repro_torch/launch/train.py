"""Training launcher: one process, one device, end to end.

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 20 --division-mode taylor_pallas
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper_fpdiv \\
      --steps 200 --seq-len 2048 --global-batch 32 --n-micro 2 --ckpt-dir ckpt

The port of ``src/repro/launch/train.py``: ``train.loop.run`` on
``--arch`` (its smoke config with ``--smoke``) over ``SyntheticLM`` batches
of ``--global-batch`` x ``--seq-len`` tokens from ``--seed``, in
``--n-micro`` microbatches, checkpointing to ``--ckpt-dir`` every
``--ckpt-every`` steps and resuming from its newest checkpoint. The
division flags are the serving launcher's (``--division-mode`` and the
rest); parameters live on ``--device`` (``cuda`` unless asked otherwise).
Prints ``final loss: ... after N steps``.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.launch.serve import add_division_args, division_from_args


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="paper_fpdiv", help="one of configs.ARCH_IDS")
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    add_division_args(ap)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.train.loop import LoopConfig, run

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    division = division_from_args(args, cfg.division)
    if division is not None:
        cfg = dataclasses.replace(cfg, division=division)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                          global_batch=args.global_batch, seed=args.seed)
    loop = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir, n_micro=args.n_micro, seed=args.seed)
    out = run(cfg, loop, data_cfg, device=args.device)
    print(f"final loss: {out['losses'][-1]:.4f} after {out['last_step']} steps")
    return out


if __name__ == "__main__":
    main()
