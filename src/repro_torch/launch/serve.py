"""Serving launcher: prefill + greedy decode, the division unit as a knob.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch paper_fpdiv \\
      --smoke --device cpu --division-mode taylor_pallas
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3_12b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_780m \\
      --smoke --device cpu

``--arch`` takes every architecture of ``configs.ARCH_IDS``, at full width
on the card or as its smoke config (``--smoke``). As the reference's
launcher, it prefills token prompts only: ``whisper_tiny`` (encoder frames)
and ``llava_next_mistral_7b`` (prompt embeddings) stop at the engine's
ValueError; ``ServingEngine.generate_batch(enc_embeds= / embeds=)`` serves
them.

``--batch 1`` runs the single-request path; ``--batch N`` runs the batched
path over N unequal-length prompts (the padded-prompt masking).
``--division-mode`` / ``--n-iters`` / ``--schedule`` swap the division unit
the whole path runs on. Parameters are drawn from ``--seed`` on
``--device`` (``cuda`` unless asked otherwise). Prints the generated tokens,
the time and the rate.
"""
from __future__ import annotations

import argparse
import dataclasses
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="paper_fpdiv",
                    help="one of configs.ARCH_IDS")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    add_division_args(ap)
    return ap


def add_division_args(ap: argparse.ArgumentParser) -> None:
    """``--division-mode`` / ``--n-iters`` / ``--schedule``: the division
    unit of the whole path (the launchers share them)."""
    ap.add_argument("--division-mode", default=None,
                    choices=["exact", "taylor", "taylor_pallas", "goldschmidt",
                             "goldschmidt_pallas", "ilm"],
                    help="division unit for every divide on the path "
                         "(default: the config's own mode)")
    ap.add_argument("--n-iters", type=int, default=None,
                    help="Taylor/Goldschmidt iteration count")
    ap.add_argument("--schedule", default=None, choices=["paper", "factored"],
                    help="Taylor evaluation schedule")


def division_from_args(args, division):
    """``division`` with the fields the division flags set; None when no
    flag is given."""
    repl = {k: v for k, v in (("mode", args.division_mode), ("n_iters", args.n_iters),
                              ("schedule", args.schedule)) if v}
    return dataclasses.replace(division, **repl) if repl else None


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine, alignment

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    division = division_from_args(args, cfg.division)
    device = torch.device(args.device)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(args.seed))
    align = alignment(cfg)
    padded_len = -(-args.prompt_len // align) * align
    engine = ServingEngine(cfg, params, division=division,
                           max_len=max(padded_len, args.prompt_len + args.max_new) + 64)
    print(f"[serve] arch={cfg.name} device={device} "
          f"division={engine.cfg.division.mode} "
          f"n_iters={engine.cfg.division.n_iters} "
          f"schedule={engine.cfg.division.schedule} batch={args.batch}")

    t0 = time.perf_counter()
    if args.batch > 1:
        # unequal-length prompts exercise the padded-prompt masking path
        prompts = [list(range(1, max(2, args.prompt_len + 1 - 3 * i)))
                   for i in range(args.batch)]
        outs = engine.generate_batch(prompts, max_new=args.max_new)
    else:
        prompts = [list(range(1, args.prompt_len + 1))]
        outs = [engine.generate(prompts[0], max_new=args.max_new)]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    for p, o in zip(prompts, outs):
        print(f"prompt({len(p)} toks) -> generated {len(o)} tokens: {o}")
    n_tok = sum(len(o) for o in outs)
    print(f"[serve] {n_tok} tokens in {dt:.2f}s (incl. kernel build) = "
          f"{n_tok / dt:.1f} tok/s")


if __name__ == "__main__":
    main()
