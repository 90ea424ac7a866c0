"""Where a training step of paper_fpdiv spends the card's time.

    python3 tools/profile_train.py [--json PATH]
    python3 tools/profile_train.py --device cpu --smoke      # a CPU check

``chip_smoke.py``'s train cell: paper_fpdiv at full width and depth, bf16
params from ``--seed``, one step of TRAIN_BATCH x TRAIN_SEQ tokens of
SyntheticLM in microbatches of the config's size, remat as configured, in
taylor_pallas and in exact. For each mode it prints one JSON line: the
host wall time of the first step of a fresh state (a process's first
step also pays its warm-up), then of one step run before the profiler
starts, the device time of every kernel and copy of one step under
torch.profiler, their ratio (the busy share), the device time by family
(tools/profile_serving.py's: GEMMs, the division unit's kernels, casts and
copies, reductions, elementwise, other) and the ten kernels that take the
most; and AdamW's update alone the same way. Prints the card's name and
power limit first. ``--device cpu --smoke`` runs the smoke config on the
CPU, to check the script without a card; its times are the CPU's and no
device's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="the smoke config (a CPU check)")
    ap.add_argument("--json", type=Path)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    import torch

    import chip_smoke as cs
    import repro_torch.configs as configs
    from profile_serving import profiled, summary
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.optim import adamw
    from repro_torch.train import step as ts

    cs.DEVICE = args.device
    on_card = args.device == "cuda"
    sync = torch.cuda.synchronize if on_card else None
    if on_card:
        from repro_torch.kernels import _build

        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        _build.build_all()
    batch_rows, seq = cs.TRAIN_BATCH, cs.TRAIN_SEQ
    if args.smoke:
        configs.get_config = configs.get_smoke_config
        batch_rows, seq = 8, 64
    results = []
    for mode in ("taylor_pallas", "exact"):
        cfg = cs.train_config(mode)
        if args.smoke:
            cfg = dataclasses.replace(cfg, remat=True, train_microbatch_size=4)
        n_micro = batch_rows // cfg.train_microbatch_size
        opt_cfg = adamw.AdamWConfig(state_dtype=cfg.opt_state_dtype, division=cfg.division)
        params = init_params(cfg, torch.Generator(device=args.device).manual_seed(args.seed))
        state = {"s": ts.init_state(cfg, params, opt_cfg)}
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch_rows,
                                      seed=args.seed))

        def one_step(i):
            batch = {k: torch.from_numpy(v).to(args.device) for k, v in data.batch(i).items()}
            state["s"], state["m"] = ts.train_step(cfg, opt_cfg, state["s"], batch,
                                                   n_micro=n_micro)

        t0 = time.perf_counter()
        one_step(0)
        float(state["m"]["loss"])
        first_ms = (time.perf_counter() - t0) * 1e3
        wall, kernels = profiled(one_step, sync, 1)
        row = summary(cfg.name, f"train_step/{mode}", wall, kernels)
        row.update(first_step_ms=first_ms, tokens=batch_rows * seq, n_micro=n_micro,
                   remat=cfg.remat)
        results.append(row)
        grads = {"g": None}
        s = state["s"]
        _, _, grads["g"] = ts.grads_fn(cfg, s.params, {
            k: torch.from_numpy(v).to(args.device) for k, v in data.batch(0).items()}, n_micro)
        wall, kernels = profiled(lambda i: adamw.update(grads["g"], s.opt, s.params, opt_cfg),
                                 sync, 1)
        results.append(summary(cfg.name, f"adamw/{mode}", wall, kernels))
        for r in results[-2:]:
            print(json.dumps(r), flush=True)
        del params, state, grads, s
        if on_card:
            torch.cuda.empty_cache()
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
