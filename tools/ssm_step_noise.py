"""The sum-order spread of a train step split over the model axis, on the CPU.

Runs one f32 train step of a Mamba-2 model (mamba2_780m or jamba_1_5_large,
their full configs' sharding rules; ``--smoke`` for the smoke config) on a
(data, model) mesh of gloo ranks on the CPU, and the same step in one
process, from the same parameters and batch, and prints one JSON line: for
the parameters and AdamW's m and v, each leaf's largest elementwise
distance over its largest value and its L2 distance over its norm (the
worst leaf of each), and the loss's relative distance. A split mixer is
another sum order of the same function, so these are the floor that the
step gates of ``tests/test_torch_ssm_parallel.py`` and ``chip_smoke.py``'s
tp_ssm phase sit on.

    PYTHONPATH=src python3 tools/ssm_step_noise.py --arch mamba2_780m --layers 3
    PYTHONPATH=src python3 tools/ssm_step_noise.py --arch jamba_1_5_large --smoke --mesh 1x4

Takes minutes at full width on the CPU (``--layers`` cuts the depth).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _config(args):
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.division_modes import DivisionConfig

    full = get_config(args.arch)
    cfg = get_smoke_config(args.arch) if args.smoke else full
    repl = {"n_layers": args.layers} if args.layers else {}
    return dataclasses.replace(cfg, param_dtype="float32", sharding_rules=full.sharding_rules,
                               division=DivisionConfig(mode="taylor_pallas", schedule="paper"),
                               **repl)


def _batch(args, vocab: int):
    from repro_torch.data import DataConfig, SyntheticLM

    data = SyntheticLM(DataConfig(vocab=vocab, seq_len=args.seq, global_batch=args.batch,
                                  seed=args.seed))
    return {k: torch.from_numpy(v) for k, v in data.batch(0).items()}


def _step(args, mesh=None):
    """One train step from ``--seed``'s parameters (placed on ``mesh``):
    the new params, m and v as global tensors, and the loss."""
    from repro_torch import tree
    from repro_torch.models import init_params
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules as shr
    from repro_torch.train import step as ts

    cfg = _config(args)
    sh = None if mesh is None else shr.param_shardings(cfg, mesh)
    params = init_params(cfg, torch.Generator().manual_seed(args.seed), shardings=sh)
    opt = adamw.AdamWConfig(division=cfg.division)
    state = ts.init_state(cfg, params, opt)
    if mesh is None:
        new, metrics = ts.train_step(cfg, opt, state, _batch(args, cfg.vocab),
                                     n_micro=args.micro * args.data)
    else:
        with shr.use_mesh(mesh):
            new, metrics = ts.train_step(cfg, opt, state, _batch(args, cfg.vocab),
                                         n_micro=args.micro)
    glob = shr.global_tensor if mesh is not None else (lambda t: t)
    return ({k: [glob(t).detach() for t in tree.leaves(v)]
             for k, v in (("params", new.params), ("m", new.opt.m), ("v", new.opt.v))},
            float(metrics["loss"]))


def _rank(rank: int, args):
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((args.data, args.model), ("data", "model"), "cpu")
    got = _step(args, mesh)
    return got if rank == 0 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2_780m", choices=("mamba2_780m", "jamba_1_5_large"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth (0: the config's)")
    ap.add_argument("--mesh", default="2x2", help="data x model, 4 ranks at most")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--micro", type=int, default=2, help="microbatches a data rank")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    args.data, args.model = (int(n) for n in args.mesh.split("x"))

    from repro_torch import tree
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.params import model_specs

    t0 = time.perf_counter()
    (mesh_state, mesh_loss), = [o for o in run_ranks(_rank, args.data * args.model, args,
                                                        device_type="cpu", timeout_s=3600,
                                                        threads=2) if o is not None]
    single, loss = _step(args)
    paths = tree.paths(model_specs(_config(args)))
    out = {"arch": args.arch, "smoke": args.smoke, "layers": _config(args).n_layers,
           "mesh": args.mesh, "tokens": [args.batch, args.seq],
           "loss_rel": abs(mesh_loss - loss) / abs(loss)}
    for k in ("params", "m", "v"):
        rows = [(p, float((g - w).abs().max()) / float(w.abs().max()),
                 float((g - w).norm()) / float(w.norm()))
                for p, g, w in zip(paths, mesh_state[k], single[k]) if float(w.norm())]
        top = max(rows, key=lambda r: r[1])
        l2 = max(rows, key=lambda r: r[2])
        out[k] = {"max": top[1], "max_leaf": top[0], "l2": l2[2], "l2_leaf": l2[0]}
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
