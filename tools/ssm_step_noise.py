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
    PYTHONPATH=src python3 tools/ssm_step_noise.py --arch jamba_1_5_large --layers 1 \
        --micro 1 --state-dtype config

The last is chip_smoke.py's FSDP f32 step: jamba's own rules put ``embed`` on
``data``, and its moments are bf16 (``--state-dtype config``; float32 by
default). Takes minutes at full width on the CPU (``--layers`` cuts the
depth). The ranks run first and each writes only its own blocks to a file
under the temporary directory (removed at the end); the single process
then runs alone and reads them mapped, so no process holds the state
twice and none is sent through a pipe.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
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
    the new params, m and v (global tensors; on a mesh the rank's
    blocks, _blocks), and the loss."""
    from repro_torch import tree
    from repro_torch.models import init_params
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules as shr
    from repro_torch.train import step as ts

    cfg = _config(args)
    sh = None if mesh is None else shr.param_shardings(cfg, mesh)
    params = init_params(cfg, torch.Generator().manual_seed(args.seed), shardings=sh)
    dtype = cfg.opt_state_dtype if args.state_dtype == "config" else args.state_dtype
    opt = adamw.AdamWConfig(state_dtype=dtype, division=cfg.division)
    state = ts.init_state(cfg, params, opt)
    del params
    if mesh is None:
        new, metrics = ts.train_step(cfg, opt, state, _batch(args, cfg.vocab),
                                     n_micro=args.micro * args.data)
    else:
        with shr.use_mesh(mesh):
            new, metrics = ts.train_step(cfg, opt, state, _batch(args, cfg.vocab),
                                         n_micro=args.micro)
    del state
    keep = (lambda t: t.detach()) if mesh is None else _blocks
    return ({k: [keep(t) for t in tree.leaves(v)]
             for k, v in (("params", new.params), ("m", new.opt.m), ("v", new.opt.v))},
            float(metrics["loss"]))


def _blocks(x):
    """[(where, block)]: the DTensor ``x``'s block on this rank and the
    (start, stop) of each of its dims in the global leaf (the first mesh
    axis major, as ``sharding.rules.global_tensor`` joins them); empty on a
    rank whose block another rank with coordinate 0 on the axes that
    replicate ``x`` hands back."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return [([(0, n) for n in x.shape], x.detach())] if dist.get_rank() == 0 else []
    mesh, coord = x.device_mesh, x.device_mesh.get_coordinate()
    if any(c and not isinstance(pl, Shard) for c, pl in zip(coord, x.placements)):
        return []
    where = []
    for d in range(x.dim()):
        n, i = 1, 0
        for md, pl in enumerate(x.placements):
            if isinstance(pl, Shard) and pl.dim == d:
                n, i = n * mesh.shape[md], i * mesh.shape[md] + coord[md]
        step = x.shape[d] // n
        where.append((i * step, (i + 1) * step))
    b = x.to_local().detach()
    # torch.save writes a view's whole storage.
    return [(where, b if b.untyped_storage().nbytes() == b.nbytes else b.clone())]


def _rank(rank: int, args):
    """The mesh step on this rank; its blocks go to a file under
    ``args.tmp``. Returns (that file, the loss)."""
    from repro_torch.launch.mesh import make_mesh

    blocks, loss = _step(args, make_mesh((args.data, args.model), ("data", "model"), "cpu"))
    path = os.path.join(args.tmp, f"rank{rank}.pt")
    torch.save(blocks, path)
    return path, loss


def _distance(blocks, whole: torch.Tensor) -> tuple:
    """(largest elementwise distance over ``whole``'s largest value, L2
    distance over its norm) of the ranks' ``blocks`` of one leaf."""
    worst, sq = 0.0, 0.0
    for where, b in blocks:
        d = b.float() - whole[tuple(slice(*w) for w in where)].float()
        worst = max(worst, float(d.abs().max()))
        sq += float(torch.linalg.vector_norm(d)) ** 2
    w = whole.float()
    return worst / float(w.abs().max()), sq ** 0.5 / float(w.norm())


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
    ap.add_argument("--state-dtype", default="float32", choices=("float32", "bfloat16", "config"),
                    help="AdamW's moments (config: the config's opt_state_dtype)")
    args = ap.parse_args(argv)
    args.data, args.model = (int(n) for n in args.mesh.split("x"))

    from repro_torch.launch.mesh import run_ranks

    t0 = time.perf_counter()
    args.tmp = tempfile.mkdtemp(prefix="ssm_step_noise_")
    try:
        out = _compare(args, run_ranks(_rank, args.data * args.model, args, device_type="cpu",
                                       timeout_s=3600, threads=2))
    finally:
        shutil.rmtree(args.tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))
    return 0


def _compare(args, ranks) -> dict:
    """The single-process step against the ranks' blocks (``ranks``: each
    rank's file and loss): the readings main prints."""
    from repro_torch import tree
    from repro_torch.models.params import model_specs

    single, loss = _step(args)
    mesh_loss = ranks[0][1]
    blocks = [torch.load(path, mmap=True, weights_only=True) for path, _ in ranks]
    cfg = _config(args)
    paths = tree.paths(model_specs(cfg))
    out = {"arch": args.arch, "smoke": args.smoke, "layers": cfg.n_layers,
           "mesh": args.mesh, "tokens": [args.batch, args.seq], "micro": args.micro,
           "state_dtype": str(single["m"][0].dtype).removeprefix("torch."),
           "loss_rel": abs(mesh_loss - loss) / abs(loss)}
    for k in ("params", "m", "v"):
        rows = [(p, *_distance([b for r in blocks for b in r[k][i]], w))
                for i, (p, w) in enumerate(zip(paths, single[k])) if float(w.float().norm())]
        top = max(rows, key=lambda r: r[1])
        l2 = max(rows, key=lambda r: r[2])
        out[k] = {"max": top[1], "max_leaf": top[0], "l2": l2[2], "l2_leaf": l2[0]}
    return out


if __name__ == "__main__":
    sys.exit(main())
