"""Host-side rates of the collectives that ``sharding/comm.py`` runs over
gloo: for one block size, gloo's own all-gather (and the concatenation
after it, as ``comm.all_gather`` gathered before), one broadcast from each
rank into one buffer, gloo's all-to-all of the block repeated once for each
rank (what ``comm.all_gather`` now runs), ``comm.all_gather`` itself on the
given device (the host copies included), gloo's gather to rank 0 and one
send from each rank to it (``chip_smoke.on_rank0``), gloo's reduce-scatter
and all-reduce. Two ranks by default, each on one intra-op thread, as the
smoke's ranks run; every reading is the least of ``--reps`` runs, started
after a barrier.

    python3 tools/gloo_rates.py [--device cpu|cuda] [--mb 256] [--ranks 2] [--reps 4]

Prints one JSON line: seconds and MB/s of each transport for a block of
``--mb`` MiB a rank, and, on the card, its name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]


def _least(fn, reps: int) -> float:
    import torch
    import torch.distributed as dist

    best = float("inf")
    for _ in range(reps):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def _rank(rank: int, mb: int, reps: int, device: str) -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import comm

    n = dist.get_world_size()
    mesh = make_mesh((n,), ("data",), device)
    block = torch.full((mb * 2**20 // 2,), float(rank), dtype=torch.bfloat16)
    parts = [torch.empty_like(block) for _ in range(n)]
    buf = torch.empty((n, block.numel()), dtype=block.dtype)
    whole = torch.ones(n * block.numel(), dtype=block.dtype)
    out = torch.empty_like(block)
    on_dev = block.to(device)

    def broadcasts():
        buf[rank].copy_(block)
        for i in range(n):
            dist.broadcast(buf[i], src=i)

    def sends():
        if rank:
            dist.send(block, dst=0)
        for r in range(1, n if rank == 0 else 1):
            dist.recv(parts[r], src=r)

    got = comm.all_gather(on_dev, mesh, ("data",)).cpu()
    dist.all_gather(parts, block)
    if not torch.equal(got, torch.cat(parts)):
        raise RuntimeError("comm.all_gather differs from gloo's all-gather")
    secs = {"gloo_all_gather": _least(lambda: dist.all_gather(parts, block), reps),
            "gloo_all_gather_and_cat": _least(
                lambda: (dist.all_gather(parts, block), torch.cat(parts)), reps),
            "broadcasts": _least(broadcasts, reps),
            "all_to_all_of_repeats": _least(lambda: dist.all_to_all_single(
                buf.view(-1), block.repeat(n)), reps),
            "comm_all_gather": _least(lambda: comm.all_gather(on_dev, mesh, ("data",)), reps),
            "gloo_gather_to_rank0": _least(
                lambda: dist.gather(block, parts if rank == 0 else None, dst=0), reps),
            "sends_to_rank0": _least(sends, reps),
            "gloo_reduce_scatter": _least(
                lambda: dist.reduce_scatter_tensor(out, whole), reps),
            "gloo_all_reduce": _least(lambda: dist.all_reduce(block), reps)}
    return secs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--mb", type=int, default=256, help="MiB of bf16 a rank holds")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args(argv)
    from repro_torch.launch.mesh import run_ranks

    ranks = run_ranks(_rank, args.ranks, args.mb, args.reps, args.device,
                      device_type=args.device, timeout_s=600.0)
    secs = {k: max(r[k] for r in ranks) for k in ranks[0]}
    # MB/s of the whole operand each transport moves: the gathered result
    # of an all-gather or a gather, the whole input of a reduce-scatter, the
    # block of an all-reduce.
    moved = {k: (args.mb if k == "gloo_all_reduce" else args.ranks * args.mb) for k in secs}
    line = {"ranks": args.ranks, "mib_a_rank": args.mb, "device": args.device,
            "seconds": secs, "mb_per_s": {k: moved[k] * 2**20 / 1e6 / s for k, s in secs.items()}}
    if args.device == "cuda":
        line["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
