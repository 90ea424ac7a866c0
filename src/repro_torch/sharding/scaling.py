"""Sharding scaling driver: N ranks, one JSON line.

The port of ``src/repro/sharding/scaling.py``. Starts ``--ranks`` ranks
itself (``launch.mesh.run_ranks``: one process each, a ("data", "model")
mesh of (N, 1)) and times the mesh paths of the division unit on
``--device``:

  * the tiled divide through ``kernels.ops.tsdiv_divide`` on a DTensor of
    (``--rows``, ``--cols``) split over 'data' (one kernel launch per rank
    on the card; the plain version on the CPU);
  * data-parallel K-Means (``workloads.kmeans.kmeans_sharded``) on
    ``--points`` blobs of ``--dim`` x ``--k``.

With ``--ranks 1`` both take their unsharded paths in this process, so
runs at 1 and N ranks give the scaling pair. Ranks that share one card
(gloo) time contention, not scaling. Every divide runs in
``taylor_pallas``, through the kernels. The last
line of standard output is the JSON result, with the reference's keys:

  PYTHONPATH=src python -m repro_torch.sharding.scaling --ranks 2 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import torch

__all__ = ["main"]

RANKS_TIMEOUT_S = 900.0


def _time_us(fn, reps: int, device: str) -> float:
    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps * 1e6


def _measure(rank: int, args) -> dict:
    """One rank's timings (rank 0's are reported); no mesh at one rank."""
    from repro_torch.core import division_modes as dm
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import rules as shr
    from repro_torch.workloads import kmeans as km

    dev = args.device
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_host_mesh(device_type=dev) if args.ranks > 1 else None
    gen = torch.Generator().manual_seed(0)
    a = (torch.rand((args.rows, args.cols), generator=gen) * 9.9 + 0.1).to(dev)
    b = (torch.rand((args.rows, args.cols), generator=gen) * 9.9 + 0.1).to(dev)
    x = km.make_blobs(torch.Generator().manual_seed(2), args.points, args.dim, args.k).to(dev)
    init = x[torch.arange(args.k) * (args.points // args.k)].clone()
    cfg = dm.DivisionConfig(mode="taylor_pallas")
    if mesh is None:
        div = lambda: ops.tsdiv_divide(a, b)
        run_km = lambda: km.kmeans(x, cfg=cfg, n_iters=args.iters, init=init, device=dev)
    else:
        sh = shr.data_sharding(mesh, 2, batch_size=args.rows)
        a_s, b_s = shr.distribute(a, sh), shr.distribute(b, sh)
        div = lambda: ops.tsdiv_divide(a_s, b_s)
        run_km = lambda: km.kmeans_sharded(x, cfg=cfg, n_iters=args.iters, init=init,
                                           device=dev)
    with shr.use_mesh(mesh):
        us_div = _time_us(div, args.reps, dev)
        us_km = _time_us(run_km, args.reps, dev)
        inertia = float(run_km().inertia)
    return {"devices": args.ranks,
            "device": torch.cuda.get_device_name(0) if dev == "cuda" else "cpu",
            "mesh": shr.mesh_shape(mesh) if mesh is not None else {"data": 1, "model": 1},
            "tiled_divide_us": us_div, "tiled_divide_shape": [args.rows, args.cols],
            "kmeans_us": us_km,
            "kmeans": {"points": args.points, "dim": args.dim, "k": args.k,
                       "iters": args.iters, "inertia": inertia, "mode": cfg.mode}}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--points", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--rows", type=int, default=2048)
    ap.add_argument("--cols", type=int, default=384)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if args.ranks < 1:
        ap.error("--ranks must be >= 1")
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device here")
    if args.ranks == 1:
        out = _measure(0, args)
    else:
        from repro_torch.launch.mesh import run_ranks

        if args.device == "cuda":
            from repro_torch.kernels import _build

            _build.build_all()      # once, before the ranks load the libraries
        out = run_ranks(_measure, args.ranks, args, device_type=args.device,
                        timeout_s=RANKS_TIMEOUT_S)[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
