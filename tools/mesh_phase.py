"""chip_smoke.py's mesh phase alone: the kernels' build, then 2 ranks on the
one card (phase_mesh) and the tiled kernels' times at the shard shape.

    python3 tools/mesh_phase.py [--seed N]

Prints chip_smoke.py's device, mesh and times lines and, last, the
command's seconds, the card's name and power limit and the launches the
ranks counted. A check fails the command as it fails chip_smoke.py. About
100 s of command on the H100, the build included: the quick way to rerun
the mesh gates after a change to the sharded paths.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        print("mesh_phase: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    smi = cs.phase_device()
    err = {k: 0.0 for k in cs.SOURCES}
    launches = {k: 0 for k in err}
    mesh = cs.phase_mesh(args.seed, launches, err)
    cs.phase_times_mesh(err, launches, mesh)
    print("seconds", time.perf_counter() - t0, smi, launches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
