"""chip_smoke.py's ep phase alone: the kernels' build, then expert
parallelism for deepseek_moe_16b on (data 2, model 2) on the one card
(phase_ep).

    python3 tools/ep_phase.py [--seed N]

Prints chip_smoke.py's device and ep lines and, last, the command's
seconds, the card's name and power limit and the launches the ranks
counted. A check fails the command as it fails chip_smoke.py: the quick way
to rerun the expert-parallel gates after a change to models/moe.py.
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
        print("ep_phase: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    smi = cs.phase_device()
    err = {k: 0.0 for k in cs.SOURCES}
    launches = {k: 0 for k in err}
    cs.phase_ep(args.seed, launches, err)
    print("seconds", time.perf_counter() - t0, smi, launches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
