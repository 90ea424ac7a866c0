"""chip_smoke.py's tp phase alone: the kernels' build, then tensor
parallelism over the model axis on the one card (phase_tp, with the
sequence layouts), then the split softmax kernel's times row
(phase_times_split).

    python3 tools/tp_phase.py [--seed N]

Prints chip_smoke.py's device and tp lines and, last, the command's
seconds, the card's name and power limit and the launches the ranks
counted. A check fails the command as it fails chip_smoke.py: the quick way
to rerun the tensor-parallel gates after a change to models/parallel.py.
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
        print("tp_phase: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    smi = cs.phase_device()
    err = {k: 0.0 for k in cs.SOURCES}
    launches = {k: 0 for k in err}
    tp = cs.phase_tp(args.seed, launches, err)
    cs.phase_times_split(err, launches, tp["split_inputs"])
    print("seconds", time.perf_counter() - t0, smi, launches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
