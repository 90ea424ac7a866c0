"""chip_smoke.py's tp_ssm phase alone: the kernels' build, then the Mamba-2
mixer split by heads over the model axis on the one card (phase_tp_ssm):
mamba2_780m served on (data 1, model 2) and trained on (data 2, model 2),
jamba_1_5_large under its own rules (FSDP over data) served and trained on
(data 2, model 2).

    python3 tools/tp_ssm_phase.py [--seed N] [--golden]

``--golden`` runs the golden phase first (the committed stores checked, the
port's generators run into build/golden). Prints chip_smoke.py's device,
golden and tp_ssm lines and, last, the command's seconds, the card's name
and power limit and the launches the ranks counted. A check fails the
command as it fails chip_smoke.py: the quick way to rerun the split
mixer's gates after a change to models/mamba2.py or models/parallel.py.
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
    ap.add_argument("--golden", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        print("tp_ssm_phase: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    smi = cs.phase_device()
    if args.golden:
        cs.phase_golden()
    err = {k: 0.0 for k in cs.SOURCES}
    launches = {k: 0 for k in err}
    cs.phase_tp_ssm(args.seed, launches, err)
    print("seconds", time.perf_counter() - t0, smi, launches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
