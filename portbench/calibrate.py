"""The readings that a cell's correctness limit is set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault NAME] [--seconds 10] [--out PATH]

In one process, for each seed: one run of the cell (``harness.run``, its
window at ``--seconds``), and over the requests its check samples the
program's gaps (the widest, the mean, the share of served tokens that are
not the reference's first). For each control seed the same readings of
the control: the reference with its 16-bit weights rounded to float8
(``check.control_gap``'s precision), put in the program's place, at the
same positions. ``--fault`` plants one of ``portbench/tests/_faults.py``'s
faults under the timed path for every seed. Prints one JSON line a seed,
with each compared request's gaps in answer order, and appends it to
``--out``. A benchmark's runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    root = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(root), str(root / "src")]


def readings(gaps):
    import torch

    g = torch.cat(gaps)
    return {"widest": float(g.max()), "mean": float(g.mean()),
            "miss": float((g > 0).float().mean()), "tokens": int(g.numel())}


def main(argv=None) -> int:
    import torch

    from portbench import check, harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--fault", default=None, help="a fault of portbench/tests/_faults.py")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    got = {}
    orig = check.judge

    def keep(cell, cj, sizes, params, specs, outs, seed):
        got.update(cell=cell, cj=cj, sizes=sizes, params=params, specs=specs, outs=outs)
        return orig(cell, cj, sizes, params, specs, outs, seed)

    check.judge = keep
    if args.fault:
        import pytest

        from portbench.tests._faults import FAULTS

        FAULTS[args.fault](pytest.MonkeyPatch())
    for seed in seeds:
        t0 = time.perf_counter()
        r = harness.run(args.workload, seed, args.seconds, False, t_start=t0)
        ref = check.reference(got["cj"])
        picks = check.sample(got["specs"], got["outs"], seed, check.SAMPLE)
        prog, ctrl = [], []
        for i in picks:
            prompt, served = got["specs"][i].tokens, got["outs"][i]
            if seed in control:
                c, p = check.control_gaps(ref, got["params"], got["sizes"], prompt, served)
                ctrl.append(c)
            else:
                p = check.served_gaps(ref, got["params"], got["sizes"], prompt, served)
            prog.append(p)
        line = {"workload": args.workload, "seed": seed, "seconds": args.seconds,
                "fault": args.fault,
                "correct": r["correct"], "checks": r["checks"], "metrics": r["metrics"],
                "program": readings(prog), "control": readings(ctrl) if ctrl else None,
                "gaps": [g.tolist() for g in prog],
                "control_gaps": [g.tolist() for g in ctrl] or None,
                "wall_s": time.perf_counter() - t0}
        got.clear()
        torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
        if args.out:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            with args.out.open("a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
