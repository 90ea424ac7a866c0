"""chip_smoke.py's FSDP f32 step on the card with AdamW's moments in bf16 and
in f32: jamba_1_5_large at full width cut to 1 layer under its own rules on
(data 2, model 2), 4 ranks sharing the card over gloo, each step's state
gathered to rank 0 and held to the single process's step on the same batch
(``chip_smoke.fsdp_f32_step`` and its ``l2_gate``). The smoke holds the step
with jamba's own bf16 moments; the f32 reading beside it says how much of
that step's distance is the moments' rounding.

    python3 tools/fsdp_step_noise.py [--seed N]

Builds the kernels (the step's RMSNorms and AdamW's reciprocals run them),
then prints one JSON line per moment dtype and, last, the command's seconds
and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def _rank(rank: int, seed: int) -> dict:
    import chip_smoke as cs

    mesh = cs.tp_mesh(cs.FSDP_MESH)
    batch = cs.fsdp_batch(cs.fsdp_config("float32", cs.FSDP_TRAIN_DEPTH), seed)
    return {dt: cs.fsdp_f32_step(rank, seed, mesh, batch, dt) for dt in ("bfloat16", "float32")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        print("fsdp_step_noise: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    smi = cs.phase_device()
    from repro_torch.launch.mesh import run_ranks

    ranks = run_ranks(_rank, cs.FSDP_MESH[0] * cs.FSDP_MESH[1], args.seed, device_type="cuda",
                      timeout_s=cs.SSM_TP_TIMEOUT_S)
    for dt, o in ranks[0].items():
        print(json.dumps({"state_dtype": dt, "layers": cs.FSDP_TRAIN_DEPTH,
                          "mesh": dict(zip(("data", "model"), cs.FSDP_MESH)),
                          "tokens": [cs.FSDP_TRAIN_BATCH, cs.FSDP_TRAIN_SEQ], **o}))
    print("seconds", time.perf_counter() - t0, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
