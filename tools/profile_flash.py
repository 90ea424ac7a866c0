"""Profile division_modes.attention at the serving shape with torch.profiler:
which kernels run on the card in one call, and how long each takes.

    python3 tools/profile_flash.py [--calls N] [--device cuda|cpu]

Seeded q/k/v of (8, 12, 2048, 64) (paper_fpdiv's batch x heads x longest
prompt x head size), causal, in ``taylor_pallas`` with the paper schedule,
first in bf16 (the tensor-core kernel) and then in f32 (the CUDA-core
kernel). For each, prints one JSON line: the device time per call of every
kernel and copy on the card (``key_averages`` over ``--calls`` profiled
calls), their total per call, the host wall time per call of as many calls
run before the profiler starts, and the card's name and power limit; and
the kernel's resident blocks per SM at this shape
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the warps that
gives out of the SM's 64.
``--device cpu`` runs the plain versions at a small shape, to check the
script without a card; it reports CPU times only.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def blocks_per_sm(bf16: bool, hd: int, block_k: int) -> int:
    """Resident blocks per SM of the bf16 or the f32 flash kernel (4 warps
    each; the f32 kernel's shared memory does not depend on block_k)."""
    import ctypes

    from repro_torch.kernels import _build

    blocks = ctypes.c_int(0)
    if bf16:
        rc = _build.library("flash_attention_tc").flash_attention_bf16_blocks_per_sm(
            hd, block_k, ctypes.byref(blocks))
    else:
        rc = _build.library("flash_attention").flash_attention_f32_blocks_per_sm(
            hd, ctypes.byref(blocks))
    if rc:
        raise RuntimeError(f"occupancy query failed with CUDA error {rc}")
    return blocks.value


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import division_modes as dm

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("profile_flash: no CUDA device", file=sys.stderr)
        return 2
    card = "cpu"
    if cuda:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    shape = (8, 12, 2048, 64) if cuda else (1, 2, 128, 64)
    cfg = dm.DivisionConfig(mode="taylor_pallas", schedule="paper")
    gen = torch.Generator(device=args.device).manual_seed(0)
    qkv = [torch.randn(shape, generator=gen, device=args.device) for _ in range(3)]
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (t.to(dtype) for t in qkv)
        dm.attention(q, k, v, cfg)                   # build and warm up
        sync()
        t0 = time.perf_counter()
        for _ in range(args.calls):
            dm.attention(q, k, v, cfg)
        sync()
        wall = (time.perf_counter() - t0) / args.calls
        with profile(activities=activities) as prof:
            for _ in range(args.calls):
                dm.attention(q, k, v, cfg)
            sync()
        rows = {}
        for e in prof.key_averages():
            # Device rows only (kernels and copies), so that no time counts
            # twice under the host op that launched it.
            if cuda and e.device_type == DeviceType.CUDA:
                us = e.self_device_time_total
            elif not cuda and e.key.startswith("aten::"):
                us = e.self_cpu_time_total
            else:
                continue
            if us > 0:
                rows[e.key] = {"ms_per_call": us / 1e3 / args.calls, "count": e.count}
        total = sum(r["ms_per_call"] for r in rows.values())
        line = {"dtype": str(dtype).replace("torch.", ""), "shape": list(shape),
                "card": card, "calls": args.calls, "host_ms_per_call": wall * 1e3,
                "device_ms_per_call" if cuda else "cpu_ms_per_call": total,
                "kernels": dict(sorted(rows.items(), key=lambda kv: -kv[1]["ms_per_call"]))}
        if cuda:
            line["blocks_per_sm"] = blocks_per_sm(dtype == torch.bfloat16, shape[-1],
                                                  min(128, shape[-2]))
            line["warps_per_sm"] = 4 * line["blocks_per_sm"]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
