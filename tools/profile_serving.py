"""Where a served model's prefill and decode steps spend the card's time.

    python3 tools/profile_serving.py [--archs A,B] [--json PATH]
    python3 tools/profile_serving.py --device cpu --smoke      # a CPU check

For each model of ``chip_smoke.py``'s phases 9d-9g (mamba2_780m,
jamba_1_5_large at its 5-layer cut, whisper_tiny, llava_next_mistral_7b),
at full width in bf16 with params from ``--seed`` in taylor_pallas, on
that phase's prompts (and its seeded encoder frames or prompt
embeddings): after a warm-up, one padded prefill of the batch and then
STEPS decode steps, each under torch.profiler (the prefill as
``generate_batch`` runs it: the cache grown to its decode length). Prints one JSON line
per model and step kind: the host wall time per call (calls run before
the profiler starts), the device time of every kernel and copy per call
under it, their ratio (the device's busy share; one
minus it is the idle share), the device time by family (GEMMs, the
division unit's kernels, casts and copies, reductions, elementwise, other) and the
ten kernels that take the most. Prints the card's name and power limit
first. ``--device cpu --smoke`` runs the smoke configs on the CPU, to check
the script without a card; its times are the CPU's and no device's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEPS = 4
# Kernel families by name, the first that matches: cuBLAS's GEMMs and
# GEMVs, the port's kernels, dtype casts and copies, reductions, the rest
# of torch's elementwise kernels.
FAMILIES = (("gemm", ("gemm", "gemv", "xmma", "cutlass", "nvjet")),
            ("division unit", ("softmax_kernel", "rmsnorm_kernel", "tsdiv", "recip_")),
            ("cast or copy", ("direct_copy", "memcpy", "memset", "cat", "index")),
            ("reduction", ("reduce", "scan", "sort", "topk")),
            ("elementwise", ("elementwise",)))


def family(name: str) -> str:
    low = name.lower()
    return next((f for f, keys in FAMILIES if any(k in low for k in keys)), "other")


def profiled(fn, sync, calls: int):
    """(host ms per call of ``calls`` calls run before the profiler starts,
    {kernel: device ms per call} of as many calls under it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        for i in range(calls):
            fn(i)
        if sync is not None:
            sync()

    t0 = time.perf_counter()
    run()
    wall = (time.perf_counter() - t0) * 1e3 / calls
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if sync is not None else [])
    with profile(activities=acts) as prof:
        run()
    kernels = {e.key: e.self_device_time_total / 1e3 / calls for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    return wall, kernels


def summary(arch, kind, wall, kernels):
    dev = sum(kernels.values())
    fams = {}
    for name, ms in kernels.items():
        fams[family(name)] = fams.get(family(name), 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"arch": arch, "step": kind, "wall_ms": wall, "device_ms": dev,
            "busy_share": dev / wall if wall else None, "by_family": fams,
            "top": [[name[:100], ms] for name, ms in top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", default="mamba2_780m,jamba_1_5_large,whisper_tiny,"
                                       "llava_next_mistral_7b")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="the smoke configs (a CPU check)")
    ap.add_argument("--json", type=Path)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    import repro_torch.configs as configs
    from repro_torch.serving import ServingEngine, pad_cache_to

    cs.DEVICE = args.device
    on_card = args.device == "cuda"
    sync = torch.cuda.synchronize if on_card else None
    if on_card:
        from repro_torch.kernels import _build

        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        _build.build_all()
    if args.smoke:
        configs.get_config = configs.get_smoke_config
    results = []
    for sv in (cs.SSM, cs.HYBRID, cs.ENCDEC, cs.VLM):
        if sv.arch not in args.archs.split(","):
            continue
        lens = tuple(max(2, n // 64) for n in sv.lens) if args.smoke else sv.lens
        cfg, params, prompts = cs.model_setup(sv.arch, args.seed, lens=lens, **sv.depth)
        cfg = dataclasses.replace(cfg, division=dataclasses.replace(cfg.division,
                                                                    mode="taylor_pallas"))
        hand = cs.hand_offs(cfg, sv.hand, prompts, args.seed)
        eng = ServingEngine(cfg, params, max_len=cs.cache_len(cfg, prompts, STEPS + 1))
        state = {}

        def prefill(_):
            state["logits"], cache, state["lengths"], n = cs.prefill_batch(eng, prompts, hand)
            state["cache"] = pad_cache_to(cache, n, eng.max_len, cfg)

        def decode(i):
            tok = torch.argmax(state["logits"], -1)[:, None].to(torch.int32)
            state["logits"], state["cache"] = eng._decode(state["cache"], tok,
                                                          state["lengths"] + i)

        prefill(0)                                        # warm-up
        decode(0)
        if sync is not None:
            sync()
        wall, kernels = profiled(prefill, sync, 1)
        results.append(summary(cfg.name, "prefill", wall, kernels))
        wall, kernels = profiled(decode, sync, STEPS)
        results.append(summary(cfg.name, "decode", wall, kernels))
        for r in results[-2:]:
            print(json.dumps(r), flush=True)
        del eng, params, state, hand
        if on_card:
            torch.cuda.empty_cache()
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
