"""Time the f32 flash-attention kernel against builds of it in which one of
its specialisations is folded back into the general form, in turns on one
card, to see whether each specialisation pays for its second code path.

    python3 tools/flash_fold_ab.py [--root DIR] [--rounds N] [--reps N]

``--root`` is the root of a checkout of this repository (default: the one
this script lives in). A variant is its ``csrc/flash_attention.cu`` with one
dispatch condition replaced (``FOLDS``), so that only the general form is
left:

* ``qk_guarded`` / ``qk_unguarded``: an earlier version of the kernel's
  slice dispatch (``qk<HD, kSome>`` under ``if (nj >= 8)``: wholly masked
  16-key slices of a block not multiplied), every block sent through the
  guarded or the unguarded form. The source now holds the unguarded form,
  so on a checkout of it both are reported as ``folded``;
* ``mask_always``: every key block scaled and masked (``scale_and_max<true>``);
* ``pv_guarded``: PV tests every row's skip predicate (``pv<HD, false>``).

``base`` is the source as it is. Each is compiled with kernels/_build.py's
flags into the checkout's ``build/flash_fold/`` (one nvcc each, all at
once); a fold whose
condition the source no longer holds is reported as ``folded`` and not
built. Each build is checked bit for bit against the repository's kernel
(the checkout's ``kernels.flash_attention``), then timed on seeded (96, 2048, 64) f32
q/k/v, causal and full, as its kernel's device time (torch.profiler, over
``--reps`` calls) in ``--rounds`` rounds, the variants in turn and the order
reversed every other round. Prints one JSON line per reading, then one with
each build's registers, static SASS instructions and mean device ms per
mode, and the card's name and power limit. Needs a CUDA card, nvcc and
cuobjdump; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (96, 2048, 64)
_DISPATCH_QK = "if (nj >= 8)"
_DISPATCH_MASK = ("if (block_k < kMaxBlockK || k0 + block_k > sk_real || "
                  "(causal && k0 + block_k - 1 > q0))")
_DISPATCH_PV = "if (all)"
FOLDS = {"base": None,
         "qk_guarded": (_DISPATCH_QK, "if (false)"),
         "qk_unguarded": (_DISPATCH_QK, "if (true)"),
         "mask_always": (_DISPATCH_MASK, "if (true)"),
         "pv_guarded": (_DISPATCH_PV, "if (false)")}


def build(root: Path) -> dict:
    """{variant: (library path, ptxas register lines)} of the checkout at
    root; 'folded' variants are left out and named in the 'folded' list."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "flash_attention.cu").read_text()
    out_dir = root / "build" / "flash_fold"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, folded = {}, []
    for name, fold in FOLDS.items():
        text = src
        if fold is not None:
            if src.count(fold[0]) != 1:
                folded.append(name)
                continue
            text = src.replace(fold[0], fold[1])
        cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    built = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed ({proc.returncode}):\n{err}")
        built[name] = (so, [ln.strip() for ln in err.splitlines() if "registers" in ln])
    return {"built": built, "folded": folded}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("flash_fold_ab: no CUDA device", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    from chip_smoke import device_ms
    from kernel_ab import sass_counts
    from repro_torch.core.seeds import compute_segments
    from repro_torch.kernels import _build, flash_attention as fa
    from repro_torch.kernels.tsdiv import SCHEDULES, _ptr, _stream, _table_c

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    res = build(root)
    fns = {}
    for name, (so, _) in res["built"].items():
        fn = ctypes.CDLL(str(so)).flash_attention_f32
        fn.argtypes = _build._SIGNATURES["flash_attention"]["flash_attention_f32"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    gen = torch.Generator(device="cuda").manual_seed(0)
    bh, s, hd = SHAPE
    q, k, v = (torch.randn(SHAPE, generator=gen, device="cuda") for _ in range(3))
    out = torch.empty_like(q)
    table = _table_c(compute_segments(2, 24))
    scale = 1.0 / hd ** 0.5

    def call(fn, causal):
        def run():
            rc = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(out), bh, s, s, s, hd, 128, int(causal), 1,
                    scale, table, 2, SCHEDULES["factored"], _stream(q))
            if rc:
                raise RuntimeError(f"flash_attention_f32 launch failed with CUDA error {rc}")
        return run

    same = {}
    for causal in (True, False):
        ref = fa.flash_attention(q, k, v, causal=causal)
        for name, fn in fns.items():
            call(fn, causal)()
            torch.cuda.synchronize()
            same[f"{name}_{'causal' if causal else 'full'}"] = bool(torch.equal(
                out.view(torch.int32), ref.view(torch.int32)))
    if not all(same.values()):
        print(json.dumps({"bits_differ": same}), flush=True)
        return 1
    readings = {}
    order = list(fns)
    for rnd in range(args.rounds):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            for causal in (True, False):
                mode = "causal" if causal else "full"
                ms = device_ms(call(fns[name], causal), "flash_kernel", args.reps)
                readings.setdefault(name, {}).setdefault(mode, []).append(ms)
                print(json.dumps({"variant": name, "mode": mode, "round": rnd, "device_ms": ms}),
                      flush=True)
    summary = {}
    for name, (so, regs) in res["built"].items():
        insns = {fn: c["instructions"] for fn, c in sass_counts(so).items()}
        summary[name] = {"ptxas": regs, "sass_instructions": insns,
                         "mean_device_ms": {m: sum(r) / len(r) for m, r in readings[name].items()},
                         "spread_device_ms": {m: max(r) - min(r)
                                              for m, r in readings[name].items()}}
    print(json.dumps({"root": str(root), "nvidia_smi": smi, "shape": list(SHAPE), "block_k": 128,
                      "rounds": args.rounds, "reps": args.reps, "same_bits": same,
                      "folded": res["folded"], "variants": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
