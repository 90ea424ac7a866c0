"""Time the softmax kernel with a row on one warp against a row on kSplit
warps, in turns on one card, over the row counts and row lengths that decide
the library's choice between them.

    python3 tools/softmax_split_ab.py [--root DIR] [--rounds N] [--reps N]

``--root`` is the root of a checkout of this repository (default: the one
this script lives in). A variant is its ``csrc/softmax.cu`` with the choice
in ``launch()`` (``SPLIT_RULE``) replaced by a constant: ``one_warp``
(``false``: a row of up to kMaxHeld chunks held by one warp, longer rows
read three times) and ``split`` (``true``: every vector row of up to
kMaxSplitHeld chunks held by kSplit warps). ``base`` is the source as it
is. Each is compiled with kernels/_build.py's flags into the checkout's
``build/softmax_split/`` (one nvcc each, all at once), checked bit for bit
against ``softmax_plain`` on every shape, then timed on seeded f32 logits
of scale 4 under the config's "paper" schedule as its kernel's device time
(torch.profiler, over ``--reps`` calls) in ``--rounds`` rounds, the variants
in turn and the order reversed every other round. ``SHAPES``: 4 to 32
rows an SM (on 132 SMs) at d = 768, 1024, 2112 (decode), 4096 and 8192;
rows of 1 to 32 chunks at m = 96; the serving prefill. Prints one JSON
line per reading, then one with each shape's mean device ms per variant,
the registers of each build and the card's name and power limit. Needs a
CUDA card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SPLIT_RULE = "chunks >= kSplitMin && m <= split_rows(chunks) * sms"
VARIANTS = {"base": None, "one_warp": "false", "split": "true"}
SHAPES = (tuple((m, 2112) for m in (96, 528, 1056, 2112, 4224))
          + tuple((96, d) for d in (256, 512, 768, 1024, 1536, 1792, 2048, 4096, 8192))
          + tuple((m, d) for d in (768, 1024) for m in (528, 1056, 2112))
          + tuple((m, d) for d in (4096, 8192) for m in (528, 1056, 2112, 4224))
          + ((196608, 2048),))


def build(root: Path) -> dict:
    """{variant: (library path, ptxas register lines)} of the checkout at root."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "softmax.cu").read_text()
    if src.count(SPLIT_RULE) != 1:
        raise RuntimeError(f"softmax.cu holds {src.count(SPLIT_RULE)} copies of {SPLIT_RULE!r}")
    out_dir = root / "build" / "softmax_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, rule in VARIANTS.items():
        cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        cu.write_text(src if rule is None else src.replace(SPLIT_RULE, rule))
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    built = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed ({proc.returncode}):\n{err}")
        built[name] = (so, [ln.strip() for ln in err.splitlines() if "registers" in ln])
    return built


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("softmax_split_ab: no CUDA device", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_ms
    from repro_torch.core.seeds import compute_segments
    from repro_torch.kernels import _build
    from repro_torch.kernels.softmax import softmax_plain
    from repro_torch.kernels.tsdiv import SCHEDULES, _ptr, _stream, _table_c

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    built = build(root)
    fns = {}
    for name, (so, _) in built.items():
        fn = ctypes.CDLL(str(so)).softmax_rows
        fn.argtypes = _build._SIGNATURES["softmax"]["softmax_rows"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    segments = compute_segments(2, 24)
    table = _table_c(segments)
    gen = torch.Generator(device="cuda").manual_seed(0)
    readings, same = {}, {}
    for m, d in SHAPES:
        key = f"{m}x{d}"
        x = torch.randn((m, d), generator=gen, device="cuda") * 4.0
        want, out = softmax_plain(x, segments, 2, "paper"), torch.empty_like(x)

        def call(fn):
            def run():
                rc = fn(_ptr(x), _ptr(out), m, d, 0, table, 2, SCHEDULES["paper"], _stream(x))
                if rc:
                    raise RuntimeError(f"softmax_rows launch failed with CUDA error {rc}")
            return run

        for name, fn in fns.items():
            out.zero_()
            call(fn)()
            torch.cuda.synchronize()
            same[f"{name}_{key}"] = bool(torch.equal(out.view(torch.int32),
                                                     want.view(torch.int32)))
        if not all(same.values()):
            print(json.dumps({"bits_differ": same}), flush=True)
            return 1
        order = list(fns)
        for rnd in range(args.rounds):
            for name in (order if rnd % 2 == 0 else order[::-1]):
                ms = device_ms(call(fns[name]), "softmax_kernel", args.reps)
                readings.setdefault(key, {}).setdefault(name, []).append(ms)
                print(json.dumps({"variant": name, "shape": key, "round": rnd, "device_ms": ms}),
                      flush=True)
        del x, want, out
    mean = {key: {name: sum(r) / len(r) for name, r in by.items()} for key, by in readings.items()}
    print(json.dumps({"root": str(root), "nvidia_smi": smi, "rounds": args.rounds,
                      "reps": args.reps, "same_bits": all(same.values()),
                      "ptxas": {name: regs for name, (_, regs) in built.items()},
                      "mean_device_ms": mean}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
