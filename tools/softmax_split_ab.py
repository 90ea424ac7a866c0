"""Time variants of the softmax kernels in turns on one card: the fused
kernel's one-warp / kSplit-warp choice, or (``--split``) the split softmax
passes' layout.

    python3 tools/softmax_split_ab.py [--root DIR] [--rounds N] [--reps N]
    python3 tools/softmax_split_ab.py --split [--shapes sweep|main] [--root DIR]
                                      [--rounds N] [--reps N]

``--root`` is the root of a checkout of this repository (default: the one
this script lives in). A variant is its ``csrc/softmax.cu`` with one rule
replaced by a constant; ``base`` is the source as it is. Each is compiled
with kernels/_build.py's flags into the checkout's ``build/softmax_split/``
(one nvcc each, all at once) and checked bit for bit against the plain
version on every shape before it is timed as its kernels' device time
(torch.profiler, over ``--reps`` calls) in ``--rounds`` rounds, the
variants in turn and the order reversed every other round. Prints one JSON
line per reading, then one with each shape's mean device ms per variant,
the registers of each build and the card's name and power limit. Needs a
CUDA card and nvcc; imports nothing of JAX.

The fused kernel (default): the choice in ``launch()`` (``SPLIT_RULE``)
forced to ``one_warp`` (``false``: a row of up to kMaxHeld chunks held by
one warp, longer rows read three times) and ``split`` (``true``: every
vector row of up to kMaxSplitHeld chunks held by kSplit warps), timed on
seeded f32 logits of scale 4 under the config's "paper" schedule.
``SHAPES``: 4 to 32 rows an SM (on 132 SMs) at d = 768, 1024, 2112
(decode), 4096 and 8192; rows of 1 to 32 chunks at m = 96; the serving
prefill.

The split passes (``--split``): ``split_layout()``'s rule
(``LAYOUT_RULE``) forced to ``row`` (one block a row in every pass)
and ``A<G>`` (the exp pass's 256 chains a row over G blocks, staged
through shared memory; G = 4, 8, 16, 32); the max pass keeps the rule's
slabs but in ``row``. A checkout whose source
has no such rule (an earlier design) times ``base`` alone: run two
checkouts in turns to compare them. The passes run through
the checkout's own wrappers (``kernels/softmax_split.py``) on seeded f32
logits of scale 6 with -inf lanes, each pass held bit for bit against its
``split_*_plain``; each reading is the device time a launch of each
pass's kernels (``split_max``, ``split_exp``, ``split_scale`` in their
names; ``chip_smoke.device_launches``: the profiler's total over the
launches it recorded, null where it recorded none) and of
``torch.softmax`` on the same rows; the last line gives each variant's
median over the rounds' readings (three or more rounds: one stray reading
moves no median). ``SPLIT_SWEEP``: m in (1, 4, 8, 32,
128, 528) by d in (512, 1032, 8192, 16384, 32768, 65536, 262144);
``SPLIT_MAIN``: the main path's (8, 262144) and (8, 512) (gemma3_12b's
global and ring layers at batch 1) and (128, 1032) (llama3_8b's ``kvseq``
rows).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
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
LAYOUT_RULE = "SplitLayout{max_slabs(m, d, sms), chain_groups(m, d, sms)}"
SPLIT_VARIANTS = {"base": None, "row": "SplitLayout{1, 1}",
                  **{f"A{g}": f"SplitLayout{{max_slabs(m, d, sms), {g}}}"
                     for g in (4, 8, 16, 32)}}
SPLIT_SWEEP = tuple((m, d) for m in (1, 4, 8, 32, 128, 528)
                    for d in (512, 1032, 8192, 16384, 32768, 65536, 262144))
SPLIT_MAIN = ((8, 262144), (8, 512), (128, 1032))
PASSES = ("split_max", "split_exp", "split_scale")


def build(root: Path, rule: str, variants: dict) -> dict:
    """{variant: (library path, ptxas register lines)} of the checkout at
    root: its softmax.cu with ``rule`` replaced by each variant's text
    (None: as it is). A source without ``rule`` builds ``base`` alone."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "softmax.cu").read_text()
    if src.count(rule) > 1:
        raise RuntimeError(f"softmax.cu holds {src.count(rule)} copies of {rule!r}")
    if rule not in src:
        variants = {"base": None}
    out_dir = root / "build" / "softmax_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants.items():
        cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        cu.write_text(src if text is None else src.replace(rule, text))
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


def load(so: Path, names) -> ctypes.CDLL:
    """The library at ``so`` with the argument types of kernels/_build.py."""
    from repro_torch.kernels import _build

    lib = ctypes.CDLL(str(so))
    for fn in names:
        getattr(lib, fn).argtypes = _build._SIGNATURES["softmax"][fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def in_turns(order: list, rounds: int, read) -> None:
    """read(variant, round) for every variant, in turn, the order reversed
    every other round."""
    for rnd in range(rounds):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            read(name, rnd)


def fused(args, root: Path) -> dict:
    from chip_smoke import device_ms
    from repro_torch.core.seeds import compute_segments
    from repro_torch.kernels.softmax import softmax_plain
    from repro_torch.kernels.tsdiv import SCHEDULES, _ptr, _stream, _table_c
    import torch

    built = build(root, SPLIT_RULE, VARIANTS)
    fns = {name: load(so, ["softmax_rows"]).softmax_rows for name, (so, _) in built.items()}
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
            return {"bits_differ": same}

        def read(name, rnd):
            ms = device_ms(call(fns[name]), "softmax_kernel", args.reps)
            readings.setdefault(key, {}).setdefault(name, []).append(ms)
            print(json.dumps({"variant": name, "shape": key, "round": rnd, "device_ms": ms}),
                  flush=True)

        in_turns(list(fns), args.rounds, read)
        del x, want, out
    mean = {key: {name: sum(r) / len(r) for name, r in by.items()} for key, by in readings.items()}
    return {"same_bits": all(same.values()), "built": built, "mean_device_ms": mean}


def split(args, root: Path) -> dict:
    from chip_smoke import device_launches, device_times, summed_ms
    from repro_torch.core.seeds import compute_segments
    from repro_torch.kernels import _build, softmax_split as ks
    import torch

    built = build(root, LAYOUT_RULE, SPLIT_VARIANTS)
    names = [n for n in _build._SIGNATURES["softmax"] if n.startswith("softmax_split_")]
    libs = {name: load(so, names) for name, (so, _) in built.items()}
    table = compute_segments(2, 24)
    gen = torch.Generator(device="cuda").manual_seed(0)
    readings, library, same = {}, {}, {}
    for m, d in (SPLIT_MAIN if args.shapes == "main" else SPLIT_SWEEP):
        key = f"{m}x{d}"
        x = torch.randn((m, d), generator=gen, device="cuda") * 6.0
        x[0, ::3] = -torch.inf
        top_w = ks.split_max_plain(x)
        ex_w, sum_w = ks.split_exp_plain(x, top_w)
        out_w = ks.split_scale_plain(ex_w, sum_w, table, 2, "factored")

        def passes():
            e, s = ks.split_exp(x, ks.split_max(x))
            return ks.split_scale(e, s, 2, 24, "factored")

        def bits(a, b):
            return bool(((a.view(torch.int32) == b.view(torch.int32))
                         | (a.isnan() & b.isnan())).all())

        for name, lib in libs.items():
            _build._libs["softmax"] = lib
            top = ks.split_max(x)
            e, s = ks.split_exp(x, top_w)
            out = ks.split_scale(ex_w, sum_w, 2, 24, "factored")
            torch.cuda.synchronize()
            same[f"{name}_{key}"] = [bits(top, top_w), bits(e, ex_w) and bits(s, sum_w),
                                     bits(out, out_w)]
        if not all(all(v) for v in same.values()):
            return {"bits_differ": {k: v for k, v in same.items() if not all(v)}}
        library[key] = summed_ms(device_times(lambda: torch.softmax(x, -1), args.reps))

        def read(name, rnd):
            _build._libs["softmax"] = libs[name]
            times = device_launches(passes, args.reps)
            ms = {p: summed_ms({k: t for k, (t, _) in times.items()}, p) for p in PASSES}
            ms["all"] = None if None in ms.values() else sum(ms.values())
            readings.setdefault(key, {}).setdefault(name, []).append(ms)
            print(json.dumps({"variant": name, "shape": key, "round": rnd, "device_ms": ms,
                              "launches_recorded": {k: n for k, (_, n) in times.items()}}),
                  flush=True)

        in_turns(list(libs), args.rounds, read)
        del x, top_w, ex_w, sum_w, out_w
        torch.cuda.empty_cache()
    _build._libs.pop("softmax", None)
    median = {key: {name: {p: statistics.median(v) if (v := [r[p] for r in rs if r[p] is not None])
                           else None for p in rs[0]}
                    for name, rs in by.items()} for key, by in readings.items()}
    return {"same_bits": True, "built": built, "median_device_ms": median,
            "torch_softmax_device_ms": library}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--split", action="store_true", help="the split softmax passes' layout")
    ap.add_argument("--shapes", choices=("sweep", "main"), default="sweep",
                    help="with --split: SPLIT_SWEEP or SPLIT_MAIN")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("softmax_split_ab: no CUDA device", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(ROOT))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    result = split(args, root) if args.split else fused(args, root)
    if "bits_differ" in result:
        print(json.dumps(result), flush=True)
        return 1
    built = result.pop("built")
    print(json.dumps({"root": str(root), "nvidia_smi": smi, "rounds": args.rounds,
                      "reps": args.reps, "ptxas": {name: regs for name, (_, regs) in built.items()},
                      **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
