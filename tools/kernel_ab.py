"""Time the division-unit kernels of one checkout on the card and count
their SASS instructions, so that two checkouts can be compared in turns
inside one run on one card.

    python3 tools/kernel_ab.py [--root DIR] [--label NAME] [--reps N]

``--root`` is the root of a checkout of this repository (default: the one
this script lives in); its ``src/repro_torch`` is imported and its CUDA
libraries are built from its own sources into its own ``build/``. Prints
one JSON line: the card (name and power limit as nvidia-smi gives them),
the time of ``tsdiv_rsqrt``, ``tsdiv_recip`` and ``tsdiv_divide`` at the
K-Means plane's shape (10^6 x 1024 f32, uniform random x in [0.01, 100];
divide by a constant 128 and, as ``tsdiv_divide_random_divisor``, 128 / x)
and of ``kernels.flash_attention``
on seeded q/k/v of (96, 2048, 64), causal, in bf16 and in f32 (CUDA events
over ``--reps`` launches after a warm-up; f32 also as its kernel's device
time); ``rmsnorm`` at the serving prefill shape (16384, 768) bf16 with a
bf16 weight, ``softmax`` at the serving prefill and decode shapes ((196608,
2048) and (96, 2112) f32) and at decode steps of longer contexts ((96,
4096) and (96, 8192)), seeded logits of scale 4, the config's "paper"
schedule, beside ``torch.softmax``, and ``ilm_mul`` and ``ilm_square`` on
2^24 operands (pairs) below 2^16 at iters 16 and 4, each also as its
kernel's device time from torch.profiler (``device_ms``; ``torch.softmax``
as all of its kernels); and for every kernel function of every library
its static SASS instruction count (``cuobjdump -sass``, NOPs left out), its
local-memory instructions (LDL/STL: a spilled or indexed local copy), and
the instructions from its first global load to the next global store,
divided by the elements one such pass handles (4 after a 128-bit load).
``per_element`` gives the ILM kernels' such counts, and the RMSNorm
kernel's (the bf16 instantiation that runs at d = 768) and the softmax
kernel's (the f32 instantiation that runs at d = 2048) static instructions
over the elements one thread handles in such a row. Needs a CUDA card and ``cuobjdump``;
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

N_PLANE, K = 1_000_000, 1024
RMS_SHAPE = (16384, 768)
SOFTMAX_SHAPES = {"prefill": (196608, 2048), "decode": (96, 2112),
                  "decode_4096": (96, 4096), "decode_8192": (96, 8192)}
ILM_LANES = 1 << 24
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_counts(so: Path) -> dict:
    """{kernel function: {instructions, local, load_to_store_per_element}}."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    out, name, ops = {}, None, []

    def close():
        if name is None:
            return
        body = [o for o in ops if o != "NOP"]
        first = next((i for i, o in enumerate(body) if o.startswith("LDG")), None)
        per = None
        if first is not None:
            last = next((i for i in range(first, len(body)) if body[i].startswith("STG")), None)
            if last is not None:
                per = (last - first + 1) / (4 if ".128" in body[first] else 1)
        out[name] = {"instructions": len(body),
                     "local": sum(o.startswith(("LDL", "STL")) for o in body),
                     "load_to_store_per_element": per}

    for line in text.splitlines():
        if "Function :" in line:
            close()
            name, ops = line.split("Function :", 1)[1].strip(), []
        elif name is not None:
            m = _INSN.search(line)
            if m:
                ops.append(m.group(1))
    close()
    return out


def per_element(sass: dict) -> dict:
    """SASS instructions per element of the ILM kernels, of RMSNorm at
    d = 768 bf16 and of softmax at d = 2048 f32: the held-in-registers
    instantiation (24 and 64 elements a thread) where the checkout has it,
    else the block-per-row kernel (3 and 8 elements a thread; its loops
    run that many times, so its static count is not its dynamic one)."""
    sq = [v for k, v in sass["ilm"].items() if "ilm_square_kernel" in k]
    mul = [v for k, v in sass["ilm"].items() if "ilm_mul_kernel" in k]
    rms = sass["rmsnorm"]
    held = [v for k, v in rms.items() if "bfloat16" in k and "Lb1ELi3E" in k]
    block = [v for k, v in rms.items() if "rmsnorm_kernelI13__nv_bfloat16EEv" in k]
    sm = sass["softmax"]
    sm_held = [v for k, v in sm.items() if "softmax_kernelIfLb1ELi9ELi1E" in k]
    sm_block = [v for k, v in sm.items() if "softmax_kernelIfEEv" in k]
    d_sm = SOFTMAX_SHAPES["prefill"][1]
    return {"ilm_square": sq[0]["load_to_store_per_element"] if sq else None,
            "ilm_mul": mul[0]["load_to_store_per_element"] if mul else None,
            "rmsnorm_bf16_d768": (held[0]["instructions"] / (RMS_SHAPE[1] / 32) if held else
                                  block[0]["instructions"] / (RMS_SHAPE[1] / 256) if block
                                  else None),
            "softmax_f32_d2048": (sm_held[0]["instructions"] / (d_sm / 32) if sm_held else
                                  sm_block[0]["instructions"] / (d_sm / 256) if sm_block
                                  else None)}


def softmax_times(softmax, reps: int, gen) -> tuple:
    """({name: event ms}, {name: device ms}) of the softmax kernel and of
    torch.softmax at SOFTMAX_SHAPES."""
    import torch
    from chip_smoke import device_ms, event_ms

    times, dev = {}, {}
    for step, shape in SOFTMAX_SHAPES.items():
        x = torch.randn(shape, generator=gen, device="cuda") * 4.0
        fn = lambda: softmax.softmax(x, 2, 24, "paper")
        times[f"softmax_{step}"] = event_ms(fn, reps)
        dev[f"softmax_{step}"] = device_ms(fn, "softmax_kernel", reps)
        times[f"torch.softmax_{step}"] = event_ms(lambda: torch.softmax(x, -1), reps)
        dev[f"torch.softmax_{step}"] = device_ms(lambda: torch.softmax(x, -1), None, reps)
        del x
    return times, dev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve() / "src"))
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import device_ms, event_ms
    from repro_torch.kernels import _build, flash_attention, ilm, rmsnorm, softmax, tsdiv

    _build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((N_PLANE, K), generator=gen, device="cuda") * 100.0 + 0.01
    d = torch.full_like(x, 128.0)

    times = {"tsdiv_rsqrt": event_ms(lambda: tsdiv.rsqrt(x, 2, 16), args.reps),
             "tsdiv_recip": event_ms(lambda: tsdiv.recip(x, 2, 24, "factored"), args.reps),
             "tsdiv_divide": event_ms(lambda: tsdiv.divide(x, d, 2, 24, "factored"), args.reps),
             "tsdiv_divide_random_divisor": event_ms(
                 lambda: tsdiv.divide(d, x, 2, 24, "factored"), args.reps),
             "torch.rsqrt": event_ms(lambda: torch.rsqrt(x), args.reps)}
    del x, d
    dev = {}
    q, k, v = (torch.randn((96, 2048, 64), generator=gen, device="cuda") for _ in range(3))
    for name, dtype in (("flash_attention_bf16_input", torch.bfloat16),
                        ("flash_attention_f32_input", torch.float32)):
        qd, kd, vd = (t.to(dtype) for t in (q, k, v))
        attn = lambda: flash_attention.flash_attention(qd, kd, vd)
        times[name] = event_ms(attn, args.reps)
        if dtype == torch.float32:
            dev[name] = device_ms(attn, "flash_kernel", args.reps)
        del qd, kd, vd
    del q, k, v
    xr = torch.randn(RMS_SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(RMS_SHAPE[1], generator=gen, device="cuda").to(torch.bfloat16)
    norm = lambda: rmsnorm.rmsnorm(xr, w, 1e-6, 2, 16)
    times["rmsnorm_bf16"] = event_ms(norm, args.reps)
    dev["rmsnorm_bf16"] = device_ms(norm, "rmsnorm_kernel", args.reps)
    sm_times, sm_dev = softmax_times(softmax, args.reps, gen)
    times.update(sm_times)
    dev.update(sm_dev)
    a, b = (torch.randint(1, 2**16, (ILM_LANES,), generator=gen, device="cuda").to(torch.int32)
            .view(torch.uint32) for _ in range(2))
    for it in (16, 4):
        for name, fn in (("ilm_square", lambda: ilm.ilm_square(a, it)),
                         ("ilm_mul", lambda: ilm.ilm_mul(a, b, it))):
            times[f"{name}_iters{it}"] = event_ms(fn, args.reps)
            dev[f"{name}_iters{it}"] = device_ms(fn, f"{name}_kernel", args.reps)
    sass = {lib: sass_counts(_build._so_path(lib)) for lib in _build.LIBRARIES}
    print(json.dumps({"label": args.label, "root": str(args.root), "nvidia_smi": smi,
                      "shape": [N_PLANE, K], "ms": times, "device_ms": dev,
                      "per_element": per_element(sass), "sass": sass}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
