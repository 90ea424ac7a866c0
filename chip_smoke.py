"""Drive the PyTorch port's division unit on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N] [--json PATH]

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc, at
first use), then runs, each phase printing one line:

  1. device    — torch/CUDA versions, the card, the kernel build time;
  2. kernels   — each kernel against its plain PyTorch version on the card,
                 2^22 seeded inputs per schedule, bit for bit;
  3. golden    — the reference's committed golden stores through the port
                 on the card, 0 int ulp (all cells but recip/ilm);
  4. gradients — autograd through div and rsqrt, against the analytic rule
                 evaluated with the plain versions on the card;
  5. kmeans    — K-Means at N=10^6, D=128, K=1024, 10 Lloyd steps (an
                 IVF1024 coarse-quantizer training step at SIFT1M's shape),
                 kernel modes against the exact twin;
  6. qr        — batched Givens QR, 4096 matrices of 64 x 64, via div and
                 via rsqrt, against the exact twin;
  7. calls     — each kernel call site of phases 5-6 once more, on that
                 phase's inputs and through the same entry point, held bit
                 for bit against the plain version (the whole 10^6 x 1024
                 distance plane included, in chunks of 2^26 lanes);
  8. times     — each kernel, its plain version and the torch yardstick, on
                 the K-Means distance plane.

Phases 4-6 are the main path: launch counts are reset before each and read
after it. Any failed check raises, and the script then exits non-zero
without printing a result. It needs a CUDA card and the repository around
it; it imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet, at the 700 W limit
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
# f32 operations per element of each timed body (n_iters=2, factored;
# newton_iters=2), an fma counting two: counted from csrc/tsdiv_body.cuh.
OPS_PER_ELEMENT = {"tsdiv_divide": 52, "tsdiv_recip": 29, "tsdiv_rsqrt": 50}
SOURCE = "src/repro_torch/kernels/csrc/tsdiv.cu"
REPLACES = {"tsdiv_divide": "src/repro/kernels/tsdiv.py:199",
            "tsdiv_recip": "src/repro/kernels/tsdiv.py:122",
            "tsdiv_rsqrt": "src/repro/kernels/tsdiv.py:147"}
N_PLANE, D, K = 1_000_000, 128, 1024
PLAIN_ELEMENTS = 1 << 26


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def corpus(n: int, seed: int) -> np.ndarray:
    """Random f32 bit patterns over all exponents, exponent fields 0, 1,
    253, 254 and 255 with random mantissas, and the IEEE edges."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, n - n // 4, dtype=np.uint64).astype(np.uint32)
    m = n // 4 - 16
    exp = rng.choice(np.array([0, 1, 253, 254, 255], np.uint32), m)
    man = rng.integers(0, 2**23, m, dtype=np.int64).astype(np.uint32)
    sign = rng.integers(0, 2, m).astype(np.uint32) << 31
    edges = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 2.0**-126,
                      2.0**-149, -(2.0**-140), 1.5 * 2.0**126, 2.0**127, 3.4e38,
                      -(2.0**-127), 0.5, 2.0], np.float32)
    return np.concatenate([bits.view(np.float32),
                           (sign | (exp << 23) | man).view(np.float32), edges])


def mismatch(got: torch.Tensor, want: torch.Tensor):
    """(lanes whose bits differ, nan matching nan; max |got - want| there)."""
    same = (got.view(torch.int32) == want.view(torch.int32)) | (got.isnan() & want.isnan())
    bad = ~same
    err = torch.where(bad, (got - want).abs().nan_to_num(nan=float("inf")), 0.0)
    return int(bad.sum()), float(err.max())


def held_to_plain(got: torch.Tensor, plain, *operands: torch.Tensor):
    """Compare a kernel's output with its plain version on the same
    (broadcast) operands, PLAIN_ELEMENTS lanes at a time, so that the plain
    version's temporaries fit at any size: (lanes differing, max abs err)."""
    flat = [t.reshape(-1) for t in torch.broadcast_tensors(*operands)]
    got = got.reshape(-1)
    n_bad, err = 0, 0.0
    for s in range(0, got.numel(), PLAIN_ELEMENTS):
        want = plain(*(t[s:s + PLAIN_ELEMENTS].contiguous() for t in flat))
        b, e = mismatch(got[s:s + PLAIN_ELEMENTS], want)
        n_bad, err = n_bad + b, max(err, e)
    return n_bad, err


def kmeans_data(seed: int):
    from repro_torch.workloads import kmeans

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = kmeans.make_blobs(gen, N_PLANE, D, K, device="cuda")
    return x, x[torch.randperm(N_PLANE, generator=gen, device="cuda")[:K]].clone()


def qr_data(seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    return torch.randn((4096, 64, 64), generator=gen, device="cuda")


def event_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    regs = [line.strip() for line in _build.build_info.get("log", "").splitlines()
            if "registers" in line]
    say("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        nvidia_smi=smi, build_s=round(build_s, 3), ptxas=regs)
    return smi


def phase_kernels(seed: int):
    from repro_torch.core.seeds import compute_segments, rsqrt_seed_table
    from repro_torch.kernels import common, tsdiv

    x = torch.from_numpy(corpus(1 << 22, seed)).cuda()
    a = torch.from_numpy(corpus(1 << 22, seed + 1)).cuda()
    table = compute_segments(2, 24)
    err = {k: 0.0 for k in tsdiv.LAUNCHES}
    rows = []
    for sched in ("paper", "factored", "goldschmidt"):
        for name, got, want in (
                ("tsdiv_recip", tsdiv.recip(x, 2, 24, sched),
                 common.recip_f32_bits(x, table, 2, sched)),
                ("tsdiv_divide", tsdiv.divide(a, x, 2, 24, sched),
                 common.divide_f32_bits(a, x, table, 2, sched))):
            n_bad, e = mismatch(got, want)
            rows.append((name, sched, n_bad))
            err[name] = max(err[name], e)
    n_bad, e = mismatch(tsdiv.rsqrt(x, 2, 16),
                        common.rsqrt_f32_bits(x, rsqrt_seed_table(16), 2))
    rows.append(("tsdiv_rsqrt", "newton2", n_bad))
    err["tsdiv_rsqrt"] = e
    torch.cuda.synchronize()
    say("kernels", elements=x.numel(), mismatched_lanes=rows, max_abs_err=err)
    check(all(r[2] == 0 for r in rows), f"kernel differs from its plain version: {rows}")
    return err


def phase_golden():
    from repro_torch.eval import golden

    failures = (golden.check(device="cuda") + golden.check_divide(device="cuda")
                + golden.check_rsqrt(device="cuda"))
    n = (len(golden.golden_cells()) + len(golden.golden_div_cells())
         + len(golden.golden_rsqrt_cells()) - len(golden.NOT_PORTED))
    say("golden", cells=n, failures=failures)
    check(not failures, f"golden cells drifted: {failures}")


def phase_gradients(seed: int):
    from repro_torch.core import division_modes as dm
    from repro_torch.core.fpparts import finite_or_zero as finite
    from repro_torch.core.seeds import compute_segments, rsqrt_seed_table
    from repro_torch.kernels import common

    rng = np.random.default_rng(seed + 2)
    n = 1 << 20
    a = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    b[:4] = torch.tensor([0.0, -0.0, float("inf"), 1e-40])
    g = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    bad = {}
    for mode in ("taylor_pallas", "goldschmidt_pallas"):
        cfg = dm.DivisionConfig(mode=mode)
        sched = "factored" if mode == "taylor_pallas" else "goldschmidt"
        ta, tb = a.clone().requires_grad_(), b.clone().requires_grad_()
        dm.div(ta, tb, cfg).backward(g)
        rb = finite(common.recip_f32_bits(b, compute_segments(2, 24), 2, sched))
        q = finite(common.divide_f32_bits(a, b, compute_segments(2, 24), 2, sched))
        tx = b.abs().clone().requires_grad_()
        dm.rsqrt(tx, cfg).backward(g)
        r = finite(common.rsqrt_f32_bits(b.abs(), rsqrt_seed_table(16), 2))
        for key, got, want in (("da", ta.grad, g * rb), ("db", tb.grad, -(g * q * rb)),
                               ("dx", tx.grad, g * finite(-0.5 * r * r * r))):
            bad[f"{mode}/{key}"] = mismatch(got, want)[0]
            check(bool(torch.isfinite(got).all()), f"{mode} {key}: non-finite gradient")
    say("gradients", elements=n, mismatched_lanes=bad)
    check(not any(bad.values()), f"gradients differ from the plain versions: {bad}")


def phase_kmeans(seed: int, launches: dict):
    from repro_torch.core import division_modes as dm
    from repro_torch.eval import workload_metrics as wm
    from repro_torch.kernels import tsdiv
    from repro_torch.workloads import kmeans

    x, init = kmeans_data(seed)
    runs, out = {}, {}
    for mode in ("exact", "taylor_pallas", "goldschmidt_pallas"):
        # One warm-up step per mode (cuBLAS handles, allocator growth).
        kmeans.kmeans(x, cfg=dm.DivisionConfig(mode=mode), init=init, n_iters=1,
                      device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tsdiv.reset_launches()
        t0 = time.perf_counter()
        runs[mode] = kmeans.kmeans(x, cfg=dm.DivisionConfig(mode=mode), init=init,
                                   n_iters=10, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(tsdiv.LAUNCHES)
        out[mode] = {"ms_10_steps_plus_final_assignment": wall * 1e3, "launches": counts,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        if mode != "exact":
            for k, v in counts.items():
                launches[k] += v
            check(counts["tsdiv_divide"] == 3 * 10 + 2,
                  f"{mode}: {counts['tsdiv_divide']} divide launches, expected 32")
    ex = runs["exact"]
    for mode in ("taylor_pallas", "goldschmidt_pallas"):
        r = runs[mode]
        out[mode]["inertia_rel_delta"] = wm.relative_delta(r.inertia.cpu().numpy(),
                                                           ex.inertia.cpu().numpy())
        out[mode]["assignment_agreement"] = float(
            (r.assignments == ex.assignments).float().mean())
        check(bool(torch.isfinite(r.centroids).all()), f"{mode}: non-finite centroids")
    say("kmeans", n=N_PLANE, d=D, k=K, n_iters=10,
        exact_inertia=float(ex.inertia), runs=out)
    for mode in ("taylor_pallas", "goldschmidt_pallas"):
        check(out[mode]["inertia_rel_delta"] <= 1e-4, f"{mode}: inertia gate")
        check(out[mode]["assignment_agreement"] >= 0.99, f"{mode}: assignment gate")


def _qr_residuals(q, r, a):
    from repro_torch.eval import workload_metrics as wm

    q, r, a = (t.double().cpu().numpy() for t in (q, r, a))
    rows = [wm.qr_residuals(q[i], r[i], a[i]) for i in range(a.shape[0])]
    return {k: max(row[k] for row in rows) for k in rows[0]}


def phase_qr(seed: int, launches: dict):
    from repro_torch.core import division_modes as dm
    from repro_torch.kernels import tsdiv
    from repro_torch.workloads import qr

    a = qr_data(seed)
    rotations = 64 * 63 // 2
    out = {}
    for via, want in (("div", {"tsdiv_divide": 2 * rotations}),
                      ("rsqrt", {"tsdiv_rsqrt": rotations})):
        q, r = qr.qr_givens_batched(a, dm.EXACT, via=via, device="cuda")
        exact = _qr_residuals(q, r, a)
        torch.cuda.synchronize()
        tsdiv.reset_launches()
        t0 = time.perf_counter()
        q, r = qr.qr_givens_batched(a, dm.DivisionConfig(mode="taylor_pallas"),
                                    via=via, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(tsdiv.LAUNCHES)
        for k, v in counts.items():
            launches[k] += v
        got = _qr_residuals(q, r, a)
        out[via] = {"seconds": wall, "launches": counts, "exact": exact,
                    "taylor_pallas": got}
        for k, v in want.items():
            check(counts[k] == v, f"qr via={via}: {counts[k]} {k} launches, expected {v}")
        for k in ("orthogonality", "reconstruction"):
            check(got[k] <= 2 * exact[k], f"qr via={via}: {k} {got[k]} > 2 x {exact[k]}")
    say("qr", batch=4096, m=64, n=64, runs=out)


def phase_calls(seed: int, err: dict) -> torch.Tensor:
    """Each kernel call of the K-Means and QR paths, made again through the
    same entry point on the same inputs, against the plain version. Returns
    the K-Means distance plane for the times phase."""
    from repro_torch.core import division_modes as dm
    from repro_torch.core.seeds import compute_segments, rsqrt_seed_table
    from repro_torch.kernels import common
    from repro_torch.workloads import kmeans, qr

    def plain_div(cfg):
        table = compute_segments(cfg.n_iters, cfg.precision_bits)
        sched = dm._kernel_schedule(cfg)
        return lambda a, b: common.divide_f32_bits(a, b, table, cfg.n_iters, sched)

    x, init = kmeans_data(seed)
    d2 = kmeans.pairwise_sqdist(x, init)          # the first assignment's plane
    dmin, assign = d2.min(-1)
    counts = torch.bincount(assign, minlength=K).to(x.dtype)[:, None]
    sums = torch.zeros_like(init).index_add_(0, assign, x)
    rows = []
    for mode in ("taylor_pallas", "goldschmidt_pallas"):
        cfg = dm.DivisionConfig(mode=mode)
        for site, a, b in (("kmeans/distance_plane", d2, torch.tensor(float(D), device="cuda")),
                           ("kmeans/inertia", dmin.sum(-1), torch.tensor(float(N_PLANE), device="cuda")),
                           ("kmeans/centroid_update", sums, counts.clamp_min(1.0))):
            got = dm.div(a, b, cfg)
            n_bad, e = held_to_plain(got, plain_div(cfg), a, b)
            del got
            rows.append((mode, site, a.numel(), n_bad))
            err["tsdiv_divide"] = max(err["tsdiv_divide"], e)
    del x, init, dmin, assign, sums

    r0 = qr_data(seed)
    an, bn, t, _ = qr.givens_operands(r0[:, 0, 0], r0[:, 1, 0])   # the first rotation
    cfg = dm.DivisionConfig(mode="taylor_pallas")
    for site, got, plain, ops, name in (
            ("qr/c", dm.div(an, torch.sqrt(t), cfg), plain_div(cfg), (an, torch.sqrt(t)), "tsdiv_divide"),
            ("qr/s", dm.div(bn, torch.sqrt(t), cfg), plain_div(cfg), (bn, torch.sqrt(t)), "tsdiv_divide"),
            ("qr/inv_r", dm.rsqrt(t, cfg),
             lambda v: common.rsqrt_f32_bits(v, rsqrt_seed_table(cfg.rsqrt_segments),
                                             cfg.rsqrt_newton), (t,), "tsdiv_rsqrt")):
        n_bad, e = held_to_plain(got, plain, *ops)
        rows.append(("taylor_pallas", site, got.numel(), n_bad))
        err[name] = max(err[name], e)
    torch.cuda.synchronize()
    say("calls", mismatched_lanes=rows)
    check(all(r[3] == 0 for r in rows), f"a path call differs from the plain version: {rows}")
    return d2


def phase_times(x: torch.Tensor, err: dict, launches: dict):
    from repro_torch.kernels import common, tsdiv
    from repro_torch.core.seeds import compute_segments, rsqrt_seed_table

    torch.cuda.empty_cache()
    n = x.numel()
    d = torch.full_like(x, float(D))          # the divisor as the K-Means path materialises it
    xs = x.view(-1)[:PLAIN_ELEMENTS].clone()
    ds = d.view(-1)[:PLAIN_ELEMENTS].clone()
    table = compute_segments(2, 24)
    cases = {
        "tsdiv_divide": (lambda: tsdiv.divide(x, d, 2, 24, "factored"),
                         lambda: common.divide_f32_bits(xs, ds, table, 2, "factored"),
                         lambda: torch.div(x, d), 12),
        "tsdiv_recip": (lambda: tsdiv.recip(x, 2, 24, "factored"),
                        lambda: common.recip_f32_bits(xs, table, 2, "factored"),
                        lambda: torch.reciprocal(x), 8),
        "tsdiv_rsqrt": (lambda: tsdiv.rsqrt(x, 2, 16),
                        lambda: common.rsqrt_f32_bits(xs, rsqrt_seed_table(16), 2),
                        lambda: torch.rsqrt(x), 8),
    }
    rows = []
    for name, (kernel, plain, library, bytes_per) in cases.items():
        ms = event_ms(kernel)
        bytes_ms = bytes_per * n / HBM_BYTES_PER_S * 1e3
        ops_ms = OPS_PER_ELEMENT[name] * n / F32_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": event_ms(plain, 3),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": event_ms(library), "elements": n,
            "plain_elements": PLAIN_ELEMENTS})
        say("times", **rows[-1])
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", type=Path, help="also write the full result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing is reported", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import tsdiv

    t_start = time.perf_counter()
    smi = phase_device()
    err = phase_kernels(args.seed)
    phase_golden()
    launches = {k: 0 for k in tsdiv.LAUNCHES}
    tsdiv.reset_launches()
    phase_gradients(args.seed)
    for k, v in tsdiv.LAUNCHES.items():
        launches[k] += v
    phase_kmeans(args.seed, launches)
    phase_qr(args.seed, launches)
    check(all(launches.values()), f"a kernel was not launched on the main path: {launches}")
    plane = phase_calls(args.seed, err)
    rows = phase_times(plane, err, launches)
    result = {"kernels": rows}
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(
            {**result, "nvidia_smi": smi, "seconds": time.perf_counter() - t_start},
            indent=1))
    print(json.dumps(result))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
