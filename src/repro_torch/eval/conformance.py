"""Conformance runner: delivered ULP accuracy over (mode x schedule x n_iters x dtype).

The PyTorch counterpart of ``src/repro/eval/conformance.py``: the same grid,
corpora (:mod:`.ulp`, :mod:`.consumers`), masks, gates and report, with the
division unit run through the port's modes on a chosen device:

    PYTHONPATH=src python -m repro_torch.eval.conformance --quick --device cpu
    PYTHONPATH=src python -m repro_torch.eval.conformance --json out.json
    PYTHONPATH=src python -m repro_torch.eval.conformance --quick --fanout 2

On the card (the default device) the kernel modes run the tsdiv, softmax
and RMSNorm kernels; on the CPU they run the kernels' plain versions. The
five algorithm families on identical footing: exact (torch's own
arithmetic), Taylor with the paper's §6 schedule, Taylor factored,
Goldschmidt (plus its fused-kernel twin), and the 16-bit ILM emulation; op
in {recip, div, rsqrt} plus the consumer tier {softmax, rmsnorm}. Masking
is underflow-policy-aware: gradual cells measure subnormal operands and
results, FTZ cells exclude them as the flush edge class. ``exact`` is
gradual here (torch keeps subnormals, F4) where the reference's XLA CPU
backend flushes, so its masks keep the subnormal lanes. The process exits
non-zero if any cell fails its gate (edge contract, or > 2 max ULP at the
n >= 2 non-ILM operating points).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.convert import tensor_from_numpy as _t
from repro_torch.core.division_modes import (MODES, DivisionConfig, div,
                                             effective_underflow, recip,
                                             rmsnorm, rsqrt, softmax)
from repro_torch.core.seeds import compute_segments
from . import consumers, ulp

__all__ = ["Cell", "DIAL", "GATE_MAX_ULP", "default_grid", "run_cell",
           "run_conformance", "format_table", "cell_gate", "cell_lookup",
           "main"]

# (n_iters, precision_bits) operating points: the paper's accuracy dial.
DIAL = ((1, 12), (2, 24), (3, 30))

# The eq. 17 operating point: every non-ILM cell at n >= 2 must deliver
# <= 2 max ULP (the paper's gate); n=1 @ 12-bit is the loose end of the
# dial by design and is not ULP-gated. ILM is ~12-bit by construction.
GATE_MAX_ULP = 2.0

# Seconds a --fanout worker may take (the full grid takes ~3 min on the CPU).
FANOUT_WORKER_TIMEOUT_S = 1800.0


@dataclasses.dataclass(frozen=True)
class Cell:
    """One conformance grid cell. schedule '-' = not applicable to the mode."""

    mode: str
    schedule: str = "-"
    n_iters: int = 2
    precision_bits: int = 24
    dtype: str = "float32"
    op: str = "recip"

    @property
    def key(self) -> str:
        return f"{self.op}/{self.mode}/{self.schedule}/n{self.n_iters}" \
               f"p{self.precision_bits}/{self.dtype}"

    def config(self) -> DivisionConfig:
        sched = self.schedule if self.schedule != "-" else "factored"
        return DivisionConfig(mode=self.mode, n_iters=self.n_iters,
                              precision_bits=self.precision_bits,
                              schedule=sched)


def default_grid(dtypes: Sequence[str] = ulp.DTYPES,
                 dial: Sequence = DIAL, quick: bool = False) -> List[Cell]:
    """Every (op x mode x schedule x n_iters x dtype) cell of the grid.

    op=rsqrt runs at the f32 operating point only (its dial is
    ``rsqrt_newton``; both kernel modes share the one fused rsqrt kernel, so
    the goldschmidt_pallas rsqrt column is collapsed into taylor_pallas).
    The consumer ops run at the (2, 24) operating point across every mode.
    """
    if quick:
        dial = [d for d in dial if d == (2, 24)] or [dial[0]]
    cells: List[Cell] = []
    for dt in dtypes:
        for op in ("recip", "div"):
            cells.append(Cell("exact", dtype=dt, op=op))
            for n, p in dial:
                for sched in ("paper", "factored"):
                    cells.append(Cell("taylor", sched, n, p, dt, op=op))
                cells.append(Cell("taylor_pallas", "factored", n, p, dt, op=op))
                cells.append(Cell("goldschmidt", "-", n, p, dt, op=op))
                cells.append(Cell("goldschmidt_pallas", "-", n, p, dt, op=op))
            # ILM carries ~12 mantissa bits by construction — one cell each.
            cells.append(Cell("ilm", "-", 2, 24, dt, op=op))
        cells.append(Cell("exact", dtype=dt, op="rsqrt"))
        for sched in ("paper", "factored"):
            cells.append(Cell("taylor", sched, 2, 24, dt, op="rsqrt"))
        cells.append(Cell("taylor_pallas", "factored", 2, 24, dt, op="rsqrt"))
        cells.append(Cell("goldschmidt", "-", 2, 24, dt, op="rsqrt"))
        cells.append(Cell("ilm", "-", 2, 24, dt, op="rsqrt"))
        for op in consumers.CONSUMER_OPS:
            cells.append(Cell("exact", dtype=dt, op=op))
            for sched in ("paper", "factored"):
                cells.append(Cell("taylor", sched, 2, 24, dt, op=op))
            cells.append(Cell("taylor_pallas", "factored", 2, 24, dt, op=op))
            cells.append(Cell("goldschmidt", "-", 2, 24, dt, op=op))
            cells.append(Cell("goldschmidt_pallas", "-", 2, 24, dt, op=op))
            cells.append(Cell("ilm", "-", 2, 24, dt, op=op))
    return cells


# ---------------------------------------------------- torch -> numpy, bits kept

def _np(t: torch.Tensor, dtype: str) -> np.ndarray:
    """A tensor back to numpy in the cell's dtype, bits kept."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ulp._resolve_dtype(dtype))
    return t.numpy()


# ------------------------------------------------------------ edge contracts

def _edge_failures(x64: np.ndarray, r64: np.ndarray) -> int:
    """IEEE contract on the edge corpus: +-0 -> +-inf, +-inf -> +-0, nan -> nan."""
    fails = 0
    zero = x64 == 0
    fails += int(np.sum(zero & ~(np.isinf(r64)
                                 & (np.signbit(r64) == np.signbit(x64)))))
    inf = np.isinf(x64)
    fails += int(np.sum(inf & ~((r64 == 0)
                                & (np.signbit(r64) == np.signbit(x64)))))
    nan = np.isnan(x64)
    fails += int(np.sum(nan & ~np.isnan(r64)))
    return fails


def _div_edge_failures(a64: np.ndarray, b64: np.ndarray,
                       q64: np.ndarray) -> int:
    """IEEE special-value contract for a/b on the operand-edge corpus.

    Only the lanes whose outcome is fixed by the operands' special values;
    subnormal operands are the FTZ class and leave the sign-rule lanes.
    """
    sign = np.signbit(a64) ^ np.signbit(b64)
    a_zero, b_zero = a64 == 0, b64 == 0
    a_inf, b_inf = np.isinf(a64), np.isinf(b64)
    a_nan, b_nan = np.isnan(a64), np.isnan(b64)
    finite_a = np.isfinite(a64)
    finite_b = np.isfinite(b64)
    tiny = np.ldexp(1.0, -126)          # f32 and bf16 share emin = -126
    subn = (((a64 != 0) & finite_a & (np.abs(a64) < tiny))
            | ((b64 != 0) & finite_b & (np.abs(b64) < tiny)))
    a_zero, b_zero = a_zero & ~subn, b_zero & ~subn
    a_inf, b_inf = a_inf & ~subn, b_inf & ~subn
    fails = 0
    # x/0 (x finite nonzero or inf) -> signed inf.
    lane = b_zero & ~a_zero & ~a_nan
    fails += int(np.sum(lane & ~(np.isinf(q64) & (np.signbit(q64) == sign))))
    # 0/y (y nonzero finite or inf) -> signed zero.
    lane = a_zero & ~b_zero & ~b_nan
    fails += int(np.sum(lane & ~((q64 == 0) & (np.signbit(q64) == sign))))
    # inf/y (y finite) -> signed inf;  x/inf (x finite) -> signed zero.
    lane = a_inf & finite_b & ~b_nan
    fails += int(np.sum(lane & ~(np.isinf(q64) & (np.signbit(q64) == sign))))
    lane = b_inf & finite_a & ~a_nan
    fails += int(np.sum(lane & ~((q64 == 0) & (np.signbit(q64) == sign))))
    # Invalid: 0/0, inf/inf, any nan operand -> nan.
    lane = (a_zero & b_zero) | (a_inf & b_inf) | a_nan | b_nan
    fails += int(np.sum(lane & ~np.isnan(q64)))
    return fails


def _rsqrt_edge_failures(x64: np.ndarray, r64: np.ndarray) -> int:
    """IEEE contract for rsqrt on the edge corpus: +-0 -> +-inf, +inf -> +0,
    x < 0 (incl. -inf) -> nan, nan -> nan; subnormal operands are judged by
    the ULP strata instead."""
    subn = np.isfinite(x64) & (x64 != 0) & (np.abs(x64) < np.ldexp(1.0, -126))
    fails = 0
    zero = (x64 == 0) & ~subn
    fails += int(np.sum(zero & ~(np.isinf(r64)
                                 & (np.signbit(r64) == np.signbit(x64)))))
    fails += int(np.sum(np.isposinf(x64)
                        & ~((r64 == 0) & ~np.signbit(r64))))
    neg = (x64 < 0) & ~subn
    fails += int(np.sum(neg & ~np.isnan(r64)))
    fails += int(np.sum(np.isnan(x64) & ~np.isnan(r64)))
    return fails


def _softmax_edge_failures(cfg: DivisionConfig, dtype: str, device) -> int:
    """Masked-softmax contract on the edge rows: fully-masked row -> exact
    zeros, single-survivor row -> 1 within 2 ULP-equivalents (ILM: 2^-10)
    and zeros elsewhere, nan row -> nan everywhere."""
    p, _, _ = ulp._fmt(dtype)
    rows = consumers.softmax_edge_rows(dtype)
    out = _np(softmax(_t(rows, device), -1, cfg), dtype).astype(np.float64)
    tol = 2.0 ** -10 if cfg.mode == "ilm" else 2.0 * 2.0 ** (1 - p)
    fails = int(np.sum(out[0] != 0.0))
    fails += int(not abs(out[1, 0] - 1.0) <= tol)
    fails += int(np.sum(out[1, 1:] != 0.0))
    fails += int(np.sum(~np.isnan(out[2])))
    return fails


def _rmsnorm_edge_failures(cfg: DivisionConfig, dtype: str, device) -> int:
    """RMSNorm edge contract: an all-zero row normalizes to exact zeros and
    a nan row propagates nan, in every mode."""
    dt = ulp._resolve_dtype(dtype)
    d = 16
    rows = np.zeros((2, d)).astype(dt)
    rows[1, :] = 1.0
    rows[1, d // 2] = np.nan
    w = _t(consumers.rmsnorm_weight(d), device)
    out = _np(rmsnorm(_t(rows, device), w, cfg), dtype).astype(np.float64)
    fails = int(np.sum(out[0] != 0.0))
    fails += int(np.sum(~np.isnan(out[1])))
    return fails


# ---------------------------------------------------------------- the grid

def run_cell(cell: Cell, n_log: int = 4096, n_man: int = 4096,
             seed: int = 0, device="cuda") -> Dict:
    """Measure one cell over the stratified sweep on ``device``; returns a
    report dict with the reference's keys.

    Gradual cells keep subnormal operands and results inside the ULP
    statistics; FTZ cells (fused kernels, ILM) exclude them as the flush
    edge class.
    """
    cfg = cell.config()
    gradual = effective_underflow(cfg) == "gradual"
    table = compute_segments(cell.n_iters, cell.precision_bits)
    t0 = time.perf_counter()
    per_stratum: Dict[str, Dict] = {}
    edge_fail = 0
    agg: List[np.ndarray] = []
    extra: Dict = {}       # op-specific gated metrics (consumer cells)

    def measure(name: str, r_np: np.ndarray, exact: np.ndarray,
                mask: np.ndarray) -> None:
        errs = ulp.ulp_error(r_np, exact, cell.dtype, where=mask)
        per_stratum[name] = ulp.summarize(errs, mask)
        agg.append(errs[mask])

    def operand_mask(x64: np.ndarray) -> np.ndarray:
        m = ulp.oracle_mask(x64, cell.dtype)
        if gradual:
            m = m | ulp.subnormal_mask(x64, cell.dtype)
        return m

    def result_mask(exact: np.ndarray, cliffs: bool) -> np.ndarray:
        m = ulp.oracle_mask(exact, cell.dtype)
        if cliffs:
            m = m & (ulp.cliff_guard(exact, cell.dtype) if not gradual
                     else ulp.overflow_guard(exact, cell.dtype))
        if gradual:
            m = m | ulp.subnormal_mask(exact, cell.dtype)
        return m

    if cell.op == "div":
        pairs = ulp.div_sweep(cell.dtype, n_log=n_log, n_man=n_man,
                              boundaries=table.boundaries, seed=seed)
        for name, (a_s, b_s) in pairs.items():
            a64 = np.asarray(a_s).astype(np.float64)
            b64 = np.asarray(b_s).astype(np.float64)
            q_np = _np(div(_t(a_s, device), _t(b_s, device), cfg), cell.dtype)
            with np.errstate(divide="ignore", invalid="ignore"):
                exact = a64 / b64
            mask = (result_mask(exact, cliffs=True)
                    & operand_mask(a64) & operand_mask(b64))
            measure(name, q_np, exact, mask)
            if name == "subnormals":
                q64 = q_np.astype(np.float64)
                per_stratum[name]["ftz_frac"] = float(
                    np.mean(np.isinf(q64) | (q64 == 0)))
            if name == "edges":
                edge_fail = _div_edge_failures(a64, b64,
                                               q_np.astype(np.float64))
    elif cell.op == "rsqrt":
        strata = ulp.rsqrt_sweep(cell.dtype, n_log=n_log, n_man=n_man,
                                 seed=seed)
        for name, xs in strata.items():
            x64 = np.asarray(xs).astype(np.float64)
            r_np = _np(rsqrt(_t(xs, device), cfg), cell.dtype)
            with np.errstate(divide="ignore", invalid="ignore"):
                exact = 1.0 / np.sqrt(x64)     # x<0 -> nan, 0 -> inf
            mask = result_mask(exact, cliffs=False) & operand_mask(x64)
            measure(name, r_np, exact, mask)
            if name == "subnormals":
                r64 = r_np.astype(np.float64)
                per_stratum[name]["ftz_frac"] = float(
                    np.mean(np.isinf(r64) | (r64 == 0)))
            if name == "edges":
                edge_fail = _rsqrt_edge_failures(x64,
                                                 r_np.astype(np.float64))
    elif cell.op in consumers.CONSUMER_OPS:
        # Oracle ULP stats are informational; the gated numbers are the
        # vs-exact-twin integer ULP and, for softmax, the row-sum accuracy.
        exact_cfg = DivisionConfig(mode="exact")
        rows = max(8, min(n_log, 4096) // 64)
        d = 128
        row_sum_max = 0.0
        vs_exact_max = 0
        if cell.op == "softmax":
            strata_rows = consumers.softmax_rows(cell.dtype, rows, d, seed)
        else:
            strata_rows = consumers.rmsnorm_rows(cell.dtype, rows, d, seed)
            w = consumers.rmsnorm_weight(d, seed)
            wt = _t(w, device)
        for name, xs in strata_rows.items():
            xt = _t(xs, device)
            x64 = np.asarray(xs).astype(np.float64)
            if cell.op == "softmax":
                out = _np(softmax(xt, -1, cfg), cell.dtype)
                twin = _np(softmax(xt, -1, exact_cfg), cell.dtype)
                exact = consumers.softmax_oracle(x64)
                mask = ulp.oracle_mask(exact, cell.dtype)
            else:
                out = _np(rmsnorm(xt, wt, cfg), cell.dtype)
                twin = _np(rmsnorm(xt, wt, exact_cfg), cell.dtype)
                exact = consumers.rmsnorm_oracle(x64, w.astype(np.float64))
                mask = (ulp.oracle_mask(exact, cell.dtype)
                        & ~ulp.subnormal_mask(x64, cell.dtype))
            measure(name, out, exact, mask)
            ve = consumers.vs_exact_int_ulp(out, twin, exact, cell.dtype)
            per_stratum[name]["vs_exact_max_ulp"] = ve
            vs_exact_max = max(vs_exact_max, ve)
            if cell.op == "softmax":
                rs = float(consumers.row_sum_ulp1(out, cell.dtype).max())
                per_stratum[name]["row_sum_max_ulp1"] = rs
                row_sum_max = max(row_sum_max, rs)
        if cell.op == "softmax":
            edge_fail = _softmax_edge_failures(cfg, cell.dtype, device)
        else:
            edge_fail = _rmsnorm_edge_failures(cfg, cell.dtype, device)
        extra = {"vs_exact_max_ulp": vs_exact_max}
        if cell.op == "softmax":
            extra["row_sum_max_ulp1"] = row_sum_max
    else:
        strata = ulp.stratified_sweep(cell.dtype, n_log=n_log, n_man=n_man,
                                      boundaries=table.boundaries, seed=seed)
        for name, xs in strata.items():
            x64 = np.asarray(xs).astype(np.float64)
            r_np = _np(recip(_t(xs, device), cfg), cell.dtype)
            with np.errstate(divide="ignore", invalid="ignore"):
                exact = 1.0 / x64          # IEEE: +-0 -> +-inf, +-inf -> +-0
            mask = result_mask(exact, cliffs=gradual) & operand_mask(x64)
            measure(name, r_np, exact, mask)
            if name == "subnormals":
                per_stratum[name]["ftz_frac"] = float(
                    np.mean(np.isinf(r_np.astype(np.float64))))
            if name == "edges":
                edge_fail = _edge_failures(x64, r_np.astype(np.float64))
    allv = np.concatenate(agg) if agg else np.zeros(0)
    out = dataclasses.asdict(cell)
    out.update({
        "key": cell.key,
        "underflow": effective_underflow(cfg),
        "overall": ulp.summarize(allv),
        "strata": per_stratum,
        "edge_failures": edge_fail,
        "seconds": round(time.perf_counter() - t0, 3),
    })
    out.update(extra)
    out["pass"] = cell_gate(out)
    return out


def run_conformance(cells: Optional[Sequence[Cell]] = None, *,
                    n_log: int = 4096, n_man: int = 4096,
                    quick: bool = False, seed: int = 0,
                    device="cuda") -> Dict:
    """Run the grid on ``device``; returns {meta, cells: [...]},
    JSON-serializable."""
    if cells is None:
        cells = default_grid(quick=quick)
    if quick:
        n_log, n_man = min(n_log, 1024), min(n_man, 1024)
    dev = torch.device(device)
    return {
        "meta": {
            "torch": torch.__version__,
            "numpy": np.__version__,
            "device": str(dev),
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
            "sweep": {"n_log": n_log, "n_man": n_man, "seed": seed},
        },
        "cells": [run_cell(c, n_log=n_log, n_man=n_man, seed=seed,
                           device=dev) for c in cells],
    }


def cell_gate(cell_report: Dict) -> bool:
    """Pass/fail verdict for one measured cell, as the reference's.

    Every cell honours the IEEE edge contract and gives finite ULP
    statistics; non-ILM cells at n_iters >= 2 deliver <= 2 max ULP. Consumer
    cells swap the oracle-ULP gate for the vs-exact-twin integer ULP and,
    for softmax, the row-sum accuracy.
    """
    o = cell_report["overall"]
    ok = cell_report["edge_failures"] == 0 and np.isfinite(o["max_ulp"])
    if cell_report.get("op") in consumers.CONSUMER_OPS:
        if cell_report["mode"] != "ilm" and cell_report["n_iters"] >= 2:
            ok = ok and (cell_report["vs_exact_max_ulp"]
                         <= consumers.VS_EXACT_GATE_ULP)
            if cell_report["op"] == "softmax":
                ok = ok and (cell_report["row_sum_max_ulp1"]
                             <= consumers.ROW_SUM_GATE_ULP)
        return bool(ok)
    if cell_report["mode"] != "ilm" and cell_report["n_iters"] >= 2:
        ok = ok and o["max_ulp"] <= GATE_MAX_ULP
    return bool(ok)


def cell_lookup(report: Dict, **kw) -> Dict:
    """First report cell matching all given field values (mode=, dtype=, ...)."""
    for c in report["cells"]:
        if all(c.get(k) == v for k, v in kw.items()):
            return c
    raise KeyError(f"no cell matching {kw}")


def format_table(report: Dict) -> str:
    """Human-readable mode x schedule x n_iters ULP table."""
    hdr = (f"{'op':5s} {'mode':18s} {'schedule':10s} {'n':>2s} {'bits':>4s} "
           f"{'dtype':9s} {'uflow':7s} {'max_ulp':>10s} {'mean_ulp':>10s} "
           f"{'p99':>8s} {'edges':>5s} {'gate':>5s}")
    lines = [hdr, "-" * len(hdr)]
    for c in report["cells"]:
        o = c["overall"]
        lines.append(
            f"{c['op']:5s} {c['mode']:18s} {c['schedule']:10s} "
            f"{c['n_iters']:2d} {c['precision_bits']:4d} {c['dtype']:9s} "
            f"{c.get('underflow', '-'):7s} "
            f"{o['max_ulp']:10.3f} {o['mean_ulp']:10.4f} {o['p99_ulp']:8.3f} "
            f"{'ok' if c['edge_failures'] == 0 else c['edge_failures']:>5} "
            f"{'pass' if c.get('pass', True) else 'FAIL':>5}")
    return "\n".join(lines)


def _emit(report: Dict, json_path: Optional[str]) -> int:
    """Table, optional JSON, pass/fail exit code."""
    print(format_table(report))
    if json_path:
        with open(json_path, "w") as f:
            json.dump(report, f, indent=1)
        print(f"# wrote {json_path}")
    failing = [c["key"] for c in report["cells"] if not c.get("pass", True)]
    if failing:
        print(f"# CONFORMANCE FAILURES ({len(failing)} cells):")
        for k in failing:
            print(f"#   {k}")
        return 1
    return 0


def _worker_cmd(args, k: int, n: int, json_path: str) -> List[str]:
    """The command line of fanout worker ``k`` of ``n``."""
    cmd = [sys.executable, "-m", "repro_torch.eval.conformance", "--seed",
           str(args.seed), "--device", args.device, "--shard", f"{k}/{n}",
           "--json", json_path]
    if args.quick:
        cmd.append("--quick")
    if args.modes:
        cmd += ["--modes", args.modes]
    return cmd


def _run_fanout(args, n: int) -> int:
    """Run the grid as ``n`` worker subprocesses, ``--shard k/n`` each, and
    merge their reports, as the reference's ``--fanout`` does.

    Worker k takes the interleaved slice ``cells[k::n]``, so ``merged[k::n]
    = shard_k`` restores the single process's cell order. A worker that
    writes no report, exits with a code its report does not explain (0 when
    its cells pass, 1 when one fails its gate) or outlives
    ``FANOUT_WORKER_TIMEOUT_S`` fails the run and is named; the others are
    then stopped.
    """
    import os
    import subprocess
    import tempfile

    src_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = src_root + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as td:
        paths = [os.path.join(td, f"shard{k}.json") for k in range(n)]
        logs = [open(os.path.join(td, f"shard{k}.log"), "w+") for k in range(n)]
        procs = [subprocess.Popen(_worker_cmd(args, k, n, paths[k]), env=env,
                                  stdout=subprocess.DEVNULL, stderr=logs[k])
                 for k in range(n)]
        deadline = time.monotonic() + FANOUT_WORKER_TIMEOUT_S
        rcs: List[Optional[int]] = [None] * n
        try:
            for k, p in enumerate(procs):
                try:
                    rcs[k] = p.wait(timeout=max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        shards, bad = [], []
        for k, path in enumerate(paths):
            report = None
            if os.path.exists(path):
                with open(path) as f:
                    report = json.load(f)
            if rcs[k] is None:
                bad.append(f"shard {k}/{n} did not finish within {FANOUT_WORKER_TIMEOUT_S} s")
            elif report is None:
                bad.append(f"shard {k}/{n} wrote no report (exit {rcs[k]})")
            elif rcs[k] != int(any(not c.get("pass", True) for c in report["cells"])):
                bad.append(f"shard {k}/{n} exited {rcs[k]}")
            else:
                shards.append(report)
                continue
            logs[k].seek(0)
            tail = logs[k].read()[-2000:].strip()
            if tail:
                bad[-1] += ":\n" + tail
        for f in logs:
            f.close()
    if bad:
        for line in bad:
            print(f"# fanout {line}")
        return 1
    merged: List = [None] * sum(len(s["cells"]) for s in shards)
    for k, s in enumerate(shards):
        merged[k::n] = s["cells"]
    return _emit({"meta": {**shards[0]["meta"], "fanout": n}, "cells": merged}, args.json)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized sweep (1024-point strata, n=2 dial only)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the machine-readable report here")
    ap.add_argument("--modes", default=None,
                    help="comma-separated mode filter (e.g. taylor,goldschmidt)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shard", default=None, metavar="K/N",
                    help="run only the interleaved grid slice cells[K::N]")
    ap.add_argument("--device", default="cuda",
                    help="where the division unit runs (default: cuda)")
    ap.add_argument("--fanout", type=int, default=0, metavar="N",
                    help="fan the grid out over N --shard subprocesses and "
                         "merge their reports")
    args = ap.parse_args(argv)
    if args.fanout and args.shard:
        ap.error("--fanout and --shard are mutually exclusive")
    if args.fanout < 0:
        ap.error(f"--fanout needs N >= 1, got {args.fanout}")
    if args.fanout > 1:
        return _run_fanout(args, args.fanout)

    cells = default_grid(quick=args.quick)
    if args.modes:
        keep = set(args.modes.split(","))
        unknown = keep - set(MODES)
        if unknown:
            ap.error(f"unknown modes {sorted(unknown)}; valid: {MODES}")
        cells = [c for c in cells if c.mode in keep]
    if args.shard:
        try:
            k, n = (int(p) for p in args.shard.split("/"))
        except ValueError:
            ap.error("--shard wants K/N (e.g. 0/8)")
        if not 0 <= k < n:
            ap.error(f"--shard needs 0 <= K < N, got {args.shard}")
        cells = cells[k::n]
    report = run_conformance(cells, quick=args.quick, seed=args.seed,
                             device=args.device)
    return _emit(report, args.json)


if __name__ == "__main__":
    sys.exit(main())
