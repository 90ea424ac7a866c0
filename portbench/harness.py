"""One run of one cell: set-up, the measured window, the reading of the
metrics, the check of the outputs, the result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is found by name: ``BENCHMARK.json`` at the checkout's root names the
cell's configuration and mix; ``portbench/configs/<config>.json``,
``portbench/traffic/<mix>.json`` and ``portbench/cells/<cell>.json`` hold
them; each metric is read by ``portbench/metrics/<metric>.py``.

The window: one call of ``repro_torch.serving.ServingEngine.serve`` over
the run's N requests with the cell's ``clients`` slots, a closed loop:
``serve`` admits its queue in order as slots free, so request k >= C
arrives when the (k - C + 1)-th request completes, its client's previous
one. The first C requests are the loop's ramp-up: they arrive together at
the call, and the tails are taken over the requests that arrive after it.
Each request's ``out`` list records the host time of every token
appended to it, which ``serve`` does after reading the token back from the
device. The window runs from the call to the last token.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from . import guard, traffic as traffic_mod

HERE = Path(__file__).resolve().parent
WARMUP_NEW = 4           # tokens each warm-up request asks for
TRACE_FROM = 0.3         # the profiled stretch starts once this share of the tokens is served
TRACE_SECONDS = 4.0      # and lasts this long
# Model fields that the smoke configurations of the CPU tests take from a
# configuration file; every other field is a size and stays the smoke one's.
RUN_FIELDS = ("param_dtype", "capacity_factor", "moe_dispatch", "norm_eps", "rope_theta")


class TimedList(list):
    """A request's ``out``: every append also records the host time, and
    calls ``hook(now)``."""

    def __init__(self, hook=None):
        super().__init__()
        self.times: List[float] = []
        self.hook = hook

    def append(self, x):
        now = time.perf_counter()
        self.times.append(now)
        super().append(x)
        if self.hook is not None:
            self.hook(now)


@dataclasses.dataclass
class Request:
    """What the window did with one request, in queue order."""

    prompt: int
    max_new: int
    times: List[float]                # host time of each token, from the window's start
    arrival: float = 0.0
    ramp_up: bool = False             # one of the first C, sent together at the call


@dataclasses.dataclass
class Run:
    """What a run measured: every metric reader gets this."""

    sizes: Dict[str, Any]             # the configuration's sizes (its file's ``port``)
    setup_s: float
    window_s: float
    requests: List[Request]
    spans: List = dataclasses.field(default_factory=list)
    kernel_calls: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    device: Optional[Dict] = None     # the profiled stretch's summary


def closed_loop_arrivals(reqs: List[Request], clients: int) -> None:
    """Request k < C arrives at 0, the ramp-up; request k >= C at the
    (k - C + 1)-th completion (its last token), when its client's previous
    one ended."""
    done = sorted(r.times[-1] for r in reqs if r.times)
    for k, r in enumerate(reqs):
        r.ramp_up = k < clients
        r.arrival = 0.0 if r.ramp_up else done[k - clients]


def load_json(path: Path) -> Dict:
    return json.loads(path.read_text())


def find_workload(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_cell(root: Path, bench: Dict, name: str):
    """(workload entry, cell file, configuration file, mix) of cell ``name``."""
    wl = find_workload(bench, name)
    cell = load_json(root / "cells" / f"{name}.json")
    if (cell["config"], cell["traffic"]) != (wl["config"], wl["traffic"]):
        raise ValueError(f"cells/{name}.json names {cell['config']}/{cell['traffic']}, "
                         f"BENCHMARK.json {wl['config']}/{wl['traffic']}")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    cj = load_json(root.parent / conf["file"])
    return wl, cell, cj, traffic_mod.load(root, wl["traffic"])


def metric_entries(bench: Dict, workload: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics (``trace`` 0) or per-layer ones (1):
    those whose ``workloads`` list it, or that list none."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def reader(root: Path, name: str):
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}",
                                                  root / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def model_config(cj: Dict, smoke: bool = False):
    """The program's ModelConfig as the configuration file runs it: its
    ``port`` fields over the program's own configuration of ``arch``. The
    CPU tests' ``smoke`` keeps the smoke configuration's sizes."""
    from repro_torch.configs import get_config, get_smoke_config

    port = dict(cj["port"])
    div = port.pop("division", None)
    if smoke:
        base = get_smoke_config(cj["arch"])
        port = {k: v for k, v in port.items() if k in RUN_FIELDS}
    else:
        base = get_config(cj["arch"])
    cfg = dataclasses.replace(base, **port)
    if div:
        cfg = dataclasses.replace(cfg, division=dataclasses.replace(cfg.division, **div))
    return cfg


def sizes_of(cfg, cj: Dict, smoke: bool) -> Dict[str, Any]:
    """The sizes the benchmark's own counts and reference read: the
    configuration file's, or a smoke configuration's."""
    if not smoke:
        return {k: v for k, v in cj["port"].items() if k != "division"}
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k != "division"}


def run(workload: str, seed: int, seconds: float, trace: bool, *, t_start: float,
        device: str = "cuda", smoke: bool = False, overrides: Optional[Dict] = None,
        bench_root: Optional[Path] = None) -> Dict:
    """One run; returns the result line's object. ``smoke``, ``device``,
    ``overrides`` (cell keys; ``traffic_mix``: a mix in place of the
    cell's; ``weights_init``: an ``init`` in place of the configuration's)
    and ``bench_root`` (a checkout other than this one, for its
    ``BENCHMARK.json`` and ``portbench/`` data) serve the CPU tests."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.models.params import model_specs
    from repro_torch.serving import ServingEngine
    from repro_torch.serving import Request as ServeRequest
    from repro_torch.serving.engine import alignment

    from . import check, weights

    checkout = bench_root or HERE.parent
    root = checkout / "portbench"
    bench = load_json(checkout / "BENCHMARK.json")
    wl, cell, cj, mix = load_cell(root, bench, workload)
    cell = {**cell, **(overrides or {})}
    mix = cell.pop("traffic_mix", None) or mix
    on_card = device.startswith("cuda")
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)

    cfg = model_config(cj, smoke)
    sizes = sizes_of(cfg, cj, smoke)
    if on_card:
        _build.build_all(("tsdiv", "softmax", "rmsnorm"))
    init = cell["weights_init"] if "weights_init" in cell else cj.get("init")
    params = weights.draw(model_specs(cfg), cfg.param_dtype, seed, device, init)
    C = cell["clients"]
    specs = traffic_mod.requests(mix, traffic_mod.count(seconds, cell["rate_ref"]), seed,
                                 cfg.vocab)
    # The cache's slots: what the longest request needs, its prompt padded.
    align = alignment(cfg)
    max_len = max(max(-(-len(sp.tokens) // align) * align, len(sp.tokens) + sp.max_new)
                  for sp in specs)
    engine = ServingEngine(cfg, params, max_len=max_len)

    # Warm-up: the run's longest, shortest and median prompts in its slots.
    by_len = sorted(specs, key=lambda sp: len(sp.tokens))
    warm = [by_len[-1], by_len[0], by_len[len(by_len) // 2]]
    engine.serve([ServeRequest(list(sp.tokens), WARMUP_NEW) for sp in warm], slots=C)

    per_layer = metric_entries(bench, workload, True) if trace else []
    readers = {m["name"]: reader(root, m["name"])
               for m in (per_layer or metric_entries(bench, workload, False))}
    spans = calls = stretch = None
    from . import trace as tr
    if trace:
        spans = tr.Spans(sync)
        spans.wrap("repro_torch.serving.engine", "prefill", "prefill",
                   lambda a, kw: {"tokens": int(sum(kw["lengths"]))})
        spans.wrap("repro_torch.serving.engine", "decode_step", "decode_step",
                   lambda a, kw: {"rows": int(a[3].shape[0])})
        calls = tr.KernelCalls()
        for mod in readers.values():
            for k in getattr(mod, "KERNELS", ()):
                if k not in calls.counts:
                    calls.wrap(k)
        if on_card:
            tr.Stretch.warm(device)
            start = int(TRACE_FROM * sum(sp.max_new for sp in specs))
            stretch = tr.Stretch(start, TRACE_SECONDS, calls, device)
    sync()
    # Set-up's objects leave the collector's generations, so a collection
    # in the window walks only what the window made.
    gc.collect()
    gc.freeze()

    t0 = time.perf_counter()
    hook = None if stretch is None else stretch.tick
    reqs = [ServeRequest(list(sp.tokens), sp.max_new, out=TimedList(hook)) for sp in specs]
    setup_s = t0 - t_start
    try:
        engine.serve(reqs, slots=C)
    finally:
        if stretch is not None:
            stretch.stop()
        gc.unfreeze()
    t_end = max(t for r in reqs for t in r.out.times)
    found = guard.offenders()
    if found:
        raise guard.ForbiddenImport(found)

    served = [Request(len(sp.tokens), sp.max_new, [t - t0 for t in r.out.times])
              for sp, r in zip(specs, reqs)]
    closed_loop_arrivals(served, C)
    rec = Run(sizes=sizes, setup_s=setup_s, window_s=t_end - t0, requests=served)
    if trace:
        spans.close()
        calls.close()
        rec.spans = [(n, a - t0, b - t0, info) for n, a, b, info in spans.records]
        rec.kernel_calls = calls.calls
        rec.device = stretch.summary(spans) if stretch is not None else None

    entries = per_layer or metric_entries(bench, workload, False)
    metrics = {}
    for m in entries:
        v = readers[m["name"]].read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device, "count": 1}
    if on_card:
        dev["kind"] = torch.cuda.get_device_name(device)
        dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
    if trace and rec.device is not None:
        dev["busy_s"] = rec.device["busy_s"]
        dev["window_s"] = rec.device["window_s"]

    # The program's state goes before the reference runs; the weights are
    # the benchmark's own inputs and stay.
    outs = [list(r.out) for r in reqs]
    del engine, reqs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    correct, checks = check.judge(cell, cj, sizes, params, specs, outs, seed)

    result = {"correct": correct, "attempted": len(specs),
              "failed": sum(1 for sp, o in zip(specs, outs) if len(o) != sp.max_new),
              "metrics": metrics, "device": dev}
    if trace and rec.device is not None:
        result["breakdown"] = breakdown(rec.device)
        result["kernel_launches"] = launches(rec)
    result["checks"] = checks
    return result


def launches(rec: Run) -> Dict:
    """Each recorded kernel's calls in the stretch against the launches
    the profiler recorded (a roofline is scaled to the latter)."""
    import importlib

    out = {}
    for k, calls in rec.kernel_calls.items():
        name = importlib.import_module(f"portbench.counts.{k}").DEVICE_NAME
        seen = sum(n for kname, (_, n) in rec.device["kernels"].items() if name in kname)
        out[k] = {"calls": len(calls), "recorded": seen}
    return out


def breakdown(dev: Dict) -> Dict:
    """The ten device operations that took most time in the stretch, and
    the idle time by what the host was doing, then the longest gaps."""
    ops = sorted(((k[:160], t) for k, (t, _) in dev["kernels"].items()), key=lambda kv: -kv[1])
    by_host: Dict[str, float] = {}
    for label, s in dev["gaps"]:
        by_host[label] = by_host.get(label, 0.0) + s
    gaps = sorted(by_host.items(), key=lambda kv: -kv[1])
    longest = sorted(dev["gaps"], key=lambda g: -g[1])[:max(0, 10 - len(gaps))]
    return {"device_ops": [[k, t] for k, t in ops[:10]],
            "idle_gaps": [[f"all idle in {k}", s] for k, s in gaps]
            + [[f"longest in {k}", s] for k, s in longest]}


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json(HERE.parent / "BENCHMARK.json")
    wl = find_workload(bench, args.workload)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"portbench: {args.workload} needs {wl['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program (repro_torch) is not here: {e}", file=sys.stderr)
        return 3
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    except guard.ForbiddenImport as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 4
    found = guard.offenders()
    if found:
        print(f"portbench: {guard.ForbiddenImport(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
