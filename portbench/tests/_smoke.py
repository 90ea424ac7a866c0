"""Shared set-up of the CPU tests: the benchmark's cells run on the smoke
configurations, at short lengths, on the CPU (the kernels' plain
versions), with the harness's look for a chip skipped.

``mamba2.code`` waits outside ``BENCHMARK.json`` (its runs on the card
spread too widely for a bound: PERF.md); its files are in place, and the
tests run it from a checkout whose ``BENCHMARK.json`` adds it."""
import json
import time
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
WAITING = {
    "configs": [{"name": "mamba2", "source": "https://huggingface.co/state-spaces/mamba2-780m",
                 "file": "portbench/configs/mamba2.json",
                 "reduced": ["vocab_size", "residual_in_fp32"],
                 "why": "attention-free Mamba-2 (SSD): O(1) state a sequence, the gated RMSNorm"}],
    "workloads": [{"name": "mamba2.code", "config": "mamba2", "traffic": "code", "chips": 1,
                   "why": "the same traffic at 64 clients on an attention-free model"}]}
CELLS = ["dsmoe16b.code", "mamba2.code"]

MIX = {"loop": "closed",
       "prompt_tokens": {"dist": "lognormal", "median": 40, "sigma": 0.55, "min": 16, "max": 100},
       "answer_tokens": {"dist": "lognormal", "median": 16, "sigma": 0.55, "min": 6, "max": 32},
       "order_seed": 0}
# The smoke models take the program's own init scales: the published
# initialisations (the configuration files' ``init``) are set for the
# published widths.
OVERRIDES = {"clients": 4, "rate_ref": 5.0, "traffic_mix": MIX, "weights_init": {}}
SEED = 2**31 + 977


def checkout(path: Path) -> Path:
    """``path`` as a checkout: ``BENCHMARK.json`` with the waiting cells, and
    this ``portbench/`` linked in."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, entries in WAITING.items():
        bench[key] += entries
    (path / "BENCHMARK.json").write_text(json.dumps(bench))
    (path / "portbench").symlink_to(ROOT / "portbench")
    return path


def run_smoke(workload, root, *, trace=False, seconds=3.0, seed=SEED, **kw):
    over = dict(OVERRIDES)
    over.update(kw.pop("overrides", {}))
    kw.setdefault("bench_root", root)
    return harness.run(workload, seed, seconds, trace, t_start=time.perf_counter(),
                       device="cpu", smoke=True, overrides=over, **kw)
