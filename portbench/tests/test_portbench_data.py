"""The benchmark's data and arithmetic: cells, mixes, metrics, the
closed loop's rules, the import guard, and the refusals of ``run.py``."""
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import guard, harness, traffic
from portbench.tests._smoke import MIX, WAITING, run_smoke

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_keeps_the_contracts_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and NAME.match(m["name"])
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"] + WAITING["workloads"]])
def test_every_cell_resolves_to_a_configuration_and_a_mix(cell):
    bench = {k: v + WAITING.get(k, []) if isinstance(v, list) else v for k, v in BENCH.items()}
    wl, c, cj, mix = harness.load_cell(ROOT / "portbench", bench, cell)
    assert cj["name"] == wl["config"] and cj["port"]["division"]["mode"] == "taylor_pallas"
    assert mix["loop"] == "closed" and c["clients"] >= 1 and c["rate_ref"] > 0
    cfg = harness.model_config(cj)
    for k, v in cj["port"].items():
        if k != "division":
            assert getattr(cfg, k) == v, k
    for group in (False, True):
        for m in harness.metric_entries(bench, cell, group):
            assert callable(harness.reader(ROOT / "portbench", m["name"]).read)


def test_traffic_is_the_same_for_a_seed_and_other_tokens_for_another():
    mix = traffic.load(ROOT / "portbench", "code")
    big = 2**31 + 12345
    a = traffic.requests(mix, 40, big, 102400)
    b = traffic.requests(mix, 40, big, 102400)
    c = traffic.requests(mix, 40, big + 1, 102400)
    assert a == b and a != c
    sizes = lambda rs: [(len(r.tokens), r.max_new) for r in rs]
    assert sizes(a) == sizes(c)                      # the same work in the same order
    assert all(128 <= len(r.tokens) <= 4032 and 2 <= r.max_new <= 64 for r in a)
    assert sorted(len(r.tokens) for r in a)[20] in range(1400, 1600)   # the medians
    assert sorted(r.max_new for r in a)[20] == 13


def _req(prompt, times):
    return harness.Request(prompt=prompt, max_new=len(times), times=list(times))


def test_rates_and_tails_on_synthetic_token_times():
    # Two clients; four requests. Completions at 1.0 (r0), 1.5 (r1), 3.0 (r2).
    reqs = [_req(10, [0.5, 1.0]), _req(20, [0.8, 1.5]),
            _req(30, [1.4, 2.0, 3.0]), _req(40, [2.1, 2.3])]
    harness.closed_loop_arrivals(reqs, 2)
    assert [r.arrival for r in reqs] == [0.0, 0.0, 1.0, 1.5]
    assert [r.ramp_up for r in reqs] == [True, True, False, False]
    run = harness.Run(sizes={}, setup_s=7.0, window_s=3.0, requests=reqs)
    m = lambda name: harness.reader(ROOT / "portbench", name).read(run)
    assert m("tok_s") == pytest.approx((10 + 20 + 30 + 40 + 9) / 3.0)   # the ramp-up too
    ttft = [0.4, 0.6]                   # first token minus arrival, after the ramp-up
    assert m("ttft_p90_ms") == pytest.approx(1e3 * (ttft[0] + 0.9 * (ttft[1] - ttft[0])))
    gaps = sorted([0.6, 1.0, 0.2])      # the gaps of r2 and r3
    assert m("itl_p95_ms") == pytest.approx(1e3 * (gaps[1] + 0.9 * (gaps[2] - gaps[1])))
    assert m("setup_s") == 7.0


def test_span_readers_on_synthetic_spans():
    run = harness.Run(sizes={}, setup_s=1.0, window_s=10.0, requests=[],
                      spans=[("prefill", 0.0, 2.0, {"tokens": 1000}),
                             ("decode_step", 2.0, 2.5, {"rows": 4}),
                             ("prefill", 3.0, 4.0, {"tokens": 3000}),
                             ("decode_step", 5.0, 5.5, {"rows": 4})])
    m = lambda name: harness.reader(ROOT / "portbench", name).read(run)
    assert m("prefill_ms_per_ktok") == pytest.approx(3000.0 / 4.0)
    assert m("decode_step_ms") == pytest.approx(500.0)
    assert m("engine_host_pct") == pytest.approx(100.0 * (10 - 4) / 10)
    assert m("idle_pct") is None and m("softmax_f32_roofline") is None


def test_a_cell_mix_and_metric_added_as_files_are_found(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    short = dict(MIX, prompt_tokens=dict(MIX["prompt_tokens"], median=24, min=8, max=48))
    (tmp_path / "portbench/traffic/short.json").write_text(json.dumps(short))
    cell = json.loads((ROOT / "portbench/cells/dsmoe16b.code.json").read_text())
    cell.update(traffic="short", why="a cell added as data")
    (tmp_path / "portbench/cells/dsmoe16b.short.json").write_text(json.dumps(cell))
    (tmp_path / "portbench/metrics/requests_done.py").write_text(
        "def read(run):\n    return float(len(run.requests))\n")
    bench["workloads"].append({"name": "dsmoe16b.short", "config": "dsmoe16b",
                               "traffic": "short", "chips": 1, "why": "added"})
    bench["end_to_end"].append({"name": "requests_done", "unit": "requests",
                                "better": "higher", "bound": 0.01, "source": "host_clock",
                                "workloads": ["dsmoe16b.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run_smoke("dsmoe16b.short", tmp_path, overrides={"traffic_mix": None})
    assert r["metrics"]["requests_done"]["value"] == r["attempted"] == 15
    assert all(r["checks"][n]["value"] <= lim for n, lim in cell["limits"].items())


def test_the_guard_compares_whole_top_level_names():
    assert guard.offenders(["repro_torch", "repro_torch.models", "torch", "jaxtyping"]) == []
    assert guard.offenders(["repro.core.taylor", "jax._src", "flax", "jaxlib"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_the_references_load_nothing_of_the_program_or_jax():
    code = ("import sys; import portbench.reference.deepseek_moe, portbench.reference.mamba2, "
            "portbench.check; print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"


def test_run_refuses_without_a_card_and_without_the_program(tmp_path):
    cmd = [sys.executable, "portbench/run.py", "--workload", "dsmoe16b.code", "--seed", "1",
           "--seconds", "1", "--trace", "0"]
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""
