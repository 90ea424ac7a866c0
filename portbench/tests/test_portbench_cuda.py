"""The cells at their own size on the card (marker ``cuda``; skipped
without one): a short run is correct, the float8 control, put in the
program's place at the same positions, reads over the cell's limit, and a
run with a fault planted under the timed path is not correct.

    python -m pytest -q -m cuda portbench/tests/test_portbench_cuda.py
"""
import json
import time
from pathlib import Path

import pytest
import torch

from portbench import check, harness
from portbench.tests._faults import FAULTS

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct_and_the_control_is_not(cuda, cell, monkeypatch):
    got = {}
    orig = check.judge

    def keep(cell_, cj, sizes, params, specs, outs, seed):
        got.update(cell=cell_, cj=cj, sizes=sizes, params=params, specs=specs, outs=outs)
        return orig(cell_, cj, sizes, params, specs, outs, seed)

    monkeypatch.setattr(check, "judge", keep)
    seed = 2**31 + 4242
    r = harness.run(cell, seed, 10.0, False, t_start=time.perf_counter(), device=cuda)
    assert r["correct"], r["checks"]
    ref = check.reference(got["cj"])
    ctrl = torch.cat([check.control_gaps(ref, got["params"], got["sizes"],
                                         got["specs"][i].tokens, got["outs"][i])[0]
                      for i in check.sample(got["specs"], got["outs"], seed, check.SAMPLE)])
    read = check.readings(ctrl)
    assert any(read[n] > lim for n, lim in got["cell"]["limits"].items()), read


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_planted_at_the_cells_size_makes_the_run_not_correct(cuda, cell, fault,
                                                                      monkeypatch):
    FAULTS[fault](monkeypatch)
    r = harness.run(cell, 2**31 + 4343, 12.0, False, t_start=time.perf_counter(), device=cuda)
    assert not r["correct"], r["checks"]
