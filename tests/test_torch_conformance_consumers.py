"""The port's conformance grid against the reference's: the rsqrt and
consumer (softmax, RMSNorm) cells, and the runner's own CLI (``--shard``
merging, the exit code on a failing cell). The recip and div cells are in
``test_torch_conformance.py``.
"""
import contextlib
import io
import json
import sys

import pytest

from _conformance_common import check_cell, grid_keys, reports
from repro_torch.eval import conformance
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

OPS = ("rsqrt", "softmax", "rmsnorm")


@pytest.fixture(scope="module")
def both():
    return reports(OPS)


@pytest.mark.parametrize("key", grid_keys(OPS))
def test_cell_matches_the_reference(both, key):
    check_cell(both, key)


def _main(args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = conformance.main(["--device", "cpu", *args])
    return rc, out.getvalue()


def test_shards_merge_into_the_single_run(tmp_path):
    """Each --shard K/N takes cells[K::N]; interleaving the shards' reports
    restores the single run, cell for cell."""
    modes = ["--quick", "--modes", "exact,taylor_pallas,ilm"]
    rc, text = _main([*modes, "--json", str(tmp_path / "all.json")])
    assert rc == 0 and "FAIL" not in text
    single = json.loads((tmp_path / "all.json").read_text())["cells"]
    n = 3
    merged = [None] * len(single)
    for k in range(n):
        path = tmp_path / f"shard{k}.json"
        assert _main([*modes, "--shard", f"{k}/{n}", "--json", str(path)])[0] == 0
        merged[k::n] = json.loads(path.read_text())["cells"]
    strip = lambda cells: [{f: v for f, v in c.items() if f != "seconds"} for c in cells]
    assert strip(merged) == strip(single)
    assert {c["mode"] for c in single} == {"exact", "taylor_pallas", "ilm"}


def test_main_exits_nonzero_on_a_failing_cell(monkeypatch):
    rc, _ = _main(["--quick", "--modes", "taylor"])
    assert rc == 0
    # Plant one IEEE edge failure in every reciprocal cell.
    monkeypatch.setattr(conformance, "_edge_failures", lambda x64, r64: 1)
    rc, text = _main(["--quick", "--modes", "taylor"])
    assert rc == 1
    assert "# CONFORMANCE FAILURES (4 cells):" in text
    assert "recip/taylor/paper/n2p24/float32" in text


def test_cli_refuses_what_it_cannot_do():
    for bad in (["--shard", "3/3"], ["--shard", "x"], ["--modes", "bogus"],
                ["--fanout", "2", "--shard", "0/2"], ["--fanout", "-1"]):
        with pytest.raises(SystemExit):
            _main(bad)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        conformance.main(["--help"])
    assert "merge their reports" in " ".join(out.getvalue().split())


FANOUT_MODES = ["--quick", "--modes", "taylor,goldschmidt", "--device", "cpu"]


def test_fanout_merges_to_the_single_process_report(tmp_path):
    """--fanout 2: two --shard workers, merged interleaved, equal to one
    process's report cell for cell."""
    rc, text = _main([*FANOUT_MODES, "--json", str(tmp_path / "one.json")])
    assert rc == 0
    rc, text = _main([*FANOUT_MODES, "--fanout", "2", "--json", str(tmp_path / "two.json")])
    assert rc == 0 and "FAIL" not in text
    one = json.loads((tmp_path / "one.json").read_text())
    two = json.loads((tmp_path / "two.json").read_text())
    strip = lambda cells: [{f: v for f, v in c.items() if f != "seconds"} for c in cells]
    assert strip(two["cells"]) == strip(one["cells"])
    assert two["meta"]["fanout"] == 2 and two["meta"]["device"] == "cpu"


def test_fanout_fails_and_names_a_failing_worker(monkeypatch):
    """A worker that exits non-zero without a report fails the run."""
    real = conformance._worker_cmd

    def planted(args, k, n, path):
        if k == 1:
            return [sys.executable, "-c", "import sys; sys.exit(7)"]
        return real(args, k, n, path)

    monkeypatch.setattr(conformance, "_worker_cmd", planted)
    rc, text = _main([*FANOUT_MODES, "--fanout", "2"])
    assert rc == 1
    assert "# fanout shard 1/2 wrote no report (exit 7)" in text


def test_the_grid_is_the_reference_grid():
    from repro.eval import conformance as ref_conformance

    for quick in (True, False):
        assert ([c.key for c in conformance.default_grid(quick=quick)]
                == [c.key for c in ref_conformance.default_grid(quick=quick)])
    assert conformance.DIAL == ref_conformance.DIAL
    assert conformance.GATE_MAX_ULP == ref_conformance.GATE_MAX_ULP
