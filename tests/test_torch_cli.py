"""The port's command lines and examples, each run as its own process on the
CPU: the serving and training launchers (exit codes, the refusal of an
unknown division mode, the batched path, checkpoint and resume), the dry run
and its report on one small cell, and the three ``examples/torch_*.py``.
Each process runs in seconds on the smoke configs (one torch thread).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(args, timeout=300):
    return subprocess.run([sys.executable, *args], capture_output=True, text=True,
                          timeout=timeout, cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": "src", "OMP_NUM_THREADS": "1"})


def _serve(*args, timeout=300):
    return _run(["-m", "repro_torch.launch.serve", "--arch", "paper_fpdiv", "--smoke",
                 "--device", "cpu", *args], timeout)


def _train(*args, timeout=300):
    return _run(["-m", "repro_torch.launch.train", "--smoke", "--device", "cpu",
                 "--seq-len", "16", "--global-batch", "2", *args], timeout)


# ------------------------------------------------------------ serve

def test_serve_cli_single_path():
    r = _serve("--batch", "1", "--prompt-len", "12", "--max-new", "4")
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("generated 4 tokens") == 1
    assert "division=taylor " in r.stdout and "tok/s" in r.stdout


def test_serve_cli_batched_path_with_division_flags():
    r = _serve("--batch", "3", "--prompt-len", "14", "--max-new", "4",
               "--division-mode", "taylor_pallas", "--n-iters", "3", "--schedule", "factored")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "division=taylor_pallas" in r.stdout and "n_iters=3" in r.stdout
    assert "batch=3" in r.stdout
    # the batched path: three prompts of unequal lengths, one line each
    lines = [ln for ln in r.stdout.splitlines() if "generated 4 tokens" in ln]
    assert [ln.split(" toks")[0] for ln in lines] == ["prompt(14", "prompt(11", "prompt(8"]


@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_cli_refuses_an_unknown_division_mode(launcher):
    r = (_serve if launcher == "serve" else _train)("--division-mode", "bogus", timeout=120)
    assert r.returncode != 0
    assert "invalid choice: 'bogus'" in r.stderr


# ------------------------------------------------------------ train

def test_train_cli_trains_checkpoints_and_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    r = _train("--steps", "2", "--ckpt-every", "2", "--ckpt-dir", ckpt)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "final loss:" in r.stdout and "after 2 steps" in r.stdout
    assert "[resume]" not in r.stdout
    r = _train("--steps", "3", "--ckpt-every", "2", "--ckpt-dir", ckpt,
               "--division-mode", "taylor_pallas")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[resume] restored checkpoint at step 2" in r.stdout
    assert "after 3 steps" in r.stdout


# ------------------------------------------------------ dry run, report

def test_dryrun_and_report_clis_on_one_cell(tmp_path):
    """whisper_tiny decode_32k on the tp1 multi-pod mesh (512 ranks of a
    fake process group in the child): the reference's file name and keys,
    then the report's rows for it (the roofline, the collectives by
    axis)."""
    r = _run(["-m", "repro_torch.launch.dryrun", "--arch", "whisper_tiny",
              "--shape", "decode_32k", "--mesh", "multi", "--variant", "tp1",
              "--device", "cpu", "--out", str(tmp_path)])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[ok] whisper_tiny_decode_32k_multi_tp1" in r.stdout
    cell = json.loads((tmp_path / "whisper_tiny_decode_32k_multi_tp1.json").read_text())
    assert {"arch", "shape", "mesh", "variant", "devices", "n_micro", "sharding_fallbacks",
            "memory", "hbm_traffic_model", "collectives", "roofline"} <= set(cell)
    assert set(cell["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                   "alias_bytes", "total_hbm_bytes"}
    assert cell["devices"] == 512 and cell["roofline"]["bound"] == "memory"
    assert cell["memory"]["alias_bytes"] > 0          # the cache, updated in place
    r = _run(["-m", "repro_torch.launch.report", "--dir", str(tmp_path), "--mesh", "multi",
              "--variant", "tp1"])
    assert r.returncode == 0, r.stdout + r.stderr
    rows = [ln for ln in r.stdout.splitlines() if ln.startswith("| whisper_tiny")]
    assert len(rows) == 2 and "| decode_32k |" in rows[0] and "**memory**" in rows[0]
    # The batch of 128 splits over pod only, so the cache's sequence lies on
    # data (the reference's cache layout): the split softmax's three
    # all-reduces in each of the 4 decoder layers.
    assert "| data | all-reduce | 12 |" in rows[1]


def test_dryrun_cli_refuses_a_model_axis(tmp_path):
    """Until ROADMAP item 22 a model axis of 16 under Mamba-2 layers failed
    the cell naming that item; now the CLI traces mamba2_780m's decode cell
    at model 16 (48 heads, 3 a rank) and writes its record."""
    r = _run(["-m", "repro_torch.launch.dryrun", "--arch", "mamba2_780m",
              "--shape", "decode_32k", "--mesh", "single", "--device", "cpu",
              "--out", str(tmp_path)])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[ok] mamba2_780m_decode_32k_single" in r.stdout and "[FAIL]" not in r.stdout
    cell = json.loads(next(tmp_path.glob("*.json")).read_text())
    assert cell["param_layout"] == "model"
    assert cell["collectives"]["by_axis"]["model"]["all-gather"]["count"] == 48


# ----------------------------------------------------------- examples

@pytest.mark.parametrize("example,args,says", [
    ("torch_quickstart.py", [], "done."),
    ("torch_serve_generate.py", [], "batched: prompt len  3"),
    ("torch_train_lm.py", ["--steps", "3", "--seq-len", "16", "--global-batch", "2"],
     "over 3 steps"),
])
def test_examples_run_on_the_cpu(example, args, says):
    r = _run([f"examples/{example}", "--device", "cpu", *args])
    assert r.returncode == 0, r.stdout + r.stderr
    assert says in r.stdout
