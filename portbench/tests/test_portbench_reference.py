"""The plain references against the program at the smoke configurations
on the CPU, in float32, and the float8 control reading higher."""
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from portbench import check, harness, weights
from portbench.reference import deepseek_moe, mamba2
from portbench.tests._smoke import CELLS, run_smoke
from repro_torch.models import forward
from repro_torch.models.params import model_specs

ROOT = Path(__file__).resolve().parents[2]


def _setup(name, **over):
    cj = json.loads((ROOT / f"portbench/configs/{name}.json").read_text())
    cfg = dataclasses.replace(harness.model_config(cj, smoke=True), param_dtype="float32",
                              **over)
    params = weights.draw(model_specs(cfg), cfg.param_dtype, 5, "cpu")
    return cfg, harness.sizes_of(cfg, cj, True), params


@pytest.mark.parametrize("name,ref,over", [
    ("dsmoe16b", deepseek_moe, {"capacity_factor": 8.0}),
    ("mamba2", mamba2, {})])
def test_reference_matches_the_programs_prefill_at_every_position(name, ref, over):
    cfg, sizes, params = _setup(name, **over)
    sizes.update(over)
    toks = torch.randint(0, cfg.vocab, (1, 48), generator=torch.Generator().manual_seed(1))
    got, _, _ = forward(cfg, params, tokens=toks, mode="prefill")
    want = ref.served_logits(params, sizes, toks[0].tolist(), 1)
    assert torch.allclose(got[0], want, atol=2e-4, rtol=0), (got[0] - want).abs().max()


def test_reference_holds_the_capacity_rule_over_the_prompt():
    # Capacity factor 0.5 drops pairs in a 48-token prompt.
    cfg, sizes, params = _setup("dsmoe16b", capacity_factor=0.5)
    sizes["capacity_factor"] = 0.5
    toks = torch.randint(0, cfg.vocab, (1, 48), generator=torch.Generator().manual_seed(2))
    got, _, _ = forward(cfg, params, tokens=toks, mode="prefill")
    want = deepseek_moe.served_logits(params, sizes, toks[0].tolist(), 48)
    assert torch.allclose(got[0, -1:], want, atol=2e-4, rtol=0)
    loose = deepseek_moe.served_logits(params, dict(sizes, capacity_factor=8.0),
                                       toks[0].tolist(), 48)
    assert (loose - want).abs().max() > 1e-2        # the drops matter


@pytest.mark.parametrize("cell", CELLS)
def test_sound_smoke_runs_are_correct_and_the_float8_control_reads_higher(cell, monkeypatch,
                                                                         smoke_root):
    """Over three seeds, every served token of every request: the mean gap
    of the float8 control's first tokens is over three times the
    program's, and the program's runs are correct."""
    outs = {}
    orig = check.judge

    def keep(cell_, cj, sizes, params, specs, o, seed):
        outs.update(cj=cj, sizes=sizes, params=params, specs=specs, outs=o)
        return orig(cell_, cj, sizes, params, specs, o, seed)

    monkeypatch.setattr(check, "judge", keep)
    ctrl, prog = [], []
    for seed in (1, 2, 3):
        r = run_smoke(cell, smoke_root, seed=seed)
        assert r["correct"], r["checks"]
        ref = check.reference(outs["cj"])
        for sp, o in zip(outs["specs"], outs["outs"]):
            c, p = check.control_gaps(ref, outs["params"], outs["sizes"], sp.tokens, o)
            ctrl.append(c)
            prog.append(p)
    c, p = check.readings(torch.cat(ctrl)), check.readings(torch.cat(prog))
    assert c["gap_mean"] > 3 * p["gap_mean"], (c, p)
