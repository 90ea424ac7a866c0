"""The weights drawn from the seed: the same seed the same tree, each leaf
a contiguous aligned view, and each law of a configuration's ``init``."""
import json
import math
from pathlib import Path

import torch

from portbench import weights
from repro_torch.configs import get_smoke_config
from repro_torch.models.params import model_specs

ROOT = Path(__file__).resolve().parents[2]


def _leaves(tree, path=()):
    return list(weights._walk(tree, path))


def test_the_same_seed_draws_the_same_tree_and_leaves_are_aligned_views():
    specs = model_specs(get_smoke_config("deepseek_moe_16b"))
    a = weights.draw(specs, "bfloat16", 2**31 + 5, "cpu")
    b = weights.draw(specs, "bfloat16", 2**31 + 5, "cpu")
    c = weights.draw(specs, "bfloat16", 2**31 + 6, "cpu")
    for (pa, x), (_, y), (_, z), (_, sp) in zip(_leaves(a), _leaves(b), _leaves(c),
                                                  _leaves(specs)):
        assert x.shape == sp.shape and x.is_contiguous(), pa
        assert x.storage_offset() % weights.ALIGN == 0, pa
        assert torch.equal(x, y), pa
        if sp.init == "normal":
            assert not torch.equal(x, z), pa


def test_each_law_of_the_published_inits():
    cj = json.loads((ROOT / "portbench/configs/mamba2.json").read_text())
    cfg = get_smoke_config("mamba2_780m")
    specs = model_specs(cfg)
    w = weights.draw(specs, "float32", 3, "cpu", cj["init"])
    m = w["groups"][0]["layers"][0]["mamba"]
    assert abs(float(w["embed"].std()) - 0.02) < 0.002
    want = (1 / math.sqrt(cfg.d_inner)) * cj["init"]["scale_by"]["wout"]
    assert abs(float(m["wout"].std()) / want - 1) < 0.15
    a = torch.exp(m["A_log"])
    assert bool(((a >= 1) & (a <= 16)).all())
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert bool(((dt >= 0.999e-3) & (dt <= 0.1001)).all())
    assert bool((m["D"] == 1).all()) and bool((m["norm"] == 1).all())
