"""The port's serving engine: the reference's serving gates, and the
reference's own greedy tokens on the same parameters.

As in ``tests/test_serving_correctness.py`` the smoke model runs in f32,
where token identity between batch compositions is a fair demand: batched
generation over unequal prompts equals single-request generation, and
``serve()`` (continuous batching) equals ``generate()``. The port's greedy
tokens also equal the reference's, parameters carried across by
``convert.params_from_reference``, in ``exact`` and ``taylor_pallas``.
"""
import contextlib
import dataclasses
import io

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.core.division_modes import DivisionConfig as RefDivisionConfig
from repro.serving import ServingEngine as RefServingEngine
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core.division_modes import DivisionConfig
from repro_torch.launch import serve as serve_cli
from repro_torch.models import init_params
from repro_torch.serving import Request, ServingEngine, pad_cache_to
from _ref_params import ref_init
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

PROMPTS = [list(range(1, 12)), list(range(3, 25)), list(range(5, 21))]


def _setup(max_len=96, **engine_kw):
    cfg = dataclasses.replace(get_smoke_config("paper_fpdiv"), param_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    return cfg, params, ServingEngine(cfg, params, max_len=max_len, **engine_kw)


def test_batched_padded_matches_single():
    _, _, eng = _setup()
    singles = [eng.generate(p, max_new=5) for p in PROMPTS]
    assert eng.generate_batch(PROMPTS, max_new=5) == singles


def test_generate_batch_input_validation():
    _, _, eng = _setup()
    with pytest.raises(ValueError, match="empty prompt"):
        eng.generate_batch([])
    with pytest.raises(ValueError, match="empty prompt"):
        eng.generate_batch([[1, 2], []])
    with pytest.raises(ValueError, match="max_len"):
        eng.generate_batch([list(range(1, 90))], max_new=32)


def test_serve_continuous_matches_generate():
    """4 requests through 2 slots: slot refill + per-request max_new."""
    _, _, eng = _setup()
    reqs = [Request(list(range(1, 10)), max_new=4),
            Request(list(range(2, 20)), max_new=6),
            Request(list(range(4, 11)), max_new=3),
            Request(list(range(7, 23)), max_new=5)]
    out = eng.serve(reqs, slots=2)
    assert out is not None and all(r.done for r in reqs)
    for r in reqs:
        assert r.out == eng.generate(r.tokens, max_new=r.max_new)


def test_serve_eos_release():
    """EOS stops a request early and frees its slot for the queue."""
    cfg, params, ref = _setup()
    prompt = list(range(1, 10))
    full = ref.generate(prompt, max_new=6)
    eos = full[1]
    eng = ServingEngine(cfg, params, max_len=96, eos_id=eos)
    reqs = [Request(prompt, max_new=6), Request(list(range(2, 20)), max_new=4)]
    eng.serve(reqs, slots=1)
    assert reqs[0].done and reqs[0].out == full[:full.index(eos) + 1]
    assert reqs[1].done
    assert len(reqs[1].out) == 4 or reqs[1].out[-1] == eos


@pytest.mark.parametrize("mode", ["exact", "taylor_pallas"])
def test_greedy_tokens_equal_the_reference(mode):
    rcfg = dataclasses.replace(ref_smoke_config("paper_fpdiv"), param_dtype="float32")
    rparams = ref_init(rcfg, 0)
    cfg = dataclasses.replace(get_smoke_config("paper_fpdiv"), param_dtype="float32")
    params = convert.params_from_reference(jax.tree_util.tree_map(np.asarray, rparams),
                                           cfg, "cpu")
    div = dict(mode=mode, n_iters=2, schedule="paper")
    want = RefServingEngine(rcfg, rparams, max_len=64,
                            division=RefDivisionConfig(**div)).generate_batch(PROMPTS, 12)
    eng = ServingEngine(cfg, params, max_len=64, division=DivisionConfig(**div))
    assert eng.cfg.division.mode == mode
    assert eng.generate_batch(PROMPTS, 12) == want


def test_pad_cache_to_grows_the_full_attention_cache():
    cfg, params, eng = _setup()
    toks = torch.tensor([PROMPTS[0]])
    _, cache = eng._prefill_tok(toks, [len(PROMPTS[0])])
    grown = pad_cache_to(cache, 11, 40, cfg)
    k = grown["groups"][0]["layers"][1]["attn"]["k"]
    assert k.shape == (1, 40, cfg.n_kv_heads, cfg.head_dim)
    assert torch.equal(k[:, :11], cache["groups"][0]["layers"][1]["attn"]["k"])
    assert torch.all(k[:, 11:] == 0)
    assert pad_cache_to(cache, 11, 11, cfg) is cache
    with pytest.raises(ValueError):
        pad_cache_to(cache, 11, 5, cfg)


def test_serve_cli_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve_cli.main(["--arch", "paper_fpdiv", "--smoke", "--device", "cpu",
                        "--division-mode", "taylor_pallas", "--prompt-len", "12",
                        "--max-new", "4", "--batch", "3"])
    text = out.getvalue()
    assert "division=taylor_pallas" in text and "device=cpu" in text
    assert text.count("generated 4 tokens") == 3
    assert serve_cli.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(SystemExit):
        serve_cli.main(["--division-mode", "bogus"])
