"""Whether the window's outputs are correct.

Once the window has closed and the program's state is freed, a sample of
the finished requests drawn from the seed, the longest among them, is run
through the configuration's plain reference (``portbench/reference/``):
once over each prompt with its served tokens. At each served token the
reference's largest logit minus its logit of the served token is a gap;
the widest gap over the sample, or their mean, is held to the cell's
limit. Every request has to have been served all the tokens it asked for.

The control (:func:`control_gaps`, run by ``calibrate.py`` and the tests,
never by a run) reads the same gap for the token that the reference puts
first when its 16-bit weights are rounded to float8.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Sequence

import numpy as np
import torch

from .reference import common

SAMPLE = 24              # requests compared a run, the longest among them
MIN_TOKENS = 200         # served tokens they hold at the least


def reference(cj: Dict):
    return importlib.import_module(f"portbench.reference.{cj['reference']}")


def sample(specs, outs, seed: int, n: int) -> List[int]:
    """The longest finished request (prompt and answer) and n - 1 others
    drawn from the seed, in queue order."""
    done = [i for i, (sp, o) in enumerate(zip(specs, outs)) if len(o) == sp.max_new]
    if not done:
        return []
    longest = max(done, key=lambda i: (len(specs[i].tokens) + specs[i].max_new, -i))
    rest = [i for i in done if i != longest]
    rng = np.random.default_rng([seed % (1 << 63), 0x5EED])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return sorted([longest] + [rest[j] for j in pick])


def gaps(logits: torch.Tensor, chosen: Sequence[int]) -> torch.Tensor:
    """The reference's best logit minus its logit of each chosen token."""
    idx = torch.as_tensor(list(chosen), dtype=torch.long, device=logits.device)[:, None]
    return logits.max(-1).values - logits.gather(-1, idx)[:, 0]


@torch.no_grad()
def served_gaps(ref, params, sizes, prompt: List[int], served: List[int]) -> torch.Tensor:
    logits = ref.served_logits(params, sizes, list(prompt) + list(served[:-1]), len(prompt))
    return gaps(logits, served)


@torch.no_grad()
def control_gaps(ref, params, sizes, prompt: List[int], served: List[int]):
    """(the gaps of the tokens that the float8 control puts first, the gaps
    of the served tokens), at each position of one request."""
    toks = list(prompt) + list(served[:-1])
    want = ref.served_logits(params, sizes, toks, len(prompt))
    ctrl = ref.served_logits(params, sizes, toks, len(prompt), quant="fp8")
    return gaps(want, ctrl.argmax(-1).tolist()), gaps(want, served)


def readings(g: torch.Tensor) -> Dict[str, float]:
    """The numbers a cell's limits may name, over gaps ``g``."""
    return {"gap_widest": float(g.max()) if g.numel() else 0.0,
            "gap_mean": float(g.mean()) if g.numel() else 0.0}


def judge(cell: Dict, cj: Dict, sizes: Dict, params, specs, outs, seed: int):
    """(correct, checks): each number compared with its limit and rule.
    The gaps compared are those the cell's ``limits`` name: the widest
    (``gap_widest``) and the mean over every token compared (``gap_mean``)."""
    common.setup()
    ref = reference(cj)
    unfinished = sum(1 for sp, o in zip(specs, outs) if len(o) != sp.max_new)
    got = [served_gaps(ref, params, sizes, specs[i].tokens, outs[i])
           for i in sample(specs, outs, seed, SAMPLE)]
    g = torch.cat(got) if got else torch.zeros(0)
    finite = bool(torch.isfinite(g).all())
    got = readings(g)
    checks = {"unfinished": {"value": unfinished, "limit": 0, "rule": "<="},
              "tokens_compared": {"value": int(g.numel()), "limit": MIN_TOKENS, "rule": ">="}}
    for name, limit in cell["limits"].items():
        checks[name] = {"value": got[name] if finite else None, "limit": limit,
                        "rule": "<="}
    correct = (unfinished == 0 and g.numel() >= MIN_TOKENS and finite
               and all(got[n] <= lim for n, lim in cell["limits"].items()))
    return correct, checks
