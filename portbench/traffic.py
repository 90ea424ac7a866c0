"""The one traffic generator: requests of a mix file, drawn from the seed.

A mix (``portbench/traffic/<name>.json``) gives the loop and the
distributions of prompt and answer lengths. Every seed gets the same
sizes in the same order: the distributions' quantiles at (i + 1/2) / n,
clipped to ``[min, max]``, prompt and answer sizes paired, and the pairs
put in order, by permutations drawn from the mix's own ``order_seed``.
The run's seed draws the prompts' token ids, uniform over the
vocabulary. So two seeds serve the same work with other tokens (in a
closed loop the order sets which prompts arrive together at the start,
and so the tails: a seed that reordered them would change the work), and
the same seed gives the same requests.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from statistics import NormalDist
from typing import Dict, List

import numpy as np

LOOPS = ("closed",)
DISTS = ("lognormal",)


@dataclass(frozen=True)
class Spec:
    """One request: its prompt's token ids and the tokens it asks for."""

    tokens: List[int]
    max_new: int


def load(root: Path, name: str) -> Dict:
    mix = json.loads((root / "traffic" / f"{name}.json").read_text())
    if mix.get("loop") not in LOOPS:
        raise ValueError(f"traffic {name}: loop {mix.get('loop')!r} not in {LOOPS}")
    for key in ("prompt_tokens", "answer_tokens"):
        if mix[key].get("dist") not in DISTS:
            raise ValueError(f"traffic {name}: {key} dist not in {DISTS}")
    return mix


def sizes(dist: Dict, n: int) -> List[int]:
    """The n quantiles at (i + 1/2) / n of ``dist``, whole and clipped."""
    nd = NormalDist()
    mu, sigma = math.log(dist["median"]), dist["sigma"]
    out = []
    for i in range(n):
        v = math.exp(mu + sigma * nd.inv_cdf((i + 0.5) / n))
        out.append(int(min(dist["max"], max(dist["min"], round(v)))))
    return out


def count(seconds: float, rate_ref: float) -> int:
    """Requests in a run: ``seconds`` at the cell's reference rate."""
    return max(1, round(seconds * rate_ref))


def requests(mix: Dict, n: int, seed: int, vocab: int) -> List[Spec]:
    """The run's n requests in the order they are sent."""
    prompts = sizes(mix["prompt_tokens"], n)
    answers = sizes(mix["answer_tokens"], n)
    fixed = np.random.default_rng(mix["order_seed"])
    pair, order = fixed.permutation(n), fixed.permutation(n)
    rng = np.random.default_rng(seed)
    out = []
    for i in order:
        p = prompts[i]
        out.append(Spec(rng.integers(0, vocab, p).tolist(), answers[pair[i]]))
    return out
