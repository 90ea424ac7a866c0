"""Prefill time a thousand prompt tokens: the spans around
``engine.prefill`` (synchronised at each end) over the prompts' tokens."""
from portbench.metrics._common import span_total


def read(run):
    secs, n = span_total(run, "prefill")
    toks = sum(info["tokens"] for name, _, _, info in run.spans if name == "prefill")
    return secs * 1e3 / (toks / 1e3) if n and toks else None
