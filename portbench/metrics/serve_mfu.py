"""The whole window's share of the card's bf16 peak: the model FLOPs of
every request completed in the traced window (``portbench/counts/
flops.py``) over the window times 989 TFLOP/s."""
from portbench.counts import flops, peaks


def read(run):
    if run.device is None:
        return None
    done = [r for r in run.requests if len(r.times) == r.max_new]
    total = sum(flops.request_flops(run.sizes, r.prompt, r.max_new) for r in done)
    return 100.0 * total / (run.window_s * peaks.BF16_FLOPS)
