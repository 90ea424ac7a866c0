"""Time of a decode step: the spans around ``engine.decode_step``
(synchronised at each end) over their number."""
from portbench.metrics._common import span_total


def read(run):
    secs, n = span_total(run, "decode_step")
    return secs * 1e3 / n if n else None
