"""Time to first token, 90th percentile over every request that arrives
in the window after the loop's ramp-up: its first token's time minus its
arrival (the closed loop's rule). The ramp-up's C requests, sent together
at the call, count in ``tok_s`` and not here."""
from portbench.metrics._common import percentile, steady


def read(run):
    return percentile([(r.times[0] - r.arrival) * 1e3 for r in steady(run) if r.times], 90)
