"""Gap between a request's successive tokens, 95th percentile over every
gap of every request that arrives after the loop's ramp-up."""
from portbench.metrics._common import percentile, steady


def read(run):
    gaps = [(b - a) * 1e3 for r in steady(run) for a, b in zip(r.times, r.times[1:])]
    return percentile(gaps, 95)
