"""The engine's own share of the traced window (admission, the cache row's
insert, the argmax, the host loop): the window less the spans around
``engine.prefill`` and ``engine.decode_step``."""
from portbench.metrics._common import span_total


def read(run):
    if not run.spans:
        return None
    inside = span_total(run, "prefill")[0] + span_total(run, "decode_step")[0]
    return 100.0 * (run.window_s - inside) / run.window_s
