"""The device's idle share of the profiled stretch: one minus the union of
the intervals in which an operation ran on it, over the stretch's wall
time."""


def read(run):
    if run.device is None or run.device["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.device["busy_s"] / run.device["window_s"])
