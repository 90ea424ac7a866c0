"""Set-up: from the process's start (the first line of ``run.py``) to the
first timed request: imports, the kernels' build, the weights, the
warm-up."""


def read(run):
    return run.setup_s
