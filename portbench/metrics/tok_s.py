"""Tokens a second: the prompt and served tokens of every request the
window completed, over the window (from the call to the last token)."""


def read(run):
    done = [r for r in run.requests if len(r.times) == r.max_new]
    return sum(r.prompt + len(r.times) for r in done) / run.window_s
