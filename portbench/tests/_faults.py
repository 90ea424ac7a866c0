"""Faults planted under the timed path, each with a pytest ``MonkeyPatch``:
the CPU tests, the card's test and ``calibrate.py --fault`` plant them."""
import repro_torch.serving.engine as eng


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def state_unchanged(monkeypatch):
    """A decode step that returns the cache it was given, as it was."""
    orig = eng.decode_step

    def step(cfg, params, cache, tokens, pos):
        logits, _ = orig(cfg, params, _clone(cache), tokens, pos)
        return logits, cache

    monkeypatch.setattr(eng, "decode_step", step)


def half_the_batch(monkeypatch):
    """A decode step that computes the first half of its rows and gives the
    other half their mean."""
    orig = eng.decode_step

    def step(cfg, params, cache, tokens, pos):
        logits, cache = orig(cfg, params, cache, tokens, pos)
        h = logits.shape[0] // 2
        logits = logits.clone()
        logits[h:] = logits[:h].mean(0, keepdim=True)
        return logits, cache

    monkeypatch.setattr(eng, "decode_step", step)


def token_altered(monkeypatch):
    """Every 7th greedy token the engine produces is its neighbour."""
    orig = eng.greedy
    n = {"calls": 0}

    def greedy(logits, tp=None):
        tok = orig(logits, tp)
        n["calls"] += 1
        if n["calls"] % 7 == 0:
            tok = tok.clone()
            tok[0, 0] = (tok[0, 0] + 1) % logits.shape[-1]
        return tok

    monkeypatch.setattr(eng, "greedy", greedy)


FAULTS = {f.__name__: f for f in (state_unchanged, half_the_batch, token_altered)}
