"""Model weights drawn from the run's seed, on the device, in a few large calls.

The leaves of the program's parameter tree (shape and dtype from its spec
tree) are laid out in one flat buffer per dtype, each leaf at an offset
aligned to 256 elements, and each leaf is a contiguous view of its buffer.
A buffer is filled by ``normal_`` on a generator of its device, in chunks;
then each run of leaves that share a distribution is set by one call:
scaled to its standard deviation, set to 0 or 1, or redrawn from a
log-uniform law.

How a leaf is drawn is the spec's (normal at its scale, zeros, ones),
unless the configuration file's ``init`` names the leaf (by its key in
the tree) under one of:

- ``normal_std``: normal with this standard deviation;
- ``scale_by``: normal at the spec's scale times this factor;
- ``log_uniform``: log(u), u uniform on [a, b];
- ``softplus_inverse_log_uniform``: v + log(-expm1(-v)), the inverse of
  softplus, of v = exp(u), u uniform on [log a, log b].

The same seed gives the same weights.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

ALIGN = 256            # elements: every leaf starts on a 512-byte boundary or more
CHUNK = 1 << 28        # elements drawn by one call


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def _put(tree, path, value):
    node = tree
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_skeleton(v) for v in tree]
    return None


def law(spec, name: str, init: Dict) -> Tuple:
    """(kind, parameters) of the distribution of leaf ``name``."""
    for kind in ("log_uniform", "softplus_inverse_log_uniform"):
        if name in init.get(kind, {}):
            return (kind, tuple(init[kind][name]))
    if name in init.get("normal_std", {}):
        return ("normal", float(init["normal_std"][name]))
    if spec.init != "normal":
        return (spec.init, 0.0)
    scale = spec.scale if spec.scale is not None else 1.0 / math.sqrt(spec.shape[0])
    return ("normal", float(scale) * float(init.get("scale_by", {}).get(name, 1.0)))


def _fill(run: torch.Tensor, key: Tuple, gen: torch.Generator) -> None:
    kind, par = key
    if kind == "zeros":
        run.zero_()
    elif kind == "ones":
        run.fill_(1.0)
    elif kind == "normal":
        run.mul_(par)
    elif kind == "log_uniform":
        run.uniform_(par[0], par[1], generator=gen).log_()
    elif kind == "softplus_inverse_log_uniform":
        v = run.uniform_(math.log(par[0]), math.log(par[1]), generator=gen).exp_()
        run.copy_(v + torch.log(-torch.expm1(-v)))
    else:
        raise ValueError(f"unknown law {kind!r}")


def draw(specs, param_dtype: str, seed: int, device, init: Optional[Dict] = None
         ) -> Dict[str, Any]:
    """The parameter tree of ``specs`` (objects with ``shape``, ``init``,
    ``scale`` and ``dtype``, as the program's spec tree has them), drawn
    from ``seed`` on ``device`` under the configuration's ``init``."""
    init = init or {}
    device = torch.device(device)
    by_dtype: Dict[torch.dtype, List[Tuple[tuple, Any, Tuple]]] = {}
    for path, spec in _walk(specs):
        name = next(k for k in reversed(path) if isinstance(k, str))
        dt = getattr(torch, spec.dtype or param_dtype)
        by_dtype.setdefault(dt, []).append((path, spec, law(spec, name, init)))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    out = _skeleton(specs)
    for dt, group in by_dtype.items():
        group.sort(key=lambda leaf: (leaf[2][0], str(leaf[2][1])))   # one law, one run
        offsets, total = [], 0
        for _, spec, _ in group:
            offsets.append(total)
            total += -(-math.prod(spec.shape) // ALIGN) * ALIGN
        buf = torch.empty(total, dtype=dt, device=device)
        for lo in range(0, total, CHUNK):
            buf[lo:min(total, lo + CHUNK)].normal_(generator=gen)
        start = 0
        while start < len(group):
            end = start
            while end < len(group) and group[end][2] == group[start][2]:
                end += 1
            hi = offsets[end] if end < len(group) else total
            _fill(buf[offsets[start]:hi], group[start][2], gen)
            start = end
        for (path, spec, _), off in zip(group, offsets):
            _put(out, path, buf[off:off + math.prod(spec.shape)].view(spec.shape))
    return out
