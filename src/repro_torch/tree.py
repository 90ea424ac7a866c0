"""Nested parameter trees: dicts, lists, tuples and named tuples of tensors.

The port keeps parameters, optimizer moments and train states as plain
nested containers. :func:`leaves` lists a tree's tensors in
``jax.tree_util``'s order (depth first; dict keys sorted; list, tuple and
named-tuple entries in order), which is the order AdamW walks and a
checkpoint stores them in; :func:`unflatten` puts a list in that order back
into a tree's structure, and :func:`map_tree` maps leaf by leaf over trees
of one structure. :func:`abstract` makes the stand-in leaves of the
``abstract_*`` trees: shape and dtype, no storage.
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch

__all__ = ["leaves", "leaves_at", "paths", "unflatten", "map_tree", "abstract", "abstract_like"]


def _is_named_tuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _items(t):
    """(key, child) pairs of a container in leaf order; None for a leaf."""
    if isinstance(t, dict):
        return [(k, t[k]) for k in sorted(t)]
    if _is_named_tuple(t):
        return list(zip(t._fields, t))
    if isinstance(t, (list, tuple)):
        return list(enumerate(t))
    return None


def paths(tree, prefix: str = "") -> List[str]:
    """Each leaf's path ("params/groups/0/layers/3/attn/wq"), in leaf order."""
    items = _items(tree)
    if items is None:
        return [prefix]
    return [p for k, c in items for p in paths(c, f"{prefix}/{k}" if prefix else str(k))]


def leaves(tree) -> List[Any]:
    items = _items(tree)
    if items is None:
        return [tree]
    return [leaf for _, c in items for leaf in leaves(c)]


def leaves_at(tree, like) -> List[Any]:
    """The entries of ``tree`` at the leaves of ``like``, in leaf order: a
    tuple there is one entry (a leaf's mesh axes), not a container."""
    items = _items(like)
    if items is None:
        return [tree]
    return [leaf for k, c in items for leaf in leaves_at(tree[k], c)]


def unflatten(like, new_leaves) -> Any:
    """``like``'s structure holding ``new_leaves`` (in leaf order)."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if _is_named_tuple(t):
            return type(t)(*[build(c) for c in t])
        if isinstance(t, (list, tuple)):
            return type(t)(build(c) for c in t)
        return next(it)

    out = build(like)
    end = object()
    if next(it, end) is not end:
        raise ValueError("more leaves than the tree holds")
    return out


def map_tree(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if _is_named_tuple(tree):
        return type(tree)(*[map_tree(fn, *xs) for xs in zip(tree, *rest)])
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def abstract(shape, dtype: torch.dtype, device=None, fake_mode=None) -> torch.Tensor:
    """A stand-in of ``shape`` and ``dtype`` that allocates nothing: a
    ``meta`` tensor, or given a ``FakeTensorMode`` one of its fake tensors on
    ``device`` (cuda by default: the port's entry points run on the card)."""
    if fake_mode is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    with fake_mode:
        return torch.empty(shape, dtype=dtype, device=device or "cuda")


def abstract_like(t: torch.Tensor, dtype: torch.dtype = None, shape=None) -> torch.Tensor:
    """:func:`abstract` on ``t``'s device and fake mode, of ``t``'s shape
    and dtype unless ``shape`` / ``dtype`` are given."""
    return abstract(t.shape if shape is None else shape, dtype or t.dtype, t.device,
                    getattr(t, "fake_mode", None))
