"""Atomic checkpoints of a tree of tensors (the on-disk contract of
``src/repro/train/checkpoint.py``).

A checkpoint of step s is the directory ``step_{s:010d}`` holding
``arrays.npz`` (leaf i as ``leaf_i``: its raw bytes as uint8, so bf16 needs
no numpy dtype) and ``meta.json`` (step, n_leaves, each leaf's dtype name,
shape and tree path). The leaves are stored in ``tree.leaves`` order: depth
first, dict keys sorted, list and named-tuple entries in order (a
``TrainState`` is params, then the AdamW step, m and v, then the step).

* ``save`` copies every leaf to the host before it writes, so a later
  in-place change of the tensors cannot reach the files. A DTensor leaf
  (a tensor-parallel state) is written as its global value: every rank of
  its mesh calls ``save``, the blocks are gathered
  (``rules.global_tensor``), rank 0 of the process group writes, and all
  return once the checkpoint is whole. It writes into
  ``<dir>.tmp``, fsyncs each file, writes the ``COMPLETE`` marker last and
  then ``os.replace``s the directory into place: a checkpoint exists whole
  or not at all. It keeps the newest ``keep``.
* ``latest_step`` ignores directories without the marker.
* ``restore`` reads into the structure of ``like`` and places each tensor
  on ``device`` (by default the device of ``like``'s leaf). With
  ``shardings`` (a tree of ``sharding.rules.NamedSharding`` matching
  ``like``, e.g. from ``rules.param_shardings``) each leaf becomes a
  DTensor so placed on the current mesh, each rank keeping its own block:
  the elastic resume, since the files hold logical values, not placements.

Each package reads the other's checkpoint of the same tree. The one
difference on disk: the reference writes a 0-d leaf's shape as [1] (numpy's
``ascontiguousarray`` makes it 1-d), the port as [].
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree

__all__ = ["save", "all_steps", "latest_step", "restore", "restore_latest"]

_MARKER = "COMPLETE"
# A tensor's bytes go through the integer type of its element size.
_RAW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _dir(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step:010d}")


def _raw_bytes(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu").contiguous().reshape(-1)
    return t.view(_RAW[t.element_size()]).numpy().view(np.uint8)


def _write(name: str, write) -> None:
    with open(name, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def save(path: str, step: int, state: Any, keep: int = 3) -> str:
    """Write checkpoint ``step`` of ``state`` under ``path``; returns its dir.
    With DTensor leaves every rank calls it; one writes the global values."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding import rules as shr

    final = _dir(path, step)
    leaves = tree.leaves(state)
    placed = any(isinstance(t, DTensor) for t in leaves)
    if placed:
        import torch.distributed as dist

        leaves = [shr.global_tensor(t) for t in leaves]
        if dist.get_rank() != 0:
            dist.barrier()
            return final
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {f"leaf_{i}": _raw_bytes(t) for i, t in enumerate(leaves)}
    meta = {"step": int(step), "n_leaves": len(leaves),
            "dtypes": [str(t.dtype).removeprefix("torch.") for t in leaves],
            "shapes": [list(t.shape) for t in leaves],
            "paths": tree.paths(state)}
    _write(os.path.join(tmp, "arrays.npz"), lambda f: np.savez(f, **arrays))
    _write(os.path.join(tmp, "meta.json"), lambda f: f.write(json.dumps(meta).encode()))
    _write(os.path.join(tmp, _MARKER), lambda f: f.write(b"ok"))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(path, keep)
    if placed:
        dist.barrier()
    return final


def _gc(path: str, keep: int) -> None:
    steps = sorted(all_steps(path))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_dir(path, s), ignore_errors=True)


def all_steps(path: str):
    if not os.path.isdir(path):
        return []
    return [int(name[5:]) for name in os.listdir(path)
            if name.startswith("step_") and not name.endswith(".tmp")
            and os.path.exists(os.path.join(path, name, _MARKER))]


def latest_step(path: str) -> Optional[int]:
    steps = all_steps(path)
    return max(steps) if steps else None


def restore(path: str, step: int, like: Any, device=None, shardings: Any = None) -> Any:
    """Checkpoint ``step`` in the structure of ``like``, each tensor on
    ``device`` (by default where ``like``'s leaf is); where ``shardings``
    gives a leaf a NamedSharding, a DTensor so placed (the values are
    unchanged)."""
    from repro_torch.sharding import rules as shr

    final = _dir(path, step)
    if not os.path.exists(os.path.join(final, _MARKER)):
        raise FileNotFoundError(f"incomplete or missing checkpoint: {final}")
    with open(os.path.join(final, "meta.json")) as f:
        meta = json.load(f)
    refs = tree.leaves(like)
    if meta["n_leaves"] != len(refs):
        raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, the state {len(refs)}")
    # A NamedSharding is a leaf of the tree helpers, as None is.
    places = [None] * len(refs) if shardings is None else tree.leaves(shardings)
    if len(places) != len(refs):
        raise ValueError(f"shardings has {len(places)} leaves, the state {len(refs)}")
    out = []
    with np.load(os.path.join(final, "arrays.npz")) as data:
        for i, ref in enumerate(refs):
            dt = getattr(torch, meta["dtypes"][i])
            t = torch.from_numpy(data[f"leaf_{i}"]).view(dt)
            # The reference writes a 0-d leaf's shape as [1].
            if t.numel() != ref.numel() or tuple(meta["shapes"][i]) not in (
                    tuple(ref.shape), (1,) * (ref.dim() == 0)):
                raise ValueError(f"leaf {i}: checkpoint shape {meta['shapes'][i]}, "
                                 f"state {tuple(ref.shape)}")
            t = t.reshape(ref.shape).to(ref.device if device is None else device)
            out.append(t if places[i] is None else shr.distribute(t, places[i]))
    return tree.unflatten(like, out)


def restore_latest(path: str, like: Any, device=None,
                   shardings: Any = None) -> Tuple[Optional[int], Any]:
    step = latest_step(path)
    if step is None:
        return None, like
    return step, restore(path, step, like, device, shardings)
