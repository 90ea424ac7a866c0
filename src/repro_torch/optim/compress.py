"""Int8 error-feedback gradient compression for the cross-pod axis (the
port of ``src/repro/optim/compress.py``).

Per tensor: compensate ``g' = g + err``; share the scale ``s = max|g'| /
127`` (the MAX over the axis's ranks); quantize ``q = round(g' / s)`` to
int8 (half to even, as ``jnp.round``); sum the q over the ranks;
dequantize ``mean = acc * s / n``; carry ``err' = g' - q * s`` into the
next step (Karimireddy et al. 2019).

"Per tensor" is per tensor of the reference's layout: it stacks a group's
``repeat`` copies of each place in its period along a leading axis, where
the port keeps a leaf per layer (``.../layers/<r * period + i>/...``), so
the leaves of one stack share one scale, the max over all of them
(:func:`stacks`; a group of period 8, as jamba's, holds 8 stacks of each
leaf name).

Where a leaf is split over other mesh axes (``model``, the experts, FSDP
blocks on ``data``), each rank holds its block of it, and the protocol runs
on the block: the max is the block's (over the blocks of a stack's
layers), shared over the axis's ranks only, which hold the same block --
one scale per block of a stacked tensor, what the reference's body
computes on the block that its ``shard_map`` gives it.

The ranks' int8 values are summed as int32 (gloo has no int16 all-reduce,
ROADMAP F11): sums of up to 256 pods of +-127 are exact in either, so the
mean's bits are the reference's. The single-host round trip
(:func:`quantize_roundtrip`) is the test hook.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from repro_torch import tree
from repro_torch.kernels.common import fma

__all__ = ["init_error_tree", "psum_compressed", "quantize_roundtrip", "stacks"]

F32 = torch.float32


def init_error_tree(params):
    """f32 zeros shaped as ``params``: for a DTensor leaf, a DTensor of
    zero blocks placed alike (the error tree is stored as blocks)."""
    from torch.distributed.tensor import DTensor

    def zeros(p):
        if isinstance(p, DTensor):
            return DTensor.from_local(torch.zeros(p.to_local().shape, dtype=F32,
                                                  device=p.device),
                                      p.device_mesh, p.placements, run_check=False)
        return torch.zeros(p.shape, dtype=F32, device=p.device)

    return tree.map_tree(zeros, params)


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    # A CUDA tensor divided by a Python number is multiplied by its
    # reciprocal; dividing by a tensor divides.
    return torch.tensor(v, dtype=F32, device=like.device)


_RECIP_127 = float(np.float32(1.0) / np.float32(127.0))
_LAYER = re.compile(r"(^|/)groups/(\d+)/layers/(\d+)(?=/|$)")


def stacks(grads, periods) -> list:
    """The leaf indices of ``grads`` grouped by the reference's tensors: the
    leaves whose paths differ only in the layer index after ``layers/``,
    at the same place in their group's period, form one stacked tensor
    there; every other leaf is a group of its own. ``periods``: the
    length of each decoder group's period (``[len(g.period) for g in
    cfg.groups()]``; the encoder's is 1; empty for a tree with no
    ``groups/``). It has no default: period 1 would share one scale across
    a period's different tensors."""
    def key(path: str) -> str:
        def place(m):
            encoder = path.startswith("encoder/")
            p = 1 if encoder else periods[int(m.group(2))]
            return f"{m.group(1)}groups/{m.group(2)}/layers/*{int(m.group(3)) % p}"
        return _LAYER.sub(place, path)

    groups: dict = {}
    for i, path in enumerate(tree.paths(grads)):
        groups.setdefault(key(path), []).append(i)
    return list(groups.values())


def psum_compressed(grads, err_tree, axis_name: str, periods):
    """Mean of ``grads`` over the active mesh's ``axis_name`` ranks with int8
    error feedback, one scale per tensor of the reference's layout
    (:func:`stacks`), or per block of it where ``grads`` are the rank's
    blocks; ``periods`` as :func:`stacks` takes them. Returns (mean tree
    f32, new error tree); every rank of the axis gets the same mean."""
    from repro_torch.sharding import comm
    from repro_torch.sharding import rules as shr

    mesh = shr.active_mesh()
    if mesh is None or axis_name not in shr.mesh_shape(mesh):
        raise ValueError(f"psum_compressed over {axis_name!r} needs an active mesh with "
                         f"that axis (sharding.rules.use_mesh); the active mesh is {mesh}")
    n = shr.mesh_shape(mesh)[axis_name]

    def leaf(gf, scale):
        q = torch.clamp(torch.round(torch.div(gf, scale)), -127, 127).to(torch.int8)
        acc = comm.all_reduce(q.to(torch.int32), mesh, [axis_name])
        mean = torch.div(acc.to(F32) * scale, _scalar(float(n), gf))
        # XLA fuses this multiply-subtract (the product has no other use; F11).
        return mean, fma(-q.to(F32), scale, gf)

    gfs = [g.to(F32) + e for g, e in zip(tree.leaves(grads), tree.leaves(err_tree))]
    pairs = [None] * len(gfs)
    for group in stacks(grads, periods):
        local = torch.stack([torch.max(torch.abs(gfs[i])) for i in group]).max()
        top = comm.all_reduce(local, mesh, [axis_name], op="max")
        # XLA compiles the reference's division by the constant 127 into a
        # product with its f32 reciprocal; the body only runs compiled.
        scale = torch.clamp(top, min=1e-30) * _scalar(_RECIP_127, top)
        for i in group:
            pairs[i] = leaf(gfs[i], scale)
    return (tree.unflatten(grads, [m for m, _ in pairs]),
            tree.unflatten(err_tree, [e for _, e in pairs]))


def quantize_roundtrip(g, err):
    """Single-host test hook: quantize + dequantize with error feedback."""
    gf = g.to(F32) + err
    scale = torch.div(torch.clamp(torch.max(torch.abs(gf)), min=1e-30), _scalar(127.0, gf))
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.to(F32) * scale
    return deq, gf - deq
