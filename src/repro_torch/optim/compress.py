"""Int8 error-feedback gradient compression for the cross-pod axis (the
port of ``src/repro/optim/compress.py``).

Per tensor: compensate ``g' = g + err``; share the scale ``s = max|g'| /
127`` (the MAX over the axis's ranks); quantize ``q = round(g' / s)`` to
int8 (half to even, as ``jnp.round``); sum the q over the ranks;
dequantize ``mean = acc * s / n``; carry ``err' = g' - q * s`` into the
next step (Karimireddy et al. 2019).

"Per tensor" is per tensor of the reference's layout: it stacks a group's
layers along a leading axis, where the port keeps a leaf per layer
(``.../layers/<i>/...``), so the leaves of one stack share one scale, the
max over all of them (:func:`stacks`).

The ranks' int8 values are summed as int32 (gloo has no int16 all-reduce,
ROADMAP F11): sums of up to 256 pods of +-127 are exact in either, so the
mean's bits are the reference's. The single-host round trip
(:func:`quantize_roundtrip`) is the test hook.
"""
from __future__ import annotations

import re

import torch

from repro_torch import tree
from repro_torch.kernels.common import fma

__all__ = ["init_error_tree", "psum_compressed", "quantize_roundtrip", "stacks"]

F32 = torch.float32


def init_error_tree(params):
    return tree.map_tree(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params)


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    # A CUDA tensor divided by a Python number is multiplied by its
    # reciprocal; dividing by a tensor divides.
    return torch.tensor(v, dtype=F32, device=like.device)


_LAYER = re.compile(r"(^|/)layers/\d+(?=/|$)")


def stacks(grads) -> list:
    """The leaf indices of ``grads`` grouped by the reference's tensors: the
    leaves whose paths differ only in the layer index after ``layers/``
    form one stacked tensor there; every other leaf is a group of its own."""
    groups: dict = {}
    for i, path in enumerate(tree.paths(grads)):
        groups.setdefault(_LAYER.sub(r"\1layers/*", path), []).append(i)
    return list(groups.values())


def psum_compressed(grads, err_tree, axis_name: str):
    """Mean of ``grads`` over the active mesh's ``axis_name`` ranks with int8
    error feedback, one scale per tensor of the reference's layout
    (:func:`stacks`). Returns (mean tree f32, new error tree); every rank
    of the axis gets the same mean."""
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
    for group in stacks(grads):
        local = torch.stack([torch.max(torch.abs(gfs[i])) for i in group]).max()
        top = comm.all_reduce(local, mesh, [axis_name], op="max")
        scale = torch.div(torch.clamp(top, min=1e-30), _scalar(127.0, top))
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
