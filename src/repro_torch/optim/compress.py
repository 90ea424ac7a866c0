"""Int8 error-feedback gradient compression (the port of
``src/repro/optim/compress.py``).

Per tensor: compensate ``g' = g + err``; share the scale ``s = max|g'| /
127``; quantize ``q = round(g' / s)`` to int8; dequantize ``q * s``; carry
``err' = g' - q * s`` into the next step (Karimireddy et al. 2019). The
single-host round trip (:func:`quantize_roundtrip`) is ported; the
cross-pod mean (:func:`psum_compressed`) needs a named ``pod`` axis of a
device mesh, which arrives with the port's sharding (ROADMAP Queue 1 item
13).
"""
from __future__ import annotations

import torch

from repro_torch import tree

__all__ = ["init_error_tree", "psum_compressed", "quantize_roundtrip"]


def init_error_tree(params):
    return tree.map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)


def psum_compressed(grads, err_tree, axis_name: str):
    """Cross-pod mean of grads with int8 error feedback: not ported yet."""
    raise NotImplementedError(
        f"psum_compressed over axis {axis_name!r} needs the port's device mesh "
        "(ROADMAP Queue 1 item 13); there is no single-device stand-in")


def quantize_roundtrip(g, err):
    """Single-host test hook: quantize + dequantize with error feedback."""
    gf = g.to(torch.float32) + err
    scale = torch.div(torch.clamp(torch.max(torch.abs(gf)), min=1e-30),
                      torch.tensor(127.0, device=gf.device))
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return deq, gf - deq
