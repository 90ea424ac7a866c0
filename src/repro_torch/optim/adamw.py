"""AdamW with the update's divide routed through the paper's unit.

The port of ``src/repro/optim/adamw.py``. The Adam step
``m_hat / (sqrt(v_hat) + eps)`` is a per-parameter divide, the workload the
unit is for: in ``exact`` mode it is torch's divide, in every other mode
``m_hat * recip(denom)`` through ``division_modes.recip`` (in a kernel mode
one ``tsdiv_recip`` launch per leaf on the card). The bias corrections are
scalar divides and stay exact, as in the reference.

The arithmetic is the reference's, operation by operation: f32 throughout,
the bias corrections ``1 - b ** step`` as f32 pows, the moments stored in
``state_dtype`` and the parameters cast back to their own dtype. Scalars
that divide are f32 tensors on the parameters' device, because a CUDA
tensor divided by a Python number is a multiply by its reciprocal; square
roots are correctly rounded (:func:`sqrt_f32`). The
state mirrors the parameter tree, leaf for leaf, and ``update`` returns new
tensors (the reference's functional update; nothing is written in place).

On a tensor-parallel rank (``train/step.py``) the trees are the rank's
blocks and ``split`` says which leaves are split over which mesh axes: the
global norm sums a split leaf's squares over those ranks and counts a
replicated leaf once, so every rank clips by the same factor; the rest is
elementwise, one reciprocal launch per local block.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch import tree
from repro_torch.core import division_modes as dm

__all__ = ["AdamWConfig", "AdamWState", "init", "abstract_state", "bias_corrections",
           "sqrt_f32", "global_norm", "update"]

F32 = torch.float32


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    state_dtype: str = "float32"
    division: dm.DivisionConfig = dm.EXACT


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    m: Any
    v: Any


def _zeros_like(p, dt):
    """Zeros of ``p``'s shape on its device; for a DTensor, a DTensor of zero
    blocks placed alike."""
    from torch.distributed.tensor import DTensor

    if isinstance(p, DTensor):
        return DTensor.from_local(torch.zeros(p.to_local().shape, dtype=dt, device=p.device),
                                  p.device_mesh, p.placements, run_check=False)
    return torch.zeros(p.shape, dtype=dt, device=p.device)


def init(params, cfg: AdamWConfig) -> AdamWState:
    dt = getattr(torch, cfg.state_dtype)
    zeros = lambda p: _zeros_like(p, dt)
    device = tree.leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree.map_tree(zeros, params), v=tree.map_tree(zeros, params))


def abstract_state(params_abstract, cfg: AdamWConfig) -> AdamWState:
    """:func:`init`'s state as stand-ins that allocate nothing, on the
    stand-in parameters' device and fake mode (``repro_torch.tree.abstract``)."""
    dt = getattr(torch, cfg.state_dtype)
    like = lambda p: tree.abstract_like(p, dt)
    step = tree.abstract_like(tree.leaves(params_abstract)[0], torch.int32, shape=())
    return AdamWState(step=step, m=tree.map_tree(like, params_abstract),
                      v=tree.map_tree(like, params_abstract))


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as the reference's (and a CUDA
    tensor's ``torch.sqrt``). torch's vectorised CPU kernel is not: it is 1
    ulp off on some lanes (ROADMAP F10), so a CPU tensor takes its root in
    f64, whose rounding to f32 is then correctly rounded (53 >= 2*24 + 2
    bits)."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(F32)


def global_norm(grads, split=None) -> torch.Tensor:
    """sqrt of the sum of the per-leaf sums of squares, in f32. ``split``
    (a tree matching ``grads``: the tuple of mesh axes each leaf is split
    over, None for none) makes ``grads`` a rank's blocks on the active
    mesh: a split leaf's sum is summed over the ranks of each of its axes
    (one all-reduce per set of axes), a replicated leaf's is its own; every
    rank gets the same bits."""
    leaves = tree.leaves(grads)
    sums = [torch.sum(torch.square(g.to(F32))) for g in leaves]
    if split is not None:
        from repro_torch.sharding import comm
        from repro_torch.sharding import rules as shr

        axes = [(a,) if isinstance(a, str) else a for a in tree.leaves_at(split, grads)]
        for group in sorted({a for a in axes if a is not None}):
            idx = [i for i, a in enumerate(axes) if a == group]
            total = comm.all_reduce(torch.stack([sums[i] for i in idx]), shr.active_mesh(),
                                    group)
            for j, i in enumerate(idx):
                sums[i] = total[j]
    return sqrt_f32(torch.sum(torch.stack(sums)))


def bias_corrections(step: torch.Tensor, cfg: AdamWConfig):
    """(1 - b1 ** step, 1 - b2 ** step) as f32 pows of the int32 step, on
    the step's device. The pow runs as a 0-d op on the CPU, whose scalar
    path gives the reference's bits (steps 1-1000 tested; torch's vectorised
    and CUDA pows are not correctly rounded, ROADMAP F10)."""
    s = step.to("cpu", F32)
    return tuple((1.0 - torch.pow(torch.tensor(b, dtype=F32), s)).to(step.device)
                 for b in (cfg.b1, cfg.b2))


@torch.no_grad()
def update(grads, state: AdamWState, params, cfg: AdamWConfig, lr_scale=1.0, split=None):
    """Returns (new_params, new_state). ``split``: as :func:`global_norm`'s."""
    step = state.step + 1
    gnorm = global_norm(grads, split)
    clip = torch.clamp(torch.div(torch.tensor(cfg.grad_clip, dtype=F32, device=gnorm.device),
                                 gnorm + 1e-9), max=1.0)
    c1, c2 = bias_corrections(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    lr = cfg.lr * lr_scale

    def upd(g, m, v, p):
        gf = g.to(F32) * clip
        mf = b1 * m.to(F32) + (1 - b1) * gf
        vf = b2 * v.to(F32) + (1 - b2) * gf * gf
        mhat = mf / c1
        vhat = vf / c2
        denom = sqrt_f32(vhat) + cfg.eps
        if cfg.division.mode == "exact":
            delta = mhat / denom
        else:
            delta = mhat * dm.recip(denom, cfg.division)
        pf = p.to(F32)
        pf = pf - lr * (delta + cfg.weight_decay * pf)
        return pf.to(p.dtype), mf.to(m.dtype), vf.to(v.dtype)

    out = [upd(*leaf) for leaf in zip(*(tree.leaves(t) for t in (grads, state.m, state.v,
                                                                  params)))]
    new_params, new_m, new_v = (tree.unflatten(params, [o[i] for o in out]) for i in range(3))
    return new_params, AdamWState(step=step, m=new_m, v=new_v)
