"""Loss and train step: microbatched gradients, AdamW through the unit.

The port of ``src/repro/train/step.py``. A step splits the batch (B, ...)
into ``n_micro`` microbatches and runs them one after another in a Python
loop (the reference's ``lax.scan``), so only one microbatch's activations
live at a time; with ``cfg.remat`` the model recomputes each block in the
backward pass and keeps only the blocks' inputs. Each microbatch's
gradients come out of autograd in the parameters' dtype, as the
reference's ``value_and_grad`` gives them, and are cast to f32 and summed
into an f32 accumulator that starts at zero; the sum is scaled by
``1/n_micro``.

Under an active mesh (``sharding.rules.use_mesh``) the step is data
parallel: each rank takes its block of the batch along the batch axes
(``rules.data_spec``: the largest prefix of ('pod', 'data') that divides
the batch) -- of each microbatch: microbatch i of a rank is its block of
the global batch's microbatch i, as the reference's microbatch i is the
global one -- and computes its own gradients as above, with the model told
that its rows are that block (``rules.split_tokens``: the MoE FFN's
capacity and positions are the global microbatch's). The gradients are
then meaned over the batch axes other than ``compress_axis`` (an f32
all-reduce of the sum, times 1/n, as the reference's ``inv``) and over
``compress_axis`` through ``optim.compress.psum_compressed`` (int8 with
error feedback). Every rank then holds the same gradients, runs the same
AdamW (its ``tsdiv_recip`` per leaf) and keeps the same replicated
parameters. The reported loss and metrics are meaned over the batch axes:
the global batch's, as the reference's.

Where a leaf is split over some of its ranks (``models/parallel.py``) each
rank takes its blocks of the parameters and moments (DTensors, the global
tree or its own blocks). Under a ``model`` axis above 1 the model runs
split over it, the loss is a vocab-split logsumexp with each label's logit
taken from the rank that holds it, and the batch, the gradients' mean and
the loss's mean go over the data axes only. An expert leaf split over
``data`` holds other experts on each data rank: its gradient is not summed
over that axis -- the owner's gradient already holds every rank's tokens,
through the expert exchange's backward pass -- and takes the factor 1/n
all the same. AdamW runs on the rank's blocks, with the gradients' global
norm summed over the ranks of each split axis of a leaf and counted once
for a replicated one, so every rank gets the same clip factor. The new
state is DTensors where the parameters came as DTensors, the rank's blocks
otherwise. A whole leaf that each rank reads for its own heads only (GQA's
replicated ``wk`` / ``wv``, the Mamba-2 mixer's ``wB``, ``wC``, ``conv_B``
and ``conv_C``) has its gradient summed over ``model`` inside the backward
pass (``comm.copy_to_split``), so the step holds it as a replicated leaf.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward
from repro_torch.models.parallel import (AXIS, local_params, split_axes, tensor_parallel,
                                         wrap_like)
from repro_torch.optim import adamw

__all__ = ["TrainState", "init_state", "abstract_state", "cross_entropy", "loss_fn",
           "grads_fn", "train_step"]

F32 = torch.float32


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState
    step: torch.Tensor   # () int32


def init_state(cfg: ModelConfig, params, opt_cfg: adamw.AdamWConfig) -> TrainState:
    opt = adamw.init(params, opt_cfg)
    return TrainState(params=params, opt=opt, step=torch.zeros_like(opt.step))


def abstract_state(cfg: ModelConfig, params_abstract,
                   opt_cfg: adamw.AdamWConfig) -> TrainState:
    """:func:`init_state` on stand-in parameters (``models.abstract_params``),
    allocating nothing."""
    opt = adamw.abstract_state(params_abstract, opt_cfg)
    return TrainState(params=params_abstract, opt=opt, step=tree.abstract_like(opt.step))


def cross_entropy(logits, labels, tp=None):
    """Mean CE. logits f32 (B, S, V); labels (B, S) ints. Under a vocab
    split (``tp``) ``logits`` is the rank's block: the logsumexp shifts by
    the maximum over the ranks (no gradient: the shift cancels), sums its
    exponentials over them, and each label's logit comes from its owner."""
    if tp is None or not tp.vocab:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        return torch.mean(lse - ll)
    from repro_torch.sharding import comm

    n = logits.shape[-1]
    top = comm.all_reduce(logits.detach().amax(dim=-1), tp.mesh, (AXIS,), op="max")
    sum_exp = tp.reduce(torch.sum(torch.exp(logits - top[..., None]), dim=-1))
    lse = top + torch.log(sum_exp)
    local = labels.long() - tp.vocab_offset(n)
    mine = (local >= 0) & (local < n)
    ll = torch.gather(logits, -1, torch.where(mine, local, 0)[..., None])[..., 0]
    ll = tp.reduce(torch.where(mine, ll, torch.zeros((), dtype=ll.dtype, device=ll.device)))
    return torch.mean(lse - ll)


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    """(ce + aux, {"ce", "aux"}) of one batch: token inputs, or an
    embedding-input model's ``embeds``, and an encoder-decoder's
    ``enc_embeds``."""
    kw = {}
    if cfg.is_encoder_decoder:
        kw["enc_embeds"] = batch["enc_embeds"]
    if cfg.embed_inputs and not cfg.is_encoder_decoder:
        kw["embeds"] = batch["embeds"]
    else:
        kw["tokens"] = batch["tokens"]
    logits, _, aux = forward(cfg, params, mode="train", **kw)
    ce = cross_entropy(logits, batch["labels"], tensor_parallel(cfg))
    return ce + aux, {"ce": ce, "aux": aux}


def _split_micro(batch, n_micro: int):
    """(B, ...) -> n_micro microbatches of (B/n_micro, ...) per entry."""
    for k, x in batch.items():
        if x.shape[0] % n_micro:
            raise ValueError(f"batch {k!r} of {x.shape[0]} rows does not split "
                             f"into {n_micro} microbatches")
    return [{k: x.reshape(n_micro, -1, *x.shape[1:])[i] for k, x in batch.items()}
            for i in range(n_micro)]


def grads_fn(cfg: ModelConfig, params, batch, n_micro: int):
    """(loss, metrics, f32 grads) of the batch, accumulated over
    ``n_micro`` microbatches."""
    live = [p.detach().requires_grad_() for p in tree.leaves(params)]
    lp = tree.unflatten(params, live)

    def value_and_grad(mb):
        loss, metrics = loss_fn(cfg, lp, mb)
        gs = torch.autograd.grad(loss, live, allow_unused=True)
        # A leaf the loss does not read (an embedding-input model's token
        # table) gets zeros, as the reference's grad gives it.
        gs = [torch.zeros_like(p) if g is None else g for g, p in zip(gs, live)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, gs

    if n_micro <= 1:
        loss, metrics, gs = value_and_grad(batch)
        return loss, metrics, tree.unflatten(params, [g.to(F32) for g in gs])

    g_sum = [torch.zeros(p.shape, dtype=F32, device=p.device) for p in live]
    loss_sum = torch.zeros((), dtype=F32, device=live[0].device)
    for mb in _split_micro(batch, n_micro):
        loss, _, gs = value_and_grad(mb)
        for acc, g in zip(g_sum, gs):
            acc.add_(g.to(F32))
        loss_sum = loss_sum + loss
        del gs
    inv = 1.0 / n_micro
    loss = loss_sum * inv
    grads = tree.unflatten(params, [g * inv for g in g_sum])
    return loss, {"ce": loss, "aux": torch.zeros_like(loss)}, grads


def _mean_over(t: torch.Tensor, mesh, axes, split=None) -> torch.Tensor:
    """The mean of ``t`` over the ranks along ``axes``: an f32 sum, times
    1/n. ``split``: the axes of a leaf split over its ranks, whose blocks
    are not summed (the factor 1/n stays)."""
    from repro_torch.sharding import comm
    from repro_torch.sharding import rules as shr

    n = shr.axes_size(mesh, axes)
    if n == 1:
        return t
    return comm.all_reduce(t, mesh, [a for a in axes if a not in (split or ())]) * (1.0 / n)


def _rank_rows(x, mesh, axes, n_micro: int) -> torch.Tensor:
    """This rank's rows of a batch entry along ``axes``: its block of each of
    the ``n_micro`` microbatches of the global batch, in order. ``x`` is the
    global tensor, the same on every rank, or a DTensor placed over
    ``axes`` (its blocks are gathered first when ``n_micro`` > 1)."""
    from repro_torch.sharding import rules as shr

    sh = shr.batch_sharding(mesh, axes, x.ndim)
    if n_micro <= 1:
        return shr.batch_local(x, sh)
    shr.batch_local(x, sh)            # a DTensor placed otherwise raises
    x = shr.global_tensor(x)
    if x.shape[0] % (n_micro * shr.axes_size(mesh, axes)):
        raise ValueError(f"a batch of {x.shape[0]} rows does not split into {n_micro} "
                         f"microbatches over {axes}")
    per = shr.batch_sharding(mesh, axes, x.ndim + 1)
    blocks = shr.local_block(x.reshape(n_micro, -1, *x.shape[1:]).movedim(0, 1), per)
    return blocks.movedim(1, 0).reshape(-1, *x.shape[1:])


def train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, state: TrainState,
               batch, *, n_micro: int = 1, lr_scale=1.0,
               compress_axis: Optional[str] = None, err_tree=None):
    """One optimizer step. Returns (new_state, metrics), and the new error
    tree as a third item when ``compress_axis`` is given."""
    from repro_torch.optim import compress
    from repro_torch.sharding import rules as shr

    mesh = shr.active_mesh()
    if compress_axis is not None and mesh is None:
        raise ValueError(f"train_step(compress_axis={compress_axis!r}) needs an active mesh "
                         "with that axis (sharding.rules.use_mesh); there is none")
    tp = tensor_parallel(cfg)
    if tp is not None and compress_axis is not None:
        raise ValueError(f"train_step(compress_axis={compress_axis!r}) with leaves split "
                         f"over the mesh (model axis {tp.size}, experts "
                         f"{tp.moe.experts if tp.moe else None}): the int8 mean takes one "
                         "scale per tensor of the reference's layout, which a split leaf "
                         "does not hold (ROADMAP Queue 1 item 18)")
    like = state.params
    if tp is not None:
        state = TrainState(params=local_params(cfg, state.params, tp),
                           opt=adamw.AdamWState(step=state.opt.step,
                                                m=local_params(cfg, state.opt.m, tp),
                                                v=local_params(cfg, state.opt.v, tp)),
                           step=state.step)
    axes: tuple = ()
    if mesh is not None:
        size = next(iter(batch.values())).shape[0]
        axes = shr.batch_partition(mesh, size)
        if axes:
            batch = {k: _rank_rows(v, mesh, axes, n_micro) for k, v in batch.items()}
    with shr.split_tokens(axes):
        loss, metrics, grads = grads_fn(cfg, state.params, batch, n_micro)
    new_err = None
    split = None if tp is None else split_axes(cfg, tp)
    if mesh is not None:
        plain = tuple(ax for ax in axes if ax != compress_axis)
        grads = (tree.map_tree(lambda g: _mean_over(g, mesh, plain), grads) if split is None
                 else tree.map_tree(lambda g, a: _mean_over(g, mesh, plain, a), grads, split))
        if compress_axis is not None:
            grads, new_err = compress.psum_compressed(grads, err_tree, compress_axis)
        loss = _mean_over(loss, mesh, axes)
        metrics = {k: _mean_over(v, mesh, axes) for k, v in metrics.items()}
    new_params, new_opt = adamw.update(grads, state.opt, state.params, opt_cfg, lr_scale,
                                       split=split)
    if tp is not None:
        new_params = wrap_like(like, new_params, tp)
        new_opt = adamw.AdamWState(step=new_opt.step, m=wrap_like(like, new_opt.m, tp),
                                   v=wrap_like(like, new_opt.v, tp))
    new_state = TrainState(params=new_params, opt=new_opt, step=state.step + 1)
    metrics = dict(metrics, loss=loss, step=state.step)
    if compress_axis is not None:
        return new_state, metrics, new_err
    return new_state, metrics
