"""Hand the reference's configs, inputs and model state to the port.

The division unit's parameters are the ``DivisionConfig`` and the seed
tables, which are recomputed from ``(n_iters, precision_bits)``, so a run of
the unit is carried across by its config (``dataclasses.asdict`` of the
reference's) and its numpy inputs. A model's parameters and caches are
carried across as numpy trees (``jax.tree_util.tree_map(np.asarray, ...)``
of the reference's), bits unchanged, bf16 included: the reference stacks a
group's ``repeat`` copies of each leaf on a leading axis, and the port keeps
them as separate layers (index ``r * period + i``); the encoder of an
encoder-decoder stacks its ``n_encoder_layers`` blocks the same way. Every
leaf maps by its path, so MoE leaves (the f32 router, the ``(E, d, f)``
expert weights, the shared experts), Mamba leaves (A_log, D, dt_bias and
the norm in f32), the sliding-window layers' K/V rings, the SSM state and
conv windows and the cross K/V move the same way. A training state moves
the same way too: the reference's ``TrainState`` / ``AdamWState`` (numpy
leaves; m and v mirror the parameters) become the port's, so a state the
reference made can be stepped by the port. With ``shardings``
(``sharding.rules.param_shardings``) each leaf becomes the DTensor of the
rank's block, cut from the numpy array before it is copied.
:func:`cache_block` cuts a whole decode cache (the reference's, carried
across, or a prefill's) into a rank's blocks of it, as
``models.make_cache`` lays them out on the mesh.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.division_modes import DivisionConfig
from repro_torch.optim.adamw import AdamWState
from repro_torch.train.step import TrainState
from repro_torch.tree import leaves, map_tree

__all__ = ["config_from_reference", "tensor_from_numpy", "tensors_from_numpy",
           "params_from_reference", "cache_from_reference", "opt_state_from_reference",
           "train_state_from_reference", "cache_block"]


def config_from_reference(fields: Dict) -> DivisionConfig:
    """The port's config from the reference's ``dataclasses.asdict(cfg)``."""
    return DivisionConfig(**fields)


def tensors_from_numpy(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Same-named tensors on ``device``, bits unchanged."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def tensor_from_numpy(a, device) -> torch.Tensor:
    """One array (ml_dtypes' bf16 included) as a tensor on ``device``, bits
    unchanged."""
    a = np.array(a)                     # a writable, contiguous copy
    if a.dtype.name == "bfloat16":      # ml_dtypes' bf16: carry the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _unstack_groups(groups, shapes):
    """``groups`` of stacked layers, one ``(period, repeat)`` of ``shapes``
    each, as lists of ``repeat * period`` layers (numpy views)."""
    out = []
    for (period, repeat), gtree in zip(shapes, groups):
        layers = []
        for r in range(repeat):
            for i in range(period):
                pick = (lambda a, r=r: np.asarray(a)[r]) if repeat > 1 else np.asarray
                layers.append(map_tree(pick, gtree["layers"][i]))
        out.append({"layers": layers})
    return out


def _group_shapes(cfg):
    return [(len(g.period), g.repeat) for g in cfg.groups()]


def _port_layout(tree, cfg) -> Dict:
    """The reference's numpy tree in the port's layout (numpy views)."""
    out = {k: map_tree(np.asarray, v) for k, v in tree.items() if k not in ("groups", "encoder")}
    out["groups"] = _unstack_groups(tree["groups"], _group_shapes(cfg))
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {"groups": _unstack_groups(enc["groups"], [(1, cfg.n_encoder_layers)]),
                          "final_norm": np.asarray(enc["final_norm"])}
    return out


def _block(a: np.ndarray, sh) -> np.ndarray:
    """The rank's block of ``a`` under NamedSharding ``sh``."""
    from repro_torch.sharding import rules as shr

    coord = dict(zip(sh.mesh.mesh_dim_names, sh.mesh.get_coordinate()))
    sizes = shr.mesh_shape(sh.mesh)
    for dim, part in enumerate(sh.spec):
        n, idx = 1, 0
        for ax in (part if isinstance(part, tuple) else (part,)):
            if ax is not None:
                n, idx = n * sizes[ax], idx * sizes[ax] + coord[ax]
        step = a.shape[dim] // n
        a = a.take(range(idx * step, (idx + 1) * step), axis=dim) if n > 1 else a
    return a


def params_from_reference(tree, cfg, device, shardings=None) -> Dict:
    """The port's parameters from the reference's as a numpy tree; with
    ``shardings``, each leaf the DTensor of the rank's block."""
    layout = _port_layout(tree, cfg)
    if shardings is None:
        return map_tree(lambda a: tensor_from_numpy(a, device), layout)
    from torch.distributed.tensor import DTensor

    return map_tree(lambda a, sh: DTensor.from_local(tensor_from_numpy(_block(a, sh), device),
                                                     sh.mesh, sh.placements, run_check=False),
                    layout, shardings)


def cache_from_reference(tree, cfg, device) -> Dict:
    """The port's decode cache from the reference's as a numpy tree."""
    return map_tree(lambda a: tensor_from_numpy(a, device),
                    {"groups": _unstack_groups(tree["groups"], _group_shapes(cfg))})


def opt_state_from_reference(opt, cfg, device):
    """The port's ``AdamWState`` from the reference's (step, m, v) as a numpy
    tree."""
    return AdamWState(step=tensor_from_numpy(opt.step, device),
                      m=params_from_reference(opt.m, cfg, device),
                      v=params_from_reference(opt.v, cfg, device))


def train_state_from_reference(state, cfg, device):
    """The port's ``TrainState`` from the reference's (params, opt, step) as
    a numpy tree."""
    return TrainState(params=params_from_reference(state.params, cfg, device),
                      opt=opt_state_from_reference(state.opt, cfg, device),
                      step=tensor_from_numpy(state.step, device))


def _coordinate(mesh, rank=None) -> Dict[str, int]:
    """The mesh coordinates of global ``rank`` (this process's by default)."""
    names = mesh.mesh_dim_names
    if rank is None:
        return dict(zip(names, mesh.get_coordinate()))
    at = (mesh.mesh == rank).nonzero()
    if at.shape[0] != 1:
        raise ValueError(f"rank {rank} is not on the mesh {mesh}")
    return dict(zip(names, at[0].tolist()))


def cache_block(cache, cfg, mesh, rank=None, *, max_len=None, batch=None):
    """The rank's blocks (``rank``: a global rank, this process's by
    default) of a whole decode cache in the port's layout
    (:func:`cache_from_reference`'s, or a prefill's): each K/V leaf's block
    of its global slots -- ``max_len`` for the full-attention layers
    (their length in ``cache`` by default; a shorter leaf is a prefill's,
    zero past its end), the window for rings, ``encoder_seq`` for cross
    K/V -- where ``models.make_cache``'s layout splits its sequence for a
    decode batch of ``batch`` global rows (the leaves' by default), and
    the KV heads and Mamba-2 heads the rank holds where a leaf has all of
    them. The batch stays whole: every rank is given the whole batch."""
    from dataclasses import replace

    from repro_torch.models.attention import cache_heads
    from repro_torch.models.model import cache_layout, group_layers
    from repro_torch.models.parallel import tensor_parallel

    coord = _coordinate(mesh, rank)
    tp = tensor_parallel(cfg, mesh)
    if tp is not None:
        tp = replace(tp, rank=coord.get("model", 0))
    B = leaves(cache)[0].shape[0] if batch is None else batch
    full = None
    for g, gc in zip(cfg.groups(), cache["groups"]):
        for spec, lc in zip(group_layers(g), gc["layers"]):
            if spec.mixer == "attn" and full is None:
                full = max_len or lc["attn"]["k"].shape[1]
    lay = cache_layout(cfg, B, full or 1, mesh)
    full = lay.pop("slots")
    lay = {k: None if v is None else replace(v, index=coord[v.axis]) for k, v in lay.items()}

    def kv(a, length, seq):
        n = 1 if seq is None else seq.n
        L = length // n
        lo = 0 if seq is None else seq.index * L
        heads = cache_heads(cfg, tp, seq)
        if a.shape[2] == cfg.n_kv_heads and heads < cfg.n_kv_heads:
            h0, h1 = tp.kv_range()
            a = a[:, :, h0:h1]
        out = torch.zeros((a.shape[0], L, *a.shape[2:]), dtype=a.dtype, device=a.device)
        have = max(0, min(lo + L, a.shape[1]) - lo)
        out[:, :have] = a[:, lo:lo + have]
        return out

    def heads(a, dim, whole):
        if tp is None or not tp.ssm or a.shape[dim] != whole:
            return a
        n = whole // tp.size
        return a.narrow(dim, tp.rank * n, n).contiguous()

    groups = []
    for g, gc in zip(cfg.groups(), cache["groups"]):
        layers = []
        for spec, lc in zip(group_layers(g), gc["layers"]):
            out = {}
            if "attn" in lc:
                window = cfg.sliding_window if spec.mixer == "swa" else 0
                seq = lay["ring" if window else "full"]
                out["attn"] = {k: kv(a, window or full, seq) for k, a in lc["attn"].items()}
            if "mamba" in lc:
                m = lc["mamba"]
                out["mamba"] = {"state": heads(m["state"], 1, cfg.ssm_heads),
                                "conv_x": heads(m["conv_x"], 2, cfg.d_inner),
                                "conv_B": m["conv_B"], "conv_C": m["conv_C"]}
            if "cross" in lc:
                out["cross"] = {k: kv(a, cfg.encoder_seq, lay["cross"])
                                for k, a in lc["cross"].items()}
            layers.append(out)
        groups.append({"layers": layers})
    return {"groups": groups}

