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
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.division_modes import DivisionConfig
from repro_torch.optim.adamw import AdamWState
from repro_torch.train.step import TrainState
from repro_torch.tree import map_tree

__all__ = ["config_from_reference", "tensor_from_numpy", "tensors_from_numpy",
           "params_from_reference", "cache_from_reference", "opt_state_from_reference",
           "train_state_from_reference"]


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
