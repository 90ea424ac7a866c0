"""Logical-axis -> mesh-axis resolution (t5x-style rules), and the active mesh.

The port of ``src/repro/sharding/rules.py``. A parameter's logical axes
(e.g. ('embed', 'heads', 'head_dim')) resolve to a spec through the arch's
rules dict. A spec is a plain tuple with one entry per tensor dim: a mesh
axis name, a tuple of names (the dim split over several mesh axes, the
first major), or None (replicated) -- the entries of the reference's
``PartitionSpec``. Two safety drops keep every spec valid by construction:

  * divisibility drop -- a dim not divisible by its mesh axis size falls
    back to replicated (GQA with kv_heads below the model-axis size
    degrades to replicated KV);
  * duplicate drop -- a mesh axis already taken by an earlier dim of the
    same parameter is not reused (Jamba's experts->data and embed->data).

A torch ``DeviceMesh`` plays the part of the reference's ``Mesh`` and a
``DTensor`` that of a sharded ``jax.Array``: :func:`placements` turns a spec
into the DTensor placements on a mesh (``Shard(d)`` on every mesh dim that
dim d is split over, ``Replicate()`` elsewhere; a dim split over ('pod',
'data') is split pod-major, as in JAX). Every function that reads only
sizes takes a ``DeviceMesh`` or any object whose ``.shape`` maps axis
names to sizes (a stand-in for a production mesh of 256 or 512 ranks).

The tensor-parallel path reads :func:`model_dims` (which dim of each leaf
lies on ``model``, from the resolved spec), :func:`axis_index` (this rank's
place on an axis) and :func:`local_tree` (this rank's blocks of a tree of
DTensors, or of a global tree that is the same on every rank);
:func:`global_tensor` gathers a DTensor's global value (checkpoints).

The decode cache's layout has one rule, :func:`cache_seq_axis` (the
reference's ``cache_specs`` of ``src/repro/launch/dryrun.py`` for the K/V
leaves' sequence): the ``__kv_seq_shard__`` axis (the ``kvseq`` layout),
else ``data`` where the batch does not take ``data`` (a batch-1 long
context), each only where the length divides. ``models.cache_layout``
reads it, and ``models.make_cache``, the decode step and
``convert.cache_block`` read that, so a rank holds its block of the
slots; the batch and the heads follow the rank's rows and its
tensor-parallel plan (``models.make_cache`` says where they differ from
the reference's specs).

The active mesh (:func:`use_mesh`, :func:`suspend_mesh`,
:func:`active_mesh`) is what the launcher registers; the kernels' mesh
dispatch (``kernels/ops.py``), the sharded workloads, the MoE FFN and the
train step read it. :func:`split_tokens` says, for a scope, over which batch
axes the rows that the model is given are split (the train step's block of
the batch); outside one, every rank holds the whole batch (a forward or the
serving engine), and :func:`token_axes` is empty. Importing this module
starts no process group.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

__all__ = ["mesh_shape", "spec_for", "placements", "NamedSharding",
           "param_shardings", "param_fallbacks", "batch_axes",
           "batch_partition", "data_spec", "data_sharding", "replicated",
           "use_mesh", "suspend_mesh", "active_mesh", "split_tokens", "token_axes",
           "shard_dim",
           "axes_size", "local_offset", "local_block", "batch_sharding", "batch_local",
           "same_placements",
           "distribute", "axis_index", "only_axes", "local_shape", "model_dims", "local_tree",
           "global_tensor", "cache_seq_axis"]

Spec = Tuple[Optional[object], ...]


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (whose ``.shape`` is a tuple)
    or of any object whose ``.shape`` is already that mapping."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


def _mesh_axes(mesh) -> Tuple[str, ...]:
    return tuple(mesh_shape(mesh))


def axes_size(mesh, axes) -> int:
    """The number of ranks along ``axes`` (1 for none)."""
    shape = mesh_shape(mesh)
    n = 1
    for ax in axes:
        n *= shape[ax]
    return n


def spec_for(shape: Tuple[int, ...], axes: Tuple[Optional[str], ...],
             rules: Dict[str, Optional[str]], mesh, drops: Optional[list] = None) -> Spec:
    """Resolve a parameter's logical axes to a spec.

    ``drops``, when passed, collects one record per silent fallback: a dim
    whose rule named a mesh axis that could not be honoured (duplicate use,
    axis missing from the mesh, or size not divisible). Dims whose rule is
    None are intended replication, not drops.
    """
    sizes = mesh_shape(mesh)
    parts = []
    used = set()
    for dim, (size, ax) in enumerate(zip(shape, axes)):
        mesh_ax = rules.get(ax) if ax is not None else None
        if mesh_ax is None:
            parts.append(None)
            continue
        if mesh_ax in used:
            reason = "duplicate"
        elif mesh_ax not in sizes:
            reason = "missing-axis"
        elif size % sizes[mesh_ax] != 0:
            reason = "indivisible"
        else:
            parts.append(mesh_ax)
            used.add(mesh_ax)
            continue
        if drops is not None:
            drops.append({"dim": dim, "logical_axis": ax, "mesh_axis": mesh_ax,
                          "dim_size": int(size),
                          "mesh_axis_size": int(sizes.get(mesh_ax, 0)),
                          "reason": reason})
        parts.append(None)
    return tuple(parts)


def placements(spec: Spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in _mesh_axes(mesh)]
    names = _mesh_axes(mesh)
    for dim, part in enumerate(spec):
        for ax in (part if isinstance(part, tuple) else (part,)):
            if ax is not None:
                out[names.index(ax)] = Shard(dim)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    mesh: object
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def param_shardings(cfg, mesh):
    """Tree of :class:`NamedSharding`, matching the port's parameter tree
    (one leaf per layer: the reference's stacked ``layers`` axis, whose rule
    is None, is not there, so each spec is the reference's without that
    dim)."""
    from repro_torch import tree
    from repro_torch.configs.base import rules_for
    from repro_torch.models.params import model_specs

    rules = rules_for(cfg)
    return tree.map_tree(lambda p: NamedSharding(mesh, spec_for(p.shape, p.axes, rules, mesh)),
                         model_specs(cfg))


def only_axes(spec: Spec, axes) -> Spec:
    """``spec`` with every mesh axis outside ``axes`` replicated."""
    out = []
    for part in spec:
        kept = tuple(ax for ax in (part if isinstance(part, tuple) else (part,))
                     if ax is not None and ax in axes)
        out.append(None if not kept else kept[0] if len(kept) == 1 else kept)
    return tuple(out)


def model_dims(cfg, mesh, axis: str = "model"):
    """Tree matching the parameter tree: the dim of each leaf that lies on
    ``axis`` in its resolved spec (after the divisibility and duplicate
    drops), None for a leaf replicated over ``axis``. The duplicate drop
    puts an axis on at most one dim of a leaf."""
    from repro_torch import tree

    def dim(sh):
        dims = [d for d, part in enumerate(sh.spec)
                if axis in (part if isinstance(part, tuple) else (part,))]
        return dims[0] if dims else None

    return tree.map_tree(dim, param_shardings(cfg, mesh))


def local_shape(shape, sharding: NamedSharding) -> Tuple[int, ...]:
    """The shape of one rank's block of a tensor of ``shape``."""
    sizes = mesh_shape(sharding.mesh)
    out = list(shape)
    for dim, part in enumerate(sharding.spec):
        for ax in (part if isinstance(part, tuple) else (part,)):
            if ax is not None:
                out[dim] //= sizes[ax]
    return tuple(out)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` of ``mesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))[axis]


def param_fallbacks(cfg, mesh) -> list:
    """Every silent sharding drop across the model's parameters, as report
    rows: the parameter's path, shape and full (replicated) byte size with
    the drop record. ``mesh`` needs only a ``.shape``."""
    from repro_torch import tree
    from repro_torch.configs.base import rules_for
    from repro_torch.models.params import model_specs, torch_dtype

    rules = rules_for(cfg)
    specs = model_specs(cfg)
    entries = []
    for path, p in zip(tree.paths(specs), tree.leaves(specs)):
        drops: list = []
        spec_for(p.shape, p.axes, rules, mesh, drops=drops)
        itemsize = torch.empty((), dtype=torch_dtype(p.dtype or cfg.param_dtype)).element_size()
        n = 1
        for s in p.shape:
            n *= s
        for d in drops:
            entries.append({"param": path, "shape": list(p.shape),
                            "bytes": n * itemsize, **d})
    return entries


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes that carry the batch dim: ('pod', 'data') when pod exists."""
    return tuple(ax for ax in ("pod", "data") if ax in mesh_shape(mesh))


def batch_partition(mesh, batch_size: Optional[int]) -> Tuple[str, ...]:
    """Largest prefix of ('pod', 'data') whose rank count divides the batch
    (the full prefix when ``batch_size`` is None)."""
    ba = batch_axes(mesh)
    if batch_size is None:
        return ba
    while ba:
        if batch_size % axes_size(mesh, ba) == 0:
            return ba
        ba = ba[:-1]
    return ()


def data_spec(mesh, ndim: int, *, batch_dim: int = 0, seq_dim: Optional[int] = None,
              seq_axis: Optional[str] = None, batch_size: Optional[int] = None) -> Spec:
    """The spec of an input: the batch dim over the largest divisible prefix
    of ('pod', 'data'); optionally a sequence dim over ``seq_axis``."""
    parts: list = [None] * ndim
    ba = batch_partition(mesh, batch_size)
    if ba:
        parts[batch_dim] = ba if len(ba) > 1 else ba[0]
    if seq_dim is not None and seq_axis is not None and seq_axis in mesh_shape(mesh):
        parts[seq_dim] = seq_axis
    return tuple(parts)


def data_sharding(mesh, ndim: int, *, batch_dim: int = 0, seq_dim: Optional[int] = None,
                  seq_axis: Optional[str] = None,
                  batch_size: Optional[int] = None) -> NamedSharding:
    return NamedSharding(mesh, data_spec(mesh, ndim, batch_dim=batch_dim, seq_dim=seq_dim,
                                         seq_axis=seq_axis, batch_size=batch_size))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def _dim_split(sharding: NamedSharding, dim: int):
    """(parts, this rank's part index) of ``dim`` under ``sharding``."""
    mesh = sharding.mesh
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = mesh_shape(mesh)
    part = sharding.spec[dim] if dim < len(sharding.spec) else None
    n, idx = 1, 0
    for ax in (part if isinstance(part, tuple) else (part,)):
        if ax is not None:
            n, idx = n * sizes[ax], idx * sizes[ax] + coord[ax]
    return n, idx


def local_offset(sharding: NamedSharding, dim: int = 0, size: Optional[int] = None) -> int:
    """Where this rank's block of ``dim`` starts in the global tensor (whose
    ``dim`` has ``size`` entries; needed unless it is unsplit)."""
    n, idx = _dim_split(sharding, dim)
    return 0 if n == 1 else idx * (size // n)


def local_block(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of the global tensor ``t`` under ``sharding``: each
    sharded dim cut into equal blocks, the first mesh axis major. A view; no
    communication."""
    for dim in range(len(sharding.spec)):
        n, idx = _dim_split(sharding, dim)
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split into {n} blocks "
                             f"({sharding.spec[dim]})")
        step = t.shape[dim] // n
        t = t.narrow(dim, idx * step, step)
    return t


def batch_sharding(mesh, axes: Tuple[str, ...], ndim: int) -> NamedSharding:
    """Dim 0 split over ``axes``, the other dims replicated."""
    return NamedSharding(mesh, ((axes if len(axes) > 1 else axes[0]),) + (None,) * (ndim - 1))


def same_placements(mesh, got, want) -> bool:
    """Placements ``got`` and ``want`` place a tensor alike on ``mesh`` (a
    mesh axis of size 1 holds the whole dim either way)."""
    return want is not None and all(
        n == 1 or g == w for n, g, w in zip(mesh_shape(mesh).values(), got, want))


def batch_local(x, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of ``x`` under ``sharding``: ``x`` is a DTensor so
    placed (its ``to_local()``), or the global tensor, the same on every
    rank (its block, a view). Raises ValueError for a DTensor placed
    otherwise."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        if x.device_mesh != sharding.mesh or not same_placements(
                sharding.mesh, x.placements, sharding.placements):
            raise ValueError(f"a DTensor with placements {tuple(x.placements)} on "
                             f"{x.device_mesh}; {sharding.placements} on "
                             f"{sharding.mesh} is wanted")
        return x.to_local()
    return local_block(x, sharding)


def local_tree(t, shardings):
    """This rank's block of every leaf of ``t`` under the matching
    :class:`NamedSharding` of ``shardings``: a DTensor so placed gives its
    ``to_local()``, a plain tensor (the global value, the same on every
    rank) its block, a view (:func:`batch_local`). Raises ValueError for a
    DTensor placed otherwise."""
    from repro_torch import tree

    return tree.map_tree(lambda x, sh: batch_local(x, sh), t, shardings)


def global_tensor(x) -> torch.Tensor:
    """The global value of ``x`` on every rank: a DTensor's blocks gathered
    through ``sharding/comm.py`` (host copies, recorded), a plain tensor
    itself."""
    from torch.distributed.tensor import DTensor, Shard

    from . import comm

    if not isinstance(x, DTensor):
        return x
    t = x.to_local()
    names = _mesh_axes(x.device_mesh)
    # The innermost mesh axis of a dim first, so a dim split over several
    # axes comes back in mesh order (the first axis major).
    for i in reversed(range(len(names))):
        pl = x.placements[i]
        if isinstance(pl, Shard) and mesh_shape(x.device_mesh)[names[i]] > 1:
            t = comm.all_gather(t, x.device_mesh, [names[i]], dim=pl.dim)
    return t


def distribute(t: torch.Tensor, sharding: NamedSharding):
    """The DTensor whose global value is ``t`` (the same on every rank),
    placed as ``sharding`` says: each rank keeps its own block. No
    communication."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local_block(t, sharding).contiguous(), sharding.mesh,
                              sharding.placements, run_check=False)


# ------------------------------------------------------- the cache's layout

def cache_seq_axis(cfg, mesh, batch: int, length: int) -> Optional[str]:
    """The mesh axis that the sequence of a K/V cache leaf of ``length``
    slots lies on, for a decode batch of ``batch`` rows (the global batch):
    the ``__kv_seq_shard__`` axis where the length divides by it, else
    ``data`` where the batch does not split over ``data`` and the length
    divides; None where it is whole. The axis may hold one rank."""
    sizes = mesh_shape(mesh)
    kv_seq = cfg.sharding_rules.get("__kv_seq_shard__")
    if kv_seq and length % sizes.get(kv_seq, 1) == 0:
        return kv_seq
    if ("data" not in batch_partition(mesh, batch) and "data" in sizes
            and length % sizes["data"] == 0):
        return "data"
    return None


# ----------------------------------------------------------- the active mesh

_ACTIVE = threading.local()


@contextlib.contextmanager
def use_mesh(mesh):
    """Register ``mesh`` as the active mesh for a scope."""
    prev = getattr(_ACTIVE, "mesh", None)
    _ACTIVE.mesh = mesh
    try:
        yield
    finally:
        _ACTIVE.mesh = prev


@contextlib.contextmanager
def suspend_mesh():
    """Hide the active mesh for a scope: the sharded workloads run their
    division sites on each rank's own block under it, so the kernels' mesh
    dispatch sees no mesh there."""
    prev = getattr(_ACTIVE, "mesh", None)
    _ACTIVE.mesh = None
    try:
        yield
    finally:
        _ACTIVE.mesh = prev


def active_mesh():
    return getattr(_ACTIVE, "mesh", None)


@contextlib.contextmanager
def split_tokens(axes: Tuple[str, ...]):
    """For a scope, the rows the model is given are this rank's block of the
    global batch, split over ``axes`` (batch axes of the active mesh, the
    first major) -- what the MoE FFN's capacity and positions are reckoned
    over."""
    prev = getattr(_ACTIVE, "tokens", ())
    _ACTIVE.tokens = tuple(axes)
    try:
        yield
    finally:
        _ACTIVE.tokens = prev


def token_axes() -> Tuple[str, ...]:
    """The batch axes (above one rank) that the active rows are split over
    (:func:`split_tokens`); () where every rank holds the whole batch."""
    mesh = active_mesh()
    if mesh is None:
        return ()
    sizes = mesh_shape(mesh)
    return tuple(ax for ax in getattr(_ACTIVE, "tokens", ()) if sizes.get(ax, 1) > 1)


def shard_dim(x, dim: int, axis: str = "model"):
    """Redistribute one dim of a DTensor over a mesh axis, its other
    placements kept. A plain tensor, no active mesh, an axis the mesh lacks
    or a dim the axis does not divide: ``x`` unchanged."""
    from torch.distributed.tensor import DTensor, Shard

    mesh = active_mesh()
    if mesh is None or not isinstance(x, DTensor) or axis not in mesh_shape(mesh):
        return x
    if dim < 0:
        dim += x.ndim
    if x.shape[dim] % mesh_shape(mesh)[axis] != 0:
        return x
    pl = list(x.placements)
    pl[_mesh_axes(x.device_mesh).index(axis)] = Shard(dim)
    return x.redistribute(x.device_mesh, pl)
