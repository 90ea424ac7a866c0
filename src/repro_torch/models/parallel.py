"""Tensor parallelism over the mesh's ``model`` axis for the attention models.

The reference shards its parameters by the logical-axis rules
(``DEFAULT_RULES``: ``heads``, ``kv_heads``, ``mlp`` and ``vocab`` on
``model``) and lets GSPMD execute the split under ``jit``, steered by its
``shard_dim`` constraints (``src/repro/models/attention.py``,
``src/repro/models/model.py``). Here each rank computes on plain local
blocks and issues the collectives itself, through ``sharding/comm.py``:

  * column-split products (``wq``/``wk``/``wv`` over heads, ``wi``/``wg``
    over ``mlp``, the LM head over ``vocab``) read their input through
    ``comm.copy_to_split``; row-split ones (``wo`` of attention and of the
    MLP) hand their partial sums, in the product's dtype, to
    ``comm.reduce_from_split``;
  * the embedding gathers the rank's vocab rows (zero elsewhere) and sums
    them over the ranks: exact, one row of the sum is not zero;
  * logits stay split over vocab: the loss takes a split logsumexp, the
    serving engine a split argmax.

What is split is each leaf's resolved spec (``rules.spec_for``: a dim that
does not divide, or an axis already used, runs replicated, as GSPMD runs
it). Where ``kv_heads`` is replicated and ``heads`` split (GQA with fewer
KV heads than ranks), a rank projects only the KV heads its own query heads
read, from the replicated weights (whose gradients are summed over the
ranks). The decode cache holds those local KV heads.

The MoE FFN's expert leaves (``wi``, ``wg``, ``wo``) are split by their
``experts`` and ``expert_mlp`` dims over whatever axes their specs name --
``data`` (expert parallelism, the MoE models' own rules), ``model`` (the
``ep_model`` and ``ep_tp`` layouts) or both -- and its shared experts over
``mlp`` as the dense MLP; :class:`ExpertParallel` records the axes and
``models/moe.py`` runs the exchange. A plan is needed wherever a leaf is
split: a ``model`` axis above 1, or experts on a ``data`` axis above 1.

The Mamba-2 mixer splits over ``model`` by heads (``ssm_inner`` and
``ssm_heads``, the reference's ``DEFAULT_RULES`` and jamba's rules):
``wz``, ``wx``, ``conv_x``, the gated norm's weight and ``wout``'s rows by
the ``ssm_inner`` columns, ``wdt``, ``A_log``, ``D`` and ``dt_bias`` by
heads; ``wB``, ``wC``, ``conv_B`` and ``conv_C`` (``ssm_state``) are whole
on every rank, which reads them for its own heads only, so their gradients
are summed over the ranks (``models/mamba2.py``). The mixer cuts ``xs``
into heads contiguous in ``d_inner``, so a column split is a head split
only where ``ssm_heads`` divides too: where ``ssm_inner`` splits and
``ssm_heads`` does not (48 heads at model 32), the mixer's leaves are held
whole and the mixer runs whole on every rank, as a divisibility drop
(``TensorParallel.ssm`` False; place such leaves by the plan's
``shardings``).

Every other dim that a leaf's spec puts on a batch axis (jamba's ``embed``
on ``data``: FSDP) is stored as the rank's block and put together where
it is used (``comm.gather_from_split``: an all-gather forward, the
reduce-scatter of its gradient backward): a block's leaves at the top of
``models.model.block_forward`` -- inside remat's checkpoint, so the
recompute gathers again and no gathered copy is kept for the backward
pass -- and the embedding, final norm and LM head where ``forward`` reads
them. The plan records each such dim (``TensorParallel.fsdp``); the
tensor-parallel and expert checks read the specs after the gather. An
expert leaf's ``embed`` dim stays whole where its experts take ``data``
(the duplicate drop).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import LayerSpec, ModelConfig, rules_for

__all__ = ["AXIS", "ExpertParallel", "TensorParallel", "SeqSplit", "tensor_parallel",
           "seq_parallel", "kv_split", "kv_full_split", "kv_heads_whole", "local_params",
           "wrap_like", "split_axes", "executed_spec", "gather_tree"]

AXIS = "model"
# The batch axes, over which a leaf's non-expert dims are gathered (FSDP).
GATHER_AXES = ("pod", "data")
EXPERT_AXES = ("experts", "expert_mlp")
SSM_AXES = ("ssm_inner", "ssm_heads")
# The Mamba-2 mixer's leaves by how they split over ``model``, with the dim
# each lies on there; the ``ssm_state`` leaves stay whole.
SSM_INNER = {"wz": (1,), "wx": (1,), "conv_x": (1,), "norm": (0,), "wout": (0,)}
SSM_HEADS = {"wdt": (1,), "A_log": (0,), "D": (0,), "dt_bias": (0,)}
SSM_WHOLE = ("wB", "wC", "conv_B", "conv_C")


@dataclass(frozen=True)
class ExpertParallel:
    """Where the MoE FFN's leaves lie: the mesh axis (above one rank) that
    holds the routed experts and this rank's place on it, the axis of their
    ``expert_mlp`` dim, and the axis of the shared experts' ``mlp`` dim;
    None where a dim is whole."""

    experts: Optional[str]
    n_split: int        # ranks along ``experts`` (1 without)
    index: int          # this rank's block of experts
    mlp: Optional[str]
    shared: Optional[str]


@dataclass(frozen=True)
class TensorParallel:
    """A rank's share of the model axis: its size and index, which weight
    groups are split (from their resolved specs), the model-axis shardings
    of the parameter tree."""

    mesh: Any
    size: int
    rank: int
    heads: bool         # wq over heads, attention wo over heads
    kv: bool            # wk / wv over kv_heads
    mlp: bool           # wi / wg over mlp, MLP wo over mlp
    vocab: bool         # the embedding's rows and the LM head's columns
    n_heads: int
    n_kv_heads: int
    shardings: Any      # NamedSharding tree of the executed specs (executed_spec)
    moe: Optional[ExpertParallel] = None
    ssm: bool = False   # the Mamba-2 mixer by heads (ssm_inner and ssm_heads split)
    # The gathered dims (FSDP): for each block kind (its LayerSpec and
    # whether it has cross attention) and for the top-level leaves
    # (``"top"``: embed, final_norm, lm_head), a tree of each leaf's
    # ((axis, dim), ...) pairs; empty where no leaf is gathered.
    fsdp: Dict[Any, Any] = field(default_factory=dict)
    # The residual stream is the rank's block of the sequence (seq_shard):
    # the sub-layers' gathers and scatters take the place of into / out.
    seq: bool = False

    def gather_block(self, bp, spec, cross: bool = False):
        """A block's leaves put together from the rank's blocks of them over
        the batch axes; the leaves split over ``model`` stay its blocks."""
        g = self.fsdp.get((spec, cross))
        return bp if g is None else gather_tree(bp, g, self.mesh)

    def gather_top(self, t, name: str):
        """The top-level leaf ``name`` (embed, final_norm, lm_head) put
        together, as :meth:`gather_block`."""
        pairs = self.fsdp.get("top", {}).get(name, ())
        return _gather(t, pairs, self.mesh)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """Identity forward, gradient summed over the ranks backward."""
        from repro_torch.sharding import comm

        return comm.copy_to_split(x, self.mesh, (AXIS,))

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks forward, gradient handed on backward."""
        from repro_torch.sharding import comm

        return comm.reduce_from_split(x, self.mesh, (AXIS,))

    def into(self, x: torch.Tensor) -> torch.Tensor:
        """An activation entering a column-split product: :meth:`copy`, or
        itself where the sequence is split (the all-gather that made it
        reduce-scatters its gradient)."""
        return x if self.seq else self.copy(x)

    def out(self, y: torch.Tensor) -> torch.Tensor:
        """A row-split product's partial sums: :meth:`reduce`, or themselves
        where the sequence is split (the reduce-scatter that follows sums
        them)."""
        return y if self.seq else self.reduce(y)

    def own_heads(self, x: torch.Tensor, dim: int = 2) -> torch.Tensor:
        """This rank's block of a tensor of every query head."""
        return x.narrow(dim, self.rank * self.heads_local, self.heads_local)

    @property
    def heads_local(self) -> int:
        return self.n_heads // self.size if self.heads else self.n_heads

    def kv_range(self) -> Tuple[int, int]:
        """The KV heads [lo, hi) this rank projects and caches: its block
        when ``kv_heads`` is split, the ones its query heads read when only
        ``heads`` is, all of them when neither is."""
        if self.kv:
            n = self.n_kv_heads // self.size
            return self.rank * n, (self.rank + 1) * n
        if not self.heads:
            return 0, self.n_kv_heads
        q_per_kv = self.n_heads // self.n_kv_heads
        first = self.rank * self.heads_local
        return first // q_per_kv, (first + self.heads_local - 1) // q_per_kv + 1

    @property
    def kv_local(self) -> int:
        lo, hi = self.kv_range()
        return hi - lo

    def kv_index(self, device) -> Optional[torch.Tensor]:
        """For each local query head, its KV head among the local ones;
        None where the plain GQA repeat gives it (every KV head's queries
        on this rank)."""
        if self.kv or not self.heads:
            return None
        q_per_kv = self.n_heads // self.n_kv_heads
        lo, _ = self.kv_range()
        first = self.rank * self.heads_local
        return torch.tensor([(first + i) // q_per_kv - lo for i in range(self.heads_local)],
                            dtype=torch.long, device=device)

    def vocab_offset(self, local_vocab: int) -> int:
        return self.rank * local_vocab if self.vocab else 0

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' blocks of ``x``'s ``dim`` (the last by default) side by
        side (all-gather); the gradient's sum over the ranks, sliced to this
        rank's block, backward (reduce-scatter)."""
        from repro_torch.sharding import comm

        return comm.gather_blocks(x, self.mesh, AXIS, dim % x.dim())


@dataclass(frozen=True)
class SeqSplit:
    """A decode-cache leaf whose sequence lies on ``axis`` of ``mesh``: ``n``
    ranks, this one holding block ``index`` of the slots."""

    mesh: Any
    axis: str
    n: int
    index: int


def _seq_split(mesh, axis: Optional[str]) -> Optional[SeqSplit]:
    from repro_torch.sharding import rules as shr

    sizes = shr.mesh_shape(mesh)
    if axis is None or sizes[axis] == 1:
        return None
    return SeqSplit(mesh, axis, sizes[axis], shr.axis_index(mesh, axis))


def kv_split(cfg: ModelConfig, mesh, batch: int, length: int) -> Optional[SeqSplit]:
    """How a K/V cache leaf of ``length`` global slots lies for a decode
    batch of ``batch`` global rows (``rules.cache_seq_axis``); None where it
    is whole on every rank (no mesh, or an axis of one rank)."""
    from repro_torch.sharding import rules as shr

    if mesh is None:
        return None
    return _seq_split(mesh, shr.cache_seq_axis(cfg, mesh, batch, length))


def kv_full_split(cfg: ModelConfig, mesh, batch: int) -> Optional[SeqSplit]:
    """How a full-attention cache leaf lies for a decode batch of ``batch``
    global rows: split over the first live axis that
    ``rules.cache_seq_axis`` would put a length divisible by it on (the
    ``__kv_seq_shard__`` axis, else ``data`` where the batch does not take
    it), whatever the cache's length (``models.cache_layout`` rounds the
    slots up to a multiple of it), so a decode step reads the layout from
    the mesh and the batch alone; None where it is whole."""
    from repro_torch.sharding import rules as shr

    if mesh is None:
        return None
    sizes = shr.mesh_shape(mesh)
    for axis in (cfg.sharding_rules.get("__kv_seq_shard__"), "data"):
        if axis in sizes and sizes[axis] > 1 and shr.cache_seq_axis(
                cfg, mesh, batch, sizes[axis]) == axis:
            return _seq_split(mesh, axis)
    return None


def kv_heads_whole(cfg: ModelConfig, tp: Optional["TensorParallel"]) -> bool:
    """Whether a prefill hands its K/V on with every KV head: under
    ``kvseq`` on a live model axis, whose cache holds them all."""
    return (tp is not None and tp.size > 1
            and cfg.sharding_rules.get("__kv_seq_shard__") == AXIS)


def seq_parallel(cfg: ModelConfig, tp: Optional["TensorParallel"], s: int, mode: str):
    """The plan of a forward over ``s`` positions: ``tp`` with ``seq`` set
    where ``__seq_shard__`` names ``model``, the model axis holds more than
    one rank and divides ``s`` (train and prefill), else ``tp``. Another
    axis is refused."""
    axis = cfg.sharding_rules.get("__seq_shard__")
    if axis is None or tp is None:
        return tp
    if axis != AXIS:
        raise ValueError(f"{cfg.name}: __seq_shard__ names {axis!r}; the sequence splits "
                         f"only over '{AXIS}'")
    if mode == "decode" or tp.size == 1 or s % tp.size:
        return tp
    from dataclasses import replace

    return replace(tp, seq=True)


def _dims(spec) -> Tuple[int, ...]:
    return tuple(d for d, part in enumerate(spec) if part == AXIS)


def executed_spec(p, spec):
    """The part of a leaf's resolved spec that the port executes: its
    ``model`` entries, the entries of its ``experts`` and ``expert_mlp``
    dims, and its dims on the batch axes (stored as blocks and gathered
    before use) -- all of it."""
    return tuple(part if part == AXIS or part in GATHER_AXES or ax in EXPERT_AXES else None
                 for part, ax in zip(spec, p.axes))


def _live_axis(part, sizes):
    return part if part is not None and sizes[part] > 1 else None


def _gathered(p, spec, sizes) -> Tuple[Tuple[str, int], ...]:
    """The (axis, dim) pairs of a leaf that are gathered before use: its
    non-expert dims on a batch axis above one rank."""
    return tuple((part, d) for d, (part, ax) in enumerate(zip(spec, p.axes))
                 if part in GATHER_AXES and ax not in EXPERT_AXES and sizes[part] > 1)


def _after_gather(p, spec):
    """The spec a leaf is computed with: the gathered dims whole."""
    return tuple(None if part in GATHER_AXES and ax not in EXPERT_AXES else part
                 for part, ax in zip(spec, p.axes))


def _gather(t: torch.Tensor, pairs, mesh) -> torch.Tensor:
    from repro_torch.sharding import comm

    for axis, dim in pairs:
        t = comm.gather_from_split(t, mesh, axis, dim)
    return t


def gather_tree(t, gathers, mesh):
    """Each leaf of ``t`` (the rank's blocks) gathered over its ``gathers``
    pairs (a tree of ((axis, dim), ...) matching ``t``)."""
    return tree.map_tree(lambda x, pairs: _gather(x, pairs, mesh), t, gathers)


def _expert_plan(cfg: ModelConfig, mesh, spec) -> Optional[ExpertParallel]:
    """The MoE FFN's axes from the resolved specs of its leaves; None for a
    model without MoE layers."""
    from repro_torch.models.params import _moe_specs
    from repro_torch.sharding import rules as shr

    if not any(s.ffn == "moe" for s in cfg.layer_specs()):
        return None
    sizes = shr.mesh_shape(mesh)
    moe = _moe_specs(cfg)
    wi, wg, wo = (tuple(_live_axis(a, sizes) for a in spec(moe[n])) for n in ("wi", "wg", "wo"))
    experts, mlp = wi[0], wi[2]
    if wg != wi or wo != (experts, mlp, None):
        raise ValueError(f"{cfg.name}: the expert leaves are split differently: wi {wi}, "
                         f"wg {wg}, wo {wo}")
    if any(spec(moe["router"])):
        raise ValueError(f"{cfg.name}: the router is split ({spec(moe['router'])}); the "
                         "MoE FFN routes on a whole router")
    shared = None
    if "shared" in moe:
        sh = {n: tuple(_live_axis(a, sizes) for a in spec(moe["shared"][n]))
              for n in ("wi", "wg", "wo")}
        shared = sh["wi"][1]
        if sh["wi"][0] or sh["wg"] != sh["wi"] or sh["wo"] != (shared, None):
            raise ValueError(f"{cfg.name}: the shared experts are split as {sh}; only "
                             "their mlp dim is split")
    if experts is not None and experts == mlp:
        raise ValueError(f"{cfg.name}: experts and expert_mlp on one axis {experts!r}")
    return ExpertParallel(experts=experts, n_split=sizes[experts] if experts else 1,
                          index=shr.axis_index(mesh, experts) if experts else 0,
                          mlp=mlp, shared=shared)


def _ssm_split(cfg: ModelConfig, spec) -> bool:
    """Whether the Mamba-2 mixer runs by heads on ``model``: both its
    ``ssm_inner`` and its ``ssm_heads`` leaves split there (``spec``: a
    leaf's resolved spec on ``model``). False without Mamba-2 layers, and
    for the divisibility drop (the columns split, the heads not)."""
    from repro_torch.models.params import _mamba_specs

    if not any(s.mixer == "mamba" for s in cfg.layer_specs()):
        return False
    leaves = _mamba_specs(cfg)
    got = {name: _dims(spec(p)) for name, p in leaves.items()}
    for name in SSM_WHOLE:
        if got[name]:
            raise ValueError(f"{cfg.name}: the Mamba-2 {name} lies on '{AXIS}' at dims "
                             f"{got[name]}; the mixer reads it whole")
    kinds = []
    for group in (SSM_INNER, SSM_HEADS):
        for name, want in group.items():
            if got[name] not in ((), want):
                raise ValueError(f"{cfg.name}: the Mamba-2 {name} lies on '{AXIS}' at dims "
                                 f"{got[name]}; the mixer splits only dims {want}")
        split = {bool(got[name]) for name in group}
        if len(split) > 1:
            raise ValueError(f"{cfg.name}: the Mamba-2 leaves {sorted(group)} are split "
                             f"differently over '{AXIS}'")
        kinds.append(split.pop())
    return kinds[0] and kinds[1]


def _plan(cfg: ModelConfig, mesh) -> TensorParallel:
    from repro_torch.models.params import _attn_specs, _block_specs, _mlp_specs, model_specs
    from repro_torch.sharding import rules as shr

    sizes = shr.mesh_shape(mesh)
    size = sizes.get(AXIS, 1)
    rules = rules_for(cfg)
    resolved = lambda p: executed_spec(p, shr.spec_for(p.shape, p.axes, rules, mesh))
    ssm = _ssm_split(cfg, lambda p: shr.only_axes(resolved(p), (AXIS,)))
    # A divisibility drop of the mixer holds its leaves whole on ``model``
    # (a batch-axis dim of theirs stays a gathered block).
    executed = (resolved if ssm else lambda p: (
        tuple(part if part in GATHER_AXES else None for part in resolved(p))
        if set(p.axes) & set(SSM_AXES) else resolved(p)))
    spec = lambda p: shr.only_axes(executed(p), (AXIS,))
    computed = lambda p: _after_gather(p, executed(p))
    split = {}
    expected = {"wq": (1,), "wk": (1,), "wv": (1,), "attn_wo": (0,), "wi": (1,), "wg": (1,),
                "mlp_wo": (0,), "embed": (0,), "lm_head": (1,)}
    attn, mlp = _attn_specs(cfg), _mlp_specs(cfg, cfg.dense_ff)
    leaves = {"wq": attn["wq"], "wk": attn["wk"], "wv": attn["wv"], "attn_wo": attn["wo"],
              "wi": mlp["wi"], "wg": mlp["wg"], "mlp_wo": mlp["wo"]}
    top = model_specs(cfg)
    for name in ("embed", "lm_head"):
        if name in top:
            leaves[name] = top[name]
    for name, p in leaves.items():
        got = _dims(spec(p))
        if got not in ((), expected[name]):
            raise ValueError(f"{cfg.name}: {name} {p.shape} lies on '{AXIS}' at dims {got}; "
                             f"the tensor-parallel path splits only dims {expected[name]}")
        split[name] = bool(got)
    for a, b in (("wq", "attn_wo"), ("wk", "wv"), ("wi", "wg"), ("wi", "mlp_wo")):
        if split[a] != split[b]:
            raise ValueError(f"{cfg.name}: {a} and {b} are split differently over '{AXIS}'")
    if split["wk"] and not split["wq"]:
        raise ValueError(f"{cfg.name}: kv_heads split over '{AXIS}' but heads not")
    vocab = [split[n] for n in ("embed", "lm_head") if n in split]
    if len(set(vocab)) > 1:
        raise ValueError(f"{cfg.name}: embed and lm_head are split differently over '{AXIS}'")
    shardings = tree.map_tree(lambda p: shr.NamedSharding(mesh, executed(p)), top)
    gathers = lambda specs: tree.map_tree(lambda p: _gathered(p, executed(p), sizes), specs)
    kinds = {(s, cfg.is_encoder_decoder) for s in cfg.layer_specs()}
    if cfg.is_encoder_decoder:
        kinds.add((LayerSpec("attn", "dense"), False))
    fsdp = {k: gathers(_block_specs(cfg, *k)) for k in kinds}
    fsdp["top"] = gathers({k: v for k, v in top.items() if k in ("embed", "final_norm",
                                                                  "lm_head")})
    used = [pairs for k in kinds for pairs in tree.leaves_at(fsdp[k], _block_specs(cfg, *k))]
    if not any(used + list(fsdp["top"].values())):
        fsdp = {}
    return TensorParallel(mesh=mesh, size=size,
                          rank=shr.axis_index(mesh, AXIS) if AXIS in sizes else 0,
                          heads=split["wq"], kv=split["wk"], mlp=split["wi"],
                          vocab=bool(vocab and vocab[0]), n_heads=cfg.n_heads,
                          n_kv_heads=cfg.n_kv_heads, shardings=shardings,
                          moe=_expert_plan(cfg, mesh, computed), ssm=ssm, fsdp=fsdp)


_PLANS: dict = {}


def tensor_parallel(cfg: ModelConfig, mesh=None) -> Optional[TensorParallel]:
    """The plan of ``cfg`` on ``mesh`` (the active mesh by default); None
    where there is no mesh, or no leaf of the model is split on it (a
    ``model`` axis of one rank, the experts whole)."""
    from repro_torch.sharding import rules as shr

    mesh = shr.active_mesh() if mesh is None else mesh
    if mesh is None:
        return None
    key = (id(cfg), id(mesh))
    hit = _PLANS.get(key)
    if hit is None or hit[0] is not cfg or hit[1] is not mesh:
        plan = _plan(cfg, mesh)
        moe = plan.moe
        split = (plan.size > 1 or bool(plan.fsdp)
                 or (moe is not None and any((moe.experts, moe.mlp, moe.shared))))
        hit = _PLANS[key] = (cfg, mesh, plan if split else None)
    return hit[2]


def local_params(cfg: ModelConfig, params, tp: TensorParallel):
    """This rank's blocks of a parameter-shaped tree (parameters, AdamW
    moments): a tree of DTensors placed as ``tp.shardings`` says or of
    global tensors (``rules.local_tree``), or already this rank's blocks
    (itself)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.params import model_specs
    from repro_torch.sharding import rules as shr

    leaves = tree.leaves(params)
    local = [shr.local_shape(p.shape, sh)
             for p, sh in zip(tree.leaves(model_specs(cfg)), tree.leaves(tp.shardings))]
    if not any(isinstance(x, DTensor) for x in leaves) and all(
            tuple(x.shape) == shape for x, shape in zip(leaves, local)):
        return params
    return shr.local_tree(params, tp.shardings)


def split_axes(cfg: ModelConfig, tp: TensorParallel):
    """Tree matching the parameters: the tuple of mesh axes (above one rank,
    in mesh order) that a leaf's executed spec splits it over, None for a
    replicated leaf (``optim.adamw.global_norm``, the train step's mean)."""
    from repro_torch.sharding import rules as shr

    sizes = shr.mesh_shape(tp.mesh)

    def axes(sh):
        used = {a for part in sh.spec
                for a in (part if isinstance(part, tuple) else (part,)) if a is not None}
        live = tuple(a for a in sizes if a in used and sizes[a] > 1)
        return live or None

    return tree.map_tree(axes, tp.shardings)


def wrap_like(like, local, tp: TensorParallel):
    """``local`` (this rank's blocks) as DTensors placed as ``tp.shardings``
    where ``like`` holds DTensors; as they are otherwise."""
    from torch.distributed.tensor import DTensor

    if not any(isinstance(x, DTensor) for x in tree.leaves(like)):
        return local
    return tree.map_tree(lambda t, sh: DTensor.from_local(t, sh.mesh, sh.placements,
                                                          run_check=False),
                         local, tp.shardings)
