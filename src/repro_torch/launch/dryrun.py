"""Dry run: trace every (arch x shape x mesh) cell's program on fake tensors.

The port of ``src/repro/launch/dryrun.py``. The reference lowers and
compiles each cell through GSPMD on 512 placeholder CPU devices. The port
has no compiler to ask, so it runs its own program -- the train step, a
prefill or a decode step, at full depth and with the cell's microbatches
-- on the fake tensors of a ``FakeTensorMode``: shapes, dtypes and devices,
no storage. No kernel launches: the kernel wrappers' fake path
(``kernels/fake.py``) returns empty outputs and counts the calls, which the
cell reports as ``unit_calls``. A production mesh's 256 or 512 ranks are a
``fake`` process group in this process, rank 0 traced; its collectives are
issued and recorded, and carry nothing.

Per cell (one JSON file, the reference's name and keys where the port has
the quantity):

  * ``roofline.flops``: ``FlopCounterMode`` over the step. It counts
    matrix products and attention, not elementwise work, where XLA's
    ``cost_analysis`` counts both: the two packages' counts are never
    compared. An eager trace runs every layer and microbatch, so the
    reference's affine cost probes (which made up for XLA counting a
    while-loop body once) are not needed.
  * ``memory``: the bytes of the arguments (the state, inputs and cache
    that the traced rank holds: its blocks of the parameters split over
    ``model``, the rest whole), of the outputs, of the outputs that are
    arguments (``alias_bytes``: a decode cache is updated in place), and
    ``temp_bytes``, such that ``total_hbm_bytes`` = arguments + the peak of
    the storages the step allocates live at once.
  * ``collectives``: ``sharding/comm.py``'s record of the step, tallied by
    ``roofline.tally_collectives``: the gradients' mean over the data
    axes, on a ``model`` axis above 1 the tensor-parallel all-reduces
    (``models/parallel.py``), and the MoE FFN's expert exchange
    (all-to-all, all-gather and, in the backward pass, reduce-scatter over
    the axis that holds the experts, ``models/moe.py``); ``by_axis`` splits
    them by the mesh axis they ran over.
  * ``hbm_traffic_model`` (``launch/memmodel.py``) on the layout the
    traced rank holds (``param_layout``: the mesh axes that split some
    leaf, joined by '+', or ``replicated``). The config's ``model``-axis
    rules, its ``experts`` / ``expert_mlp`` rules and its ``embed`` rule
    are the port's own: those leaves are split as the program holds them,
    and the model takes the config as it is (it counts a leaf on ``data``
    as FSDP, gathered before use: so the port runs jamba's ``embed``
    leaves, where its experts stay put and the tokens move). Jamba's cells
    list, on ``data``, one all-gather per FSDP leaf a forward (a block's
    twice under remat, the recompute gathering again) and one
    reduce-scatter per leaf and microbatch.
  * ``sharding_fallbacks`` (``rules.param_fallbacks``, the reference's
    layout) and ``roofline``.

Left out: the HLO's bytes-accessed bound (there is no HLO), the reference's
CPU-upcast tally (see ``launch/roofline.py``) and the cost probes.

A cell whose mesh has ``model > 1``, or whose experts lie on ``data``,
traces the sharded program (``models/parallel.py``) on the traced rank's
blocks: the attention models' split heads, MLP and vocab, the MoE models'
experts, and the Mamba-2 mixer by heads (per Mamba layer and forward one
all-gather of the gated norm's rows and one all-reduce of the output
projection's partial sums over ``model``).
:func:`run_cell` also takes one rank with an explicit ``ShapeConfig``
(``chip_smoke.py``'s roofline phase).

The fake tensors live on ``--device``: ``cuda`` where torch is built with
CUDA, else ``cpu`` (a CPU-only torch cannot index fake CUDA tensors). The
two traces differ in one branch: AdamW takes its square roots in f64 on the
CPU (``optim/adamw.py`` ``sqrt_f32``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch whisper_tiny \\
      --shape decode_32k --mesh multi --variant tp1 --out build/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --variant tp1
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree
from repro_torch.configs import (ARCH_IDS, LM_SHAPES, ModelConfig, ShapeConfig, get_config,
                                 rules_for, shapes_for)
from repro_torch.launch import memmodel
from repro_torch.launch import roofline as rl

__all__ = ["MeshShape", "default_device", "input_specs", "apply_variant",
           "run_cell", "main"]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis sizes, for what reads only sizes (``rules``, ``memmodel``)."""

    shape: Dict[str, int]


def default_device() -> str:
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


# ------------------------------------------------------------- input specs

def input_specs(cfg: ModelConfig, shape: ShapeConfig, *, device,
                fake_mode) -> Dict[str, torch.Tensor]:
    """Fake stand-ins for every model input of this cell, as the
    reference's ``input_specs``."""
    B, S = shape.global_batch, shape.seq_len
    mk = lambda shp, dt: tree.abstract(shp, dt, device, fake_mode)
    specs = {}
    embeds = cfg.embed_inputs and not cfg.is_encoder_decoder
    if shape.kind in ("train", "prefill"):
        if embeds:
            specs["embeds"] = mk((B, S, cfg.d_model), torch.bfloat16)
        else:
            specs["tokens"] = mk((B, S), torch.int32)
        if shape.kind == "train":
            specs["labels"] = mk((B, S), torch.int32)
        if cfg.is_encoder_decoder:
            specs["enc_embeds"] = mk((B, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
    else:  # decode
        specs["tokens"] = mk((B, 1), torch.int32)
    return specs


# ----------------------------------------------------------- memory tally

def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _bytes(tensors, keys=None) -> int:
    """Bytes of the distinct storages of ``tensors`` (those in ``keys`` only,
    when given)."""
    seen = {}
    for t in tensors:
        if isinstance(t, torch.Tensor):
            k = _storage_key(t)
            if keys is None or k in keys:
                seen[k] = t.untyped_storage().nbytes()
    return sum(seen.values())


class _LiveBytes(TorchDispatchMode):
    """The peak bytes of the storages that the traced ops allocate, live at
    once. Each new output storage is counted until it is freed; storages of
    ``arg_keys`` (the arguments, and views of them) are not counted."""

    def __init__(self, arg_keys):
        super().__init__()
        self.arg_keys = set(arg_keys)
        self.seen: set = set()
        self.live = 0
        self.peak = 0

    def _free(self, key: int, n: int) -> None:
        self.live -= n
        self.seen.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.arg_keys or key in self.seen:
                continue
            n = st.nbytes()
            self.seen.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)
        return out


# ------------------------------------------------------------------ meshes

def production_mesh(multi_pod: bool, model: int):
    """The production mesh over a ``fake`` process group of 256 or 512
    ranks in this process (rank 0). Raises when a real group is up."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    from repro_torch.launch.mesh import make_production_mesh

    n = 512 if multi_pod else 256
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run's fake process group cannot replace the "
                               f"initialised {dist.get_backend()!r} group")
        if dist.get_world_size() != n:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return make_production_mesh(multi_pod=multi_pod, model=model, device_type="cpu")


def _local(mesh, batch: Dict[str, torch.Tensor], global_batch: int):
    """This rank's block of each input along the batch axes that divide it."""
    from repro_torch.sharding import rules as shr

    if mesh is None:
        return batch
    axes = shr.batch_partition(mesh, global_batch)
    if not axes:
        return batch
    return {k: shr.batch_local(v, shr.batch_sharding(mesh, axes, v.ndim))
            for k, v in batch.items()}


# --------------------------------------------------------------- cell runner

def _program(cfg: ModelConfig, shape: ShapeConfig, mesh, *, n_micro: int, device,
             fake_mode, tp=None):
    """(args, fn): the cell's abstract arguments and its program, which
    returns the step's outputs. Under ``tp`` (the traced rank's
    tensor-parallel plan) the parameters and the cache are its blocks."""
    from repro_torch.models import abstract_params, forward, make_cache
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules as shr
    from repro_torch.train import step as train_step_lib

    params = abstract_params(cfg, device, fake_mode,
                             shardings=None if tp is None else tp.shardings)
    B = shape.global_batch
    batch = input_specs(cfg, shape, device=device, fake_mode=fake_mode)
    if shape.kind == "train":
        opt_cfg = adamw.AdamWConfig(state_dtype=cfg.opt_state_dtype, division=cfg.division)
        state = train_step_lib.abstract_state(cfg, params, opt_cfg)

        def fn():
            new_state, metrics = train_step_lib.train_step(cfg, opt_cfg, state, batch,
                                                           n_micro=n_micro)
            return new_state, metrics["loss"]
        return (state, batch), fn

    local = _local(mesh, batch, B)
    # The rank's rows are its block of the batch (the MoE FFN's capacity and
    # positions are the global batch's, its experts reached by the exchange).
    rows = lambda: shr.split_tokens(() if mesh is None else shr.batch_partition(mesh, B))
    if shape.kind == "prefill":
        def fn():
            with torch.no_grad(), rows():
                logits, cache, _ = forward(cfg, params, mode="prefill", **local)
            return logits[:, -1], cache
        return (params, batch), fn

    b_local = local["tokens"].shape[0]
    cache = make_cache(cfg, b_local, shape.seq_len, device=device, abstract=True,
                       fake_mode=fake_mode)

    def fn():
        with torch.no_grad(), rows():
            logits, new_cache, _ = forward(cfg, params, tokens=local["tokens"], cache=cache,
                                           pos=shape.seq_len - 1, mode="decode")
        return logits[:, 0], new_cache
    return (params, cache, batch), fn


def _summarize_ops(ops):
    agg = {}
    for o in ops:
        key = o["op"] + ("/dcn" if o["cross_pod"] else "")
        a = agg.setdefault(key, {"count": 0, "wire_bytes": 0.0})
        a["count"] += 1
        a["wire_bytes"] += o["wire_bytes"]
    return agg


def _by_axis(records, ops, mesh) -> Dict:
    """{mesh axis: {op: {count, wire_bytes}}}: each collective under the
    axis whose group of the traced rank it ran over."""
    import torch.distributed as dist

    if mesh is None:
        return {}
    groups = {tuple(dist.get_process_group_ranks(mesh.get_group(ax))): ax
              for ax in mesh.mesh_dim_names}
    agg: Dict = {}
    # tally_collectives keeps the records that carry bytes, in order.
    for rec, o in zip([r for r in records if r["bytes"]], ops):
        ax = groups.get(tuple(rec["ranks"]), "+".join(mesh.mesh_dim_names))
        a = agg.setdefault(ax, {}).setdefault(o["op"], {"count": 0, "wire_bytes": 0.0})
        a["count"] += 1
        a["wire_bytes"] += o["wire_bytes"]
    return agg


def run_cell(arch: str, shape_name: Optional[str] = None, multi_pod: bool = False, *,
             variant: str = "base", one_rank: bool = False,
             shape: Optional[ShapeConfig] = None, cfg: Optional[ModelConfig] = None,
             n_micro: Optional[int] = None, device: Optional[str] = None) -> Dict:
    """Trace one cell and return its record.

    ``shape`` (a ShapeConfig) replaces ``LM_SHAPES[shape_name]``, ``cfg``
    the architecture's config (before ``variant``), ``n_micro`` the
    reference's microbatch count (a data shard's batch over the config's
    ``train_microbatch_size``). ``one_rank``: no mesh, one device (the
    sharding fallbacks are then empty)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import fake
    from repro_torch.models.parallel import tensor_parallel
    from repro_torch.models.params import active_param_count
    from repro_torch.sharding import comm
    from repro_torch.sharding import rules as shr

    cfg, model_axis = apply_variant(cfg or get_config(arch), variant)
    shape = shape or LM_SHAPES[shape_name]
    device = device or default_device()
    if one_rank:
        mesh, sizes, mesh_name = None, MeshShape({}), "one"
    else:
        mesh = production_mesh(multi_pod, model_axis)
        sizes, mesh_name = MeshShape(shr.mesh_shape(mesh)), "multi" if multi_pod else "single"
    tp = None if mesh is None else tensor_parallel(cfg, mesh)
    n_dev = 1
    for v in sizes.shape.values():
        n_dev *= v
    pod_size = n_dev // sizes.shape["pod"] if "pod" in sizes.shape else None
    if n_micro is None:
        n_micro = 1
        if shape.kind == "train":
            n_batch = shr.axes_size(sizes, shr.batch_axes(sizes))
            per_dev_batch = max(1, shape.global_batch // n_batch)
            n_micro = max(1, per_dev_batch // cfg.train_microbatch_size)

    fake_mode = FakeTensorMode()
    with contextlib.ExitStack() as stack:
        if mesh is not None:
            stack.enter_context(shr.use_mesh(mesh))
        args, fn = _program(cfg, shape, mesh, n_micro=n_micro, device=device,
                            fake_mode=fake_mode, tp=tp)
    arg_leaves = tree.leaves(args)
    arg_keys = {_storage_key(t) for t in arg_leaves}
    fake.reset()
    t0 = time.time()
    with contextlib.ExitStack() as stack:
        stack.enter_context(fake_mode)
        if mesh is not None:
            stack.enter_context(shr.use_mesh(mesh))
        records = stack.enter_context(comm.record())
        flops = stack.enter_context(FlopCounterMode(display=False))
        live = stack.enter_context(_LiveBytes(arg_keys))
        outputs = fn()
    t_trace = time.time() - t0
    out_leaves = [t for t in tree.leaves(outputs) if isinstance(t, torch.Tensor)]
    arg_bytes = _bytes(arg_leaves)
    out_bytes = _bytes(out_leaves)
    alias_bytes = _bytes(out_leaves, arg_keys)
    temp_bytes = live.peak - (out_bytes - alias_bytes)

    kind = "train" if shape.kind == "train" else "inference"
    tokens_global = (shape.global_batch * shape.seq_len
                     if shape.kind != "decode" else shape.global_batch)
    model_flops = rl.model_flops_per_device(active_param_count(cfg), tokens_global, n_dev,
                                            kind)
    mm = memmodel.hbm_traffic(cfg, shape, sizes, n_micro=n_micro,
                              fused_attention=cfg.use_flash_kernel)
    colls = rl.tally_collectives(records, n_dev, pod_size)
    roof = rl.Roofline(flops=float(flops.get_total_flops()), bytes_accessed=mm["total_bytes"],
                       ici_bytes=colls["ici_bytes"], dcn_bytes=colls["dcn_bytes"],
                       model_flops=model_flops)
    return {
        "arch": arch, "shape": shape.name, "mesh": mesh_name, "variant": variant,
        "devices": n_dev, "n_micro": n_micro, "device": device,
        "param_layout": _layout(cfg, tp),
        "sharding_fallbacks": [] if one_rank else shr.param_fallbacks(cfg, sizes),
        "trace_s": t_trace,
        "memory": {
            "argument_bytes": arg_bytes, "output_bytes": out_bytes,
            "temp_bytes": temp_bytes, "alias_bytes": alias_bytes,
            "total_hbm_bytes": arg_bytes + out_bytes + temp_bytes - alias_bytes,
        },
        "hbm_traffic_model": mm,
        "collectives": {"ici_bytes": colls["ici_bytes"], "dcn_bytes": colls["dcn_bytes"],
                        "n_ops": len(colls["ops"]), "by_op": _summarize_ops(colls["ops"]),
                        "by_axis": _by_axis(records, colls["ops"], mesh)},
        "unit_calls": dict(fake.CALLS),
        "roofline": roof.to_dict(),
    }


def _layout(cfg: ModelConfig, tp) -> str:
    """The mesh axes that split some leaf on the traced rank, '+'-joined in
    mesh order; ``replicated`` for none."""
    from repro_torch.models.parallel import split_axes

    if tp is None:
        return "replicated"
    used = {a for axes in tree.leaves_at(split_axes(cfg, tp), tp.shardings) if axes
            for a in axes}
    return "+".join(a for a in tp.mesh.mesh_dim_names if a in used) or "replicated"


# ------------------------------------------------------------ perf variants

def apply_variant(cfg: ModelConfig, variant: str):
    """The reference's named variants that the port executes, and
    ``kernels`` (the config's Taylor or Goldschmidt division through the
    fused kernels, as the port runs it on the card); compound ones combine
    with '+' (e.g. ``tp1+kernels``). Returns (cfg, model_axis_size).

    Left out: ``seq_shard`` and ``kvseq``, which place activations and
    the KV cache's sequence on the ``model`` axis (ROADMAP Queue 1 item
    24)."""
    from repro_torch.core.division_modes import DivisionConfig

    rep = dataclasses.replace
    model_axis = 16
    for v in variant.split("+"):
        if v == "base":
            continue
        elif v == "exact_div":      # paper-baseline comparison: exact divides
            cfg = rep(cfg, division=DivisionConfig(mode="exact"))
        elif v == "div_paper_n5":   # paper-faithful: n=5, 53-bit, the paper's schedule
            cfg = rep(cfg, division=DivisionConfig(
                mode="taylor", n_iters=5, precision_bits=53, schedule="paper"))
        elif v == "no_remat":
            cfg = rep(cfg, remat=False)
        elif v == "micro2x":
            cfg = rep(cfg, train_microbatch_size=max(1, cfg.train_microbatch_size * 2))
        elif v == "micro_half":
            cfg = rep(cfg, train_microbatch_size=max(1, cfg.train_microbatch_size // 2))
        elif v == "flash":          # fused flash-attention kernel (memmodel)
            cfg = rep(cfg, use_flash_kernel=True)
        elif v == "ep_tp":          # MoE: experts local, expert-FF over model
            cfg = rep(cfg, sharding_rules={**cfg.sharding_rules, "experts": None,
                                           "expert_mlp": "model"})
        elif v == "ep_model":       # MoE: experts over the model axis
            cfg = rep(cfg, sharding_rules={**cfg.sharding_rules, "experts": "model",
                                           "expert_mlp": None})
        elif v == "sort_dispatch":  # megablocks-style MoE position assignment
            cfg = rep(cfg, moe_dispatch="sort")
        elif v == "local_dispatch":  # shard-local dispatch
            cfg = rep(cfg, moe_dispatch="local")
        elif v == "optbf16":        # bf16 optimizer moments
            cfg = rep(cfg, opt_state_dtype="bfloat16")
        elif v == "kernels":        # the port's: the config's division in the fused kernels
            mode = {"taylor": "taylor_pallas", "goldschmidt": "goldschmidt_pallas"}.get(
                cfg.division.mode, cfg.division.mode)
            cfg = rep(cfg, division=dataclasses.replace(cfg.division, mode=mode))
        elif v.startswith("tp"):    # tensor-parallel degree (data = 256/tp)
            model_axis = int(v[2:])
        elif v.startswith("chunk"):
            cfg = rep(cfg, attn_chunk=int(v[5:]))
        elif v.startswith("mb"):    # absolute microbatch size
            cfg = rep(cfg, train_microbatch_size=int(v[2:]))
        else:
            raise ValueError(f"unknown variant {v}")
    return cfg, model_axis


# --------------------------------------------------------------------- main

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--variant", default="base")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--device", default=None,
                    help="the fake tensors' device (default: cuda where torch has CUDA)")
    args = ap.parse_args(argv)
    if not args.all and not args.arch:
        ap.error("give --arch or --all")

    os.makedirs(args.out, exist_ok=True)
    cells = []
    archs = [a for a in ARCH_IDS if a != "paper_fpdiv"] if args.all else [args.arch]
    for arch in archs:
        shps = ([s.name for s in shapes_for(get_config(arch))]
                if (args.all or not args.shape) else [args.shape])
        meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
        cells += [(arch, s, m) for s in shps for m in meshes]

    failures = 0
    for arch, s, m in cells:
        tag = f"{arch}_{s}_{m}" + (f"_{args.variant}" if args.variant != "base" else "")
        try:
            res = run_cell(arch, s, m == "multi", variant=args.variant, device=args.device)
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(res, f, indent=1)
            r = res["roofline"]
            print(f"[ok] {tag}: bound={r['bound']} "
                  f"t=(c {r['t_compute']:.4f}, m {r['t_memory']:.4f}, "
                  f"x {r['t_collective']:.4f})s mfu={r['mfu']:.3f} "
                  f"trace={res['trace_s']:.1f}s", flush=True)
        except Exception as e:
            failures += 1
            print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
