"""FSDP over ``data`` for jamba's ``embed`` rule, and the int8 cross-pod mean
over split leaves, on 4 gloo ranks, held against the same mesh with
``embed`` whole and against the reference.

One module-scoped fixture runs ``_torch_mesh.fsdp_rank`` on 4 CPU ranks
once (``launch.mesh.run_ranks``, one torch thread each); meanwhile two
4-device XLA subprocesses run the reference: its GSPMD ``train_step`` of
jamba's smoke config under jamba's rules on (data 2, model 2), two steps;
and its ``psum_compressed`` on (pod 2, model 2) blocks in a ``shard_map``; and
its ``train_step(compress_axis="pod")`` of llama3_8b's smoke config on
(pod 2, model 2) and of jamba's on (pod 2, data 2) with the mean on the
leaves' blocks: the step's own three parts -- ``grads_fn`` of each pod's
half of the batch (a ``shard_map`` over the mesh, the parameters whole),
``psum_compressed`` in a ``shard_map`` whose in_specs are the leaves'
specs (the body holds each device's block, as ``tests/test_sharding.py``
runs it on ``P("pod", "data")`` blocks), and ``adamw.update``. A
``shard_map`` of the whole step would hand the model its blocks, which it
does not run on.

Every case in f32 with the division unit in ``taylor_pallas``. Jamba's
smoke config carries the full config's ``sharding_rules``: ``embed``,
``experts`` on data, ``expert_mlp``, heads, ``mlp``, vocab and the Mamba-2
heads on model. Bounds: the gathered forward, and the step at one
microbatch, are the ``embed: None`` run's bits (a gather is a copy; two
ranks' reduce-scatter sums a + b as their all-reduce does); the two GSPMD
steps are held to ``test_torch_ssm_parallel.py``'s step bounds (the
Mamba-2 leaves' sum-order floor, documented there) with the 2 lr of a
lane whose sign the first moment does not resolve taken once a step; the
compressed steps as ``test_torch_sharded_paths.py`` holds the unsplit one,
each lane's int8 step s being its block's.
"""
import dataclasses
import os
import subprocess
import sys
import zlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.core.division_modes import DivisionConfig as RefDivisionConfig
from repro.train import checkpoint as ref_checkpoint
from repro_torch import convert, tree
from repro_torch.configs import get_smoke_config
from repro_torch.core.division_modes import DivisionConfig
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import init_params
from repro_torch.models.params import model_specs
from repro_torch.optim import adamw, compress
from repro_torch.serving import ServingEngine
from repro_torch.sharding import rules as shr
from repro_torch.train import checkpoint, step
import _torch_mesh
from _ref_params import ref_init
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

N_RANKS = 4
DEADLINE_S = 300.0
MODE = "taylor_pallas"
PROMPT, N_DECODE = 32, 2
GEN_LENS, GEN_NEW = (13, 7), 5
# The MoE FFN drops no token at these capacity factors: serve() admits
# prompts alone, and the compressed reference routes each pod's half.
NO_DROP_CF = 8.0
TRAIN_BATCH, TRAIN_SEQ, N_MICRO, N_STEPS = 8, 32, 2, 2
CLIP_SHARE = 0.5
STATE_RTOL = 2e-4
UNCLIPPED = 1e9
FLIP_LANES = 16
# (pod 2, model 2): each pod's tensor and its spec over model.
COMPRESS = {"a": ((4, 64), (None, "model")), "b": ((6, 5), ("model", None))}
COMPRESSED = {"dense": ("llama3_8b", "pod_model"), "jamba": ("jamba_1_5_large", "pod_data")}
# Per compressed case: the share of s above which an error lane counts as
# off, and the lanes a rank may have off. The dense model's as
# test_torch_sharded_paths.py's; jamba's gradients differ between the
# packages by up to 1.1e-5 of a leaf's largest value (the Mamba-2 leaves'
# sum order), so its scale s, a max, differs by that share, an error lane
# of q steps by up to 127 x 1.1e-5 s (1.4e-3 s), and a lane whose g'/s
# lies within 1.4e-3 of a rounding boundary may round the other way: 23 and
# 71 lanes of a rank's 323636 measured (error tree, m).
OFF = {"dense": (1e-3, FLIP_LANES), "jamba": (1e-2, 160)}
MESHES = {"data_model": ("data", "model"), "pod_model": ("pod", "model"),
          "pod_data": ("pod", "data")}
# Leaf names that jamba's rules put on data besides the experts.
FSDP_NAMES = {"mixer_norm", "ffn_norm", "final_norm", "embed", "lm_head", "router", "wq",
              "wk", "wv", "wo", "wi", "wg", "wz", "wx", "wB", "wC", "wdt", "wout"}


class _Sizes:
    """A stand-in mesh: its axes' sizes only."""

    def __init__(self, mesh_name):
        self.shape = dict.fromkeys(MESHES[mesh_name], 2)


def _pair(arch, **kw):
    """The reference's and the port's smoke configs of ``arch`` in f32, with
    the full config's sharding rules."""
    div = dict(mode=MODE, schedule="paper")
    rules = ref_get_config(arch).sharding_rules
    ref = dataclasses.replace(ref_smoke_config(arch), param_dtype="float32",
                              division=RefDivisionConfig(**div), sharding_rules=rules, **kw)
    port = dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                               division=DivisionConfig(**div), sharding_rules=rules, **kw)
    return ref, port


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _whole(cfg):
    """``cfg`` with jamba's embed rule dropped: every leaf's embed dim whole."""
    return dataclasses.replace(cfg, sharding_rules={**cfg.sharding_rules, "embed": None})


def _batch(seed):
    tokens = np.random.default_rng(seed).integers(0, 256, (TRAIN_BATCH, TRAIN_SEQ + 1))
    return tokens, {"tokens": torch.from_numpy(tokens[:, :-1]).int(),
                    "labels": torch.from_numpy(tokens[:, 1:]).int()}


def _inputs(tmp):
    rc, pc = _pair("jamba_1_5_large")
    rp = ref_init(rc)
    pp = convert.params_from_reference(_np(rp), pc, "cpu")
    rng = np.random.default_rng(zlib.crc32(b"fsdp"))
    toks = rng.integers(0, pc.vocab, (2, PROMPT + N_DECODE))
    fwd = lambda cfg: {"cfg": cfg, "params": pp, "prompt_len": PROMPT,
                       "kw": {"tokens": torch.from_numpy(toks[:, :PROMPT])},
                       "decode": [torch.from_numpy(toks[:, PROMPT + t:PROMPT + t + 1])
                                  for t in range(N_DECODE)]}
    gen_cfg = dataclasses.replace(pc, capacity_factor=NO_DROP_CF)
    gen = {"cfg": gen_cfg, "params": pp, "hand": {}, "max_new": GEN_NEW, "serve": True,
           "prompts": [rng.integers(1, pc.vocab, n).tolist() for n in GEN_LENS]}
    tokens, batch = _batch(5)
    _, _, grads = step.grads_fn(pc, pp, batch, N_MICRO)
    opt_cfg = adamw.AdamWConfig(division=pc.division,
                                grad_clip=CLIP_SHARE * float(adamw.global_norm(grads)))
    crng = np.random.default_rng(7)
    g = {n: crng.normal(size=(2,) + shape).astype(np.float32) * (1e-3 if n == "b" else 1)
         for n, (shape, _) in COMPRESS.items()}
    e = {n: crng.normal(size=(2,) + shape).astype(np.float32) * 0.01
         for n, (shape, _) in COMPRESS.items()}
    compressed = {}
    for name, (arch, mesh_name) in COMPRESSED.items():
        kw = {"capacity_factor": NO_DROP_CF} if arch == "jamba_1_5_large" else {}
        crc, cpc = _pair(arch, **kw)
        crp = ref_init(crc)
        compressed[name] = {"cfg": cpc, "params": convert.params_from_reference(_np(crp), cpc,
                                                                               "cpu"),
                            "batch": batch, "opt_cfg": adamw.AdamWConfig(division=cpc.division),
                            "mesh": mesh_name, "rc": crc, "rp": crp}
    inp = {"forward": {"fsdp": fwd(pc), "whole": fwd(_whole(pc))}, "generate": gen,
           "grads": {"cfg": pc, "cfg0": _whole(pc), "params": pp, "batch": batch,
                     "opt_cfg": adamw.AdamWConfig(division=pc.division, grad_clip=UNCLIPPED)},
           "remat": {"cfg": dataclasses.replace(pc, remat=True),
                     "cfg_plain": dataclasses.replace(pc, remat=False), "params": pp,
                     "batch": batch},
           "train": {"cfg": pc, "params": pp, "batch": batch, "opt_cfg": opt_cfg,
                     "n_micro": N_MICRO, "n_steps": N_STEPS, "ckpt_dir": str(tmp)},
           "compress": {"g": {n: torch.from_numpy(a) for n, a in g.items()},
                        "err": {n: torch.from_numpy(a) for n, a in e.items()},
                        "specs": {n: spec for n, (_, spec) in COMPRESS.items()}},
           "compressed": {n: {k: v for k, v in c.items() if k not in ("rc", "rp")}
                          for n, c in compressed.items()},
           "draws": {"seed": 3, "reference": _np(rp)}}
    return inp, {"rc": rc, "rp": rp, "pc": pc, "pp": pp, "tokens": tokens, "g": g, "e": e,
                 "compressed": compressed}


XLA_REF = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.configs import get_config, get_smoke_config
from repro.core.division_modes import DivisionConfig
from repro.launch.mesh import _axis_type_kwargs
from repro.models import init_params
from repro.optim import adamw, compress
from repro.sharding import rules
from repro.train import step

d = np.load(sys.argv[1])
out = {}
tm = jax.tree_util.tree_map


def config(arch, **kw):
    return dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                               division=DivisionConfig(mode="taylor_pallas", schedule="paper"),
                               sharding_rules=get_config(arch).sharding_rules, **kw)


def params_of(cfg, prefix):
    like = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(like), [
        jnp.asarray(d[f"{prefix}_param_{i}"])
        for i in range(len(jax.tree_util.tree_leaves(like)))])


def save(prefix, t):
    for i, leaf in enumerate(jax.tree_util.tree_leaves(t)):
        out[f"{prefix}_{i}"] = np.asarray(leaf)


tokens = jnp.asarray(d["tokens"], jnp.int32)
part = sys.argv[3]

# Two GSPMD steps of jamba under its rules on (data 2, model 2).
cfg = config("jamba_1_5_large")
opt_cfg = adamw.AdamWConfig(division=cfg.division, grad_clip=float(d["clip"]))
mesh = jax.make_mesh((2, 2), ("data", "model"), **_axis_type_kwargs(2))
if part == "gspmd":
    state = step.init_state(cfg, jax.device_put(params_of(cfg, "jamba"),
                                                rules.param_shardings(cfg, mesh)), opt_cfg)
    batch = jax.device_put({"tokens": tokens[:, :-1], "labels": tokens[:, 1:]},
                           rules.data_sharding(mesh, 2))
    with rules.use_mesh(mesh), jax.set_mesh(mesh):
        fn = jax.jit(lambda s, b: step.train_step(cfg, opt_cfg, s, b, n_micro=2))
        for k in range(int(d["n_steps"])):
            state, metrics = fn(state, batch)
            out[f"gspmd_loss_{k}"] = np.float32(metrics["loss"])
            save(f"gspmd_m{k}", state.opt.m)
    for what, t in (("params", state.params), ("m", state.opt.m), ("v", state.opt.v)):
        save(f"gspmd_{what}", t)
    np.savez(sys.argv[2], **out)
    sys.exit(0)

# psum_compressed on (pod 2, model 2) blocks.
mesh = jax.make_mesh((2, 2), ("pod", "model"), **_axis_type_kwargs(2))
specs = {"a": P("pod", None, "model"), "b": P("pod", "model", None)}
g = {n: jnp.asarray(d["g_" + n]) for n in specs}
e = {n: jnp.asarray(d["e_" + n]) for n in specs}
first = lambda t: tm(lambda x: x[0], t)
lead = lambda t: tm(lambda x: x[None], t)
f = shard_map(lambda gg, ee: tuple(map(lead, compress.psum_compressed(first(gg), first(ee),
                                                                      "pod"))),
              mesh=mesh, in_specs=(specs, specs), out_specs=(specs, specs), check_rep=False)
mean, err = jax.jit(f)(g, e)
for n in specs:
    out["mean_" + n], out["err_" + n] = np.asarray(mean[n]), np.asarray(err[n])

# train_step(compress_axis="pod") with the mean on the leaves' blocks: each
# pod's gradient of its half of the batch, the reference's psum_compressed
# on the blocks that the leaves' specs give each device, then AdamW.
for name, arch, axes in (("dense", "llama3_8b", ("pod", "model")),
                         ("jamba", "jamba_1_5_large", ("pod", "data"))):
    cfg = config(arch, **({"capacity_factor": 8.0} if arch == "jamba_1_5_large" else {}))
    opt_cfg = adamw.AdamWConfig(division=cfg.division)
    mesh = jax.make_mesh((2, 2), axes, **_axis_type_kwargs(2))
    state = step.init_state(cfg, params_of(cfg, name), opt_cfg)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    grads = jax.jit(shard_map(lambda st, b: lead(step.grads_fn(cfg, st.params, b, 1)[2]),
                              mesh=mesh, in_specs=(P(), P("pod")), out_specs=P("pod"),
                              check_rep=False))(state, batch)
    blocks = tm(lambda sh: P("pod", *sh.spec), rules.param_shardings(cfg, mesh),
                is_leaf=lambda x: hasattr(x, "spec"))
    mean, err = jax.jit(shard_map(
        lambda gg, ee: tuple(map(lead, compress.psum_compressed(first(gg), first(ee), "pod"))),
        mesh=mesh, in_specs=(blocks, blocks), out_specs=(blocks, blocks),
        check_rep=False))(grads, tm(jnp.zeros_like, grads))
    new_params, new_opt = jax.jit(lambda g_, o, p: adamw.update(g_, o, p, opt_cfg))(
        first(mean), state.opt, state.params)
    for what, t in (("grad", grads), ("params", new_params), ("m", new_opt.m),
                    ("v", new_opt.v), ("err", err)):
        save(f"{name}_{what}", t)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("fsdp_ckpt")
    inp, ref = _inputs(ckpt)
    d = tmp_path_factory.mktemp("xla_fsdp")
    arrays = {"tokens": ref["tokens"], "clip": np.float64(inp["train"]["opt_cfg"].grad_clip),
              "n_steps": N_STEPS,
              **{f"g_{n}": a for n, a in ref["g"].items()},
              **{f"e_{n}": a for n, a in ref["e"].items()},
              **{f"jamba_param_{i}": np.asarray(a, np.float32)
                 for i, a in enumerate(jax.tree_util.tree_leaves(ref["rp"]))}}
    arrays.update({f"dense_param_{i}": np.asarray(a, np.float32) for i, a in enumerate(
        jax.tree_util.tree_leaves(ref["compressed"]["dense"]["rp"]))})
    np.savez(d / "in.npz", **arrays)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # The two parts of the reference run side by side (the GSPMD steps
    # compile for most of a minute).
    xla = {part: subprocess.Popen([sys.executable, "-c", XLA_REF, str(d / "in.npz"),
                                   str(d / f"{part}.npz"), part], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True, cwd=root,
                                  env={**os.environ, "PYTHONPATH": "src"})
           for part in ("gspmd", "compress")}
    try:
        ranks = run_ranks(_torch_mesh.fsdp_rank, N_RANKS, inp, device_type="cpu",
                          timeout_s=DEADLINE_S)
        stderr = {part: x.communicate(timeout=DEADLINE_S)[1] for part, x in xla.items()}
    finally:
        for x in xla.values():
            if x.poll() is None:
                x.kill()
    for part, x in xla.items():
        assert x.returncode == 0, stderr[part][-3000:]
    return {"inp": inp, "ref": ref, "ranks": ranks, "ckpt": str(ckpt),
            "xla": {k: v for part in xla for k, v in np.load(d / f"{part}.npz").items()}}


# ----------------------------------------------------------------- helpers

def _specs(cfg, mesh_name):
    return [sh.spec for sh in tree.leaves(shr.param_shardings(cfg, _Sizes(mesh_name)))]


def _glue(specs, mesh_name, leaves_of_ranks, coords, fixed=None):
    """Each leaf's global tensor from the ranks' blocks, placed by their mesh
    coordinates on the leaf's split dims (``fixed``: coordinates to take
    the blocks from on the axes the leaf is not split over)."""
    axes = MESHES[mesh_name]
    out = []
    for i, spec in enumerate(specs):
        parts = {tuple(c[a] for a in axes): leaves[i]
                 for leaves, c in zip(leaves_of_ranks, coords)}

        def build(dim, at):
            if dim == len(spec):
                return parts[tuple(at.get(a, 0) for a in axes)]
            ax = spec[dim]
            if ax is None:
                return build(dim + 1, at)
            return torch.cat([build(dim + 1, {**at, ax: j}) for j in range(2)], dim)

        out.append(build(0, dict(fixed or {})))
    return out


def _cut(t, spec, coord):
    """The block of ``t`` at mesh coordinate ``coord`` under ``spec``."""
    for dim, ax in enumerate(spec):
        if ax is not None:
            n = t.shape[dim] // 2
            t = t.narrow(dim, coord[ax] * n, n)
    return t


def _port(xla, prefix, cfg, rp, lead=None):
    """The reference's leaves ``prefix``_i in the port's layout and order
    (``lead``: the index to take on a leading axis first)."""
    like = jax.tree_util.tree_structure(rp)
    leaves = [xla[f"{prefix}_{i}"] for i in range(like.num_leaves)]
    if lead is not None:
        leaves = [a[lead] for a in leaves]
    return tree.leaves(convert.params_from_reference(jax.tree_util.tree_unflatten(like, leaves),
                                                     cfg, "cpu"))


def _bits(x):
    return x.contiguous().view(torch.int32)


def _within(got, want, rtol):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        assert float((g - w).abs().max()) <= rtol * float(w.abs().max()), i


def _params_within(got, want, ms, lr):
    """The parameters within 1e-4 of each leaf's largest value where the
    first moment of every step (``ms``, a list of leaf lists) resolves the
    gradient's sign (above STATE_RTOL of its largest), within 2 lr a step
    elsewhere: a lane whose first gradient lies in the sum-order noise
    moves by up to +-lr at that step, whatever the later steps do."""
    n_steps = len(ms)
    for i, (g, w) in enumerate(zip(got, want)):
        d = (g - w).abs()
        sure = torch.stack([m[i].abs() > STATE_RTOL * float(m[i].abs().max())
                            for m in ms]).all(0)
        assert float(torch.where(sure, d, 0).max()) <= 1e-4 * float(w.abs().max()), i
        assert float(d.max()) <= 2 * lr * n_steps + 1e-4 * float(w.abs().max()), i


# ------------------------------------------------------------------ layout

def test_each_fsdp_leaf_is_stored_as_its_data_model_block(run):
    """Under jamba's rules on (data 2, model 2) every leaf with an embed dim
    -- attention, dense MLP and Mamba projections, block and final norms,
    embed, lm_head, the router -- lies on data, stored as the block its
    spec implies; an expert leaf's embed dim stays whole (data holds its
    experts); the plan gathers embed on dim 1, the final norm and lm_head
    on dim 0."""
    cfg = run["inp"]["forward"]["fsdp"]["cfg"]
    specs = tree.leaves(model_specs(cfg))
    paths = tree.paths(model_specs(cfg))
    for out in run["ranks"]:
        st = out["stored"]
        on_data = set()
        for path, p, spec, shape in zip(paths, specs, st["specs"], st["shapes"]):
            assert shape == shr.local_shape(p.shape, shr.NamedSharding(_Sizes("data_model"),
                                                                       spec)), path
            if p.expert:
                assert spec[0] == "data" and spec[p.axes.index("embed")] is None, path
            elif "data" in spec:
                assert spec[p.axes.index("embed")] == "data", path
                on_data.add(path)
        with_embed = {path for path, p in zip(paths, specs) if "embed" in p.axes and not p.expert}
        assert on_data == with_embed
        assert {path.rsplit("/", 1)[-1] for path in on_data} == FSDP_NAMES
        assert st["fsdp"] == {"embed": (("data", 1),), "final_norm": (("data", 0),),
                              "lm_head": (("data", 0),)}


def test_a_rank_draws_and_converts_only_its_fsdp_blocks(run):
    """init_params(shardings=) and params_from_reference(shardings=) under
    jamba's rules on (data 2, model 2) keep each rank's blocks, the FSDP
    leaves' data blocks included: put together, the ranks' blocks are the
    whole tree this process draws and converts."""
    cfg = run["inp"]["forward"]["fsdp"]["cfg"]
    want = {"init": tree.leaves(init_params(cfg, torch.Generator().manual_seed(3))),
            "convert": tree.leaves(convert.params_from_reference(_np(run["ref"]["rp"]), cfg,
                                                                 "cpu"))}
    ranks = run["ranks"]
    for what, whole in want.items():
        got = _glue(_specs(cfg, "data_model"), "data_model",
                    [r["draws"][what] for r in ranks], [r["coord"] for r in ranks])
        assert all(torch.equal(a, b) for a, b in zip(got, whole))
    assert sum(a.shape != b.shape for a, b in zip(ranks[0]["draws"]["init"], want["init"])) > 40


# ----------------------------------------------------------------- forward

@pytest.mark.parametrize("what", ["train", "prefill", "decode"])
def test_gathered_forward_is_the_whole_embed_runs_bits(run, what):
    """Train and prefill logits and two decode steps from the prefill's
    cache on (data 2, model 2): the FSDP blocks gathered before use give
    the bits of the same mesh holding embed whole."""
    for out in run["ranks"]:
        got, want = out["forward"]["fsdp"][what], out["forward"]["whole"][what]
        if what == "decode":
            assert len(got) == N_DECODE
            assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))
        else:
            assert torch.equal(_bits(got), _bits(want))


@pytest.fixture(scope="module")
def unsharded_tokens(run):
    g = run["inp"]["generate"]
    return ServingEngine(g["cfg"], g["params"], max_len=64).generate_batch(g["prompts"],
                                                                           g["max_new"])


@pytest.mark.parametrize("how", ["batch", "serve"])
def test_greedy_tokens_are_the_unsharded_engines(run, unsharded_tokens, how):
    """generate_batch and serve() (continuous batching, 2 slots) under FSDP
    on (data 2, model 2), at a capacity factor that drops no token: the
    unsharded engine's greedy tokens on every rank."""
    for out in run["ranks"]:
        assert out["generate"][how] == unsharded_tokens


# -------------------------------------------------------------- gradients

@pytest.mark.parametrize("what", ["m", "v", "params"])
def test_one_microbatch_step_is_the_whole_embed_steps_bits(run, what):
    """One step at one microbatch, unclipped (so m = (1 - b1) g): each
    FSDP leaf's gradient comes back reduce-scattered, and its block of m,
    v and the parameters is the embed-whole run's all-reduced one's block,
    bit for bit, on every rank."""
    cfg = run["inp"]["grads"]["cfg"]
    specs = _specs(cfg, "data_model")
    n_data = 0
    for out in run["ranks"]:
        f, w = out["one_micro"]["fsdp"], out["one_micro"]["whole"]
        assert f["losses"] == w["losses"]
        for spec, a, b in zip(specs, f[what], w[what]):
            if a.shape != b.shape:          # an FSDP leaf: the whole run's block, cut over data
                n_data += 1
                b = _cut(b, tuple(s if s == "data" else None for s in spec), out["coord"])
            assert torch.equal(_bits(a), _bits(b))
    assert n_data > 0


def _data_ops(out, name, op):
    return sum(1 for o, ranks in out["ops"][name] if o == op and ranks == out["data_group"])


def test_remat_gathers_each_blocks_leaves_twice(run):
    """One train forward and backward on (data 2, model 2): with remat every
    all-gather on data inside the blocks runs again in the recompute, so
    their count is exactly twice the count without remat (embed, the final
    norm and lm_head are gathered once either way), and each gather has
    one reduce-scatter of its gradient, with or without remat: one per FSDP
    leaf and one per MoE layer (the expert outputs' gather; the MoE FFN's
    all-gather of its routing counts has no gradient)."""
    n_top = 3
    cfg = run["inp"]["remat"]["cfg"]
    n_fsdp = sum("data" in spec and not p.expert
                 for spec, p in zip(_specs(cfg, "data_model"), tree.leaves(model_specs(cfg))))
    n_moe = sum(s.ffn == "moe" for s in cfg.layer_specs())
    for out in run["ranks"]:
        plain = _data_ops(out, "plain", "all-gather")
        remat = _data_ops(out, "remat", "all-gather")
        assert plain == n_fsdp + 2 * n_moe and remat - n_top == 2 * (plain - n_top)
        assert _data_ops(out, "plain", "reduce-scatter") == n_fsdp + n_moe
        assert _data_ops(out, "remat", "reduce-scatter") == n_fsdp + n_moe


# ---------------------------------------------------------------- training

def _assembled(run, what):
    cfg = run["inp"]["train"]["cfg"]
    ranks = [r["train"] for r in run["ranks"]]
    return _glue(_specs(cfg, "data_model"), "data_model", [o[what] for o in ranks],
                 [o["coord"] for o in ranks])


@pytest.mark.parametrize("what", ["loss", "params", "m", "v"])
def test_two_steps_are_the_references_gspmd_steps(run, what):
    """Two steps under FSDP on (data 2, model 2) (DTensor state, 2
    microbatches, gradients clipped at half their norm) against the
    reference's two GSPMD steps under jamba's rules on the same mesh: each
    loss within 1e-5, m and v within STATE_RTOL of each leaf's largest
    value, the parameters within 1e-4 of it where each step's m resolves
    the sign and within 2 lr a step elsewhere."""
    xla = run["xla"]
    if what == "loss":
        for out in run["ranks"]:
            for k, loss in enumerate(out["train"]["losses"]):
                assert abs(loss - float(xla[f"gspmd_loss_{k}"])) <= 1e-5
        return
    cfg, rp = run["ref"]["pc"], run["ref"]["rp"]
    want = {w: _port(xla, f"gspmd_{w}", cfg, rp) for w in ("params", "m", "v")}
    got = _assembled(run, what)
    if what == "params":
        _params_within(got, want["params"], [_port(xla, f"gspmd_m{k}", cfg, rp)
                                             for k in range(N_STEPS)],
                       run["inp"]["train"]["opt_cfg"].lr)
    else:
        _within(got, want[what], STATE_RTOL)


def test_each_block_is_bit_equal_on_the_ranks_that_hold_it(run):
    """After the two steps each leaf has the same bits on every rank that
    holds the same block of it (a leaf split over data and model on one
    rank each, one split over model on its data peers, a replicated one on
    all 4); the state stays DTensors."""
    cfg = run["inp"]["train"]["cfg"]
    ranks = [r["train"] for r in run["ranks"]]
    n_fsdp = 0
    for what in ("params", "m", "v"):
        for i, spec in enumerate(_specs(cfg, "data_model")):
            axes = sorted({a for a in spec if a is not None})
            n_fsdp += "data" in axes
            groups = {}
            for o in ranks:
                groups.setdefault(tuple(o["coord"][a] for a in axes), []).append(
                    _bits(o[what][i]))
            for same in groups.values():
                assert all(torch.equal(x, same[0]) for x in same), (what, i)
    assert n_fsdp > 0 and all(o["dtensors"] for o in ranks)


def test_an_fsdp_checkpoint_holds_the_global_values(run):
    """The FSDP state after two steps, saved by every rank: the port's
    restore and the reference's give the ranks' blocks put together, bit
    for bit."""
    t = run["inp"]["train"]
    like = step.init_state(t["cfg"], t["params"], t["opt_cfg"])
    got = checkpoint.restore(run["ckpt"], N_STEPS, like)
    for w, g in (("params", got.params), ("m", got.opt.m), ("v", got.opt.v)):
        assert all(torch.equal(a, b) for a, b in zip(tree.leaves(g), _assembled(run, w)))
    theirs = ref_checkpoint.restore(run["ckpt"], N_STEPS, _np(tree.map_tree(
        lambda x: x.numpy(), like)))
    for a, b in zip(jax.tree_util.tree_leaves(theirs), tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(a).reshape(b.shape), b.numpy())


# ------------------------------------------------- the int8 mean on blocks

@pytest.mark.parametrize("what", ["mean", "err"])
def test_psum_compressed_on_split_blocks_is_the_references_bit_for_bit(run, what):
    """On (pod 2, model 2), each rank's int8 mean over pod of its model
    block (the max over the block, shared over pod) and its new error,
    against the reference's psum_compressed on the same blocks in a
    shard_map, bit for bit."""
    xla = run["xla"]
    for out in run["ranks"]:
        c = out["compress"]
        coord = c["coord"]
        for n, (_, spec) in COMPRESS.items():
            want = _cut(torch.from_numpy(xla[f"{what}_{n}"][coord["pod"]]), spec, coord)
            assert torch.equal(_bits(c[what][n]), _bits(want))


def _int8_steps(run, name, coord):
    """Each leaf's int8 step s = max|g'| / 127 on the rank at ``coord``: g'
    the pods' gradients (the error tree starts at 0) from the reference,
    the max over the rank's block of the leaf's stack on both pods."""
    c = run["ref"]["compressed"][name]
    cfg, mesh_name = c["cfg"], c["mesh"]
    specs = _specs(cfg, mesh_name)
    pods = [_port(run["xla"], f"{name}_grad", cfg, c["rp"], lead=p) for p in range(2)]
    tops = [max(float(_cut(a, s, coord).abs().max()), float(_cut(b, s, coord).abs().max()))
            for a, b, s in zip(*pods, specs)]
    steps = [0.0] * len(tops)
    for group in compress.stacks(model_specs(cfg), [len(g.period) for g in cfg.groups()]):
        for i in group:
            steps[i] = max(tops[j] for j in group) / 127.0
    return steps


@pytest.mark.parametrize("what", ["params", "m", "v", "err"])
@pytest.mark.parametrize("name", list(COMPRESSED))
def test_compressed_step_over_split_leaves_is_the_references(run, name, what):
    """Each rank's new blocks of the parameters, moments and error tree
    after train_step(compress_axis="pod") -- llama3_8b's smoke config on
    (pod 2, model 2), its heads, MLP and vocab split over model; jamba's on
    (pod 2, data 2), its FSDP leaves and experts split over data -- against
    the reference's step with the mean on the same blocks, in f32. The
    gradients of the two packages differ by f32 rounding, so an int8
    rounding tie may go the other way: at most ``OFF``'s lanes may differ
    by more than 1e-4 of the leaf's largest value (``OFF``'s share of s in
    the error tree), no error lane by more than one int8 step s and no
    first-moment lane by more than (1 - b1) s, s being the block's."""
    err_eps, flips = OFF[name]
    c = run["ref"]["compressed"][name]
    cfg, mesh_name = c["cfg"], c["mesh"]
    b1 = c["opt_cfg"].b1
    specs = _specs(cfg, mesh_name)
    for out in run["ranks"]:
        o = out["compressed"][name]
        coord = o["coord"]
        want = _port(run["xla"], f"{name}_{what}", cfg, c["rp"],
                     lead=coord["pod"] if what == "err" else None)
        off = 0
        for got, w, spec, s in zip(o[what], want, specs, _int8_steps(run, name, coord)):
            w = _cut(w, spec, coord)
            assert got.shape == w.shape
            d = (got.double() - w.double()).abs()
            if what == "err":
                assert float(d.max()) <= s * (1 + 1e-3)
                off += int((d > err_eps * s).sum())
                continue
            if what == "m":
                assert float(d.max()) <= (1 - b1) * s * (1 + 1e-3)
            off += int((d > 1e-4 * float(w.abs().max())).sum())
        assert off <= flips, f"{coord}: {off} {what} lanes differ"


@pytest.mark.parametrize("name", list(COMPRESSED))
def test_compressed_step_over_split_leaves_keeps_blocks_bit_equal(run, name):
    """After the compressed step each leaf's block has the same bits on the
    ranks that hold it (the pods of one block agree), and the error tree
    is stored as blocks of the parameters' shapes."""
    c = run["ref"]["compressed"][name]
    specs = _specs(c["cfg"], c["mesh"])
    ranks = [r["compressed"][name] for r in run["ranks"]]
    for what in ("params", "m", "v"):
        for i, spec in enumerate(specs):
            axes = sorted({a for a in spec if a is not None})
            groups = {}
            for o in ranks:
                groups.setdefault(tuple(o["coord"][a] for a in axes), []).append(
                    _bits(o[what][i]))
            for same in groups.values():
                assert all(torch.equal(x, same[0]) for x in same), (what, i)
    for o in ranks:
        assert [e.shape for e in o["err"]] == [p.shape for p in o["params"]]
        assert any(p.shape != w.shape for p, w in zip(o["params"], tree.leaves(c["params"])))


@pytest.mark.parametrize("name", list(COMPRESSED))
def test_compressed_steps_loss_is_the_pods_mean(run, name):
    """The compressed step's loss: the mean of the two pods' losses on their
    halves of the batch (each pod steps on its own rows, as the reference's
    shard_map body does: the MoE aux is the pod's), within 1e-5."""
    c = run["ref"]["compressed"][name]
    halves = [{k: v[4 * p:4 * (p + 1)] for k, v in c["batch"].items()} for p in range(2)]
    loss = sum(float(step.grads_fn(c["cfg"], c["params"], h, 1)[0]) for h in halves) / 2
    for out in run["ranks"]:
        assert abs(out["compressed"][name]["losses"][0] - loss) <= 1e-5
