"""Expert parallelism for the MoE models on 4 gloo ranks, held against the
reference's unsharded MoE FFN and forward and its GSPMD train step.

One module-scoped fixture runs ``_torch_mesh.ep_rank`` on 4 CPU ranks once
(``launch.mesh.run_ranks``, one torch thread each); meanwhile one 4-device
XLA subprocess runs the reference's ``train_step`` under GSPMD on the same
meshes, from the test's parameters. The tests assert on what came back.

  * The data-parallel MoE FFN (two (data 2) meshes of ranks {0, 1} and
    {2, 3}; each rank given its half of the batch): the capacity and the
    positions are the global batch's, so the kept (token, choice) pairs are
    the reference's on the whole batch, exactly; the output within 1e-6 of
    its largest value, the aux within 1e-6.
  * deepseek_moe_16b and moonshot_v1_16b_a3b, smoke configs under their
    full configs' rules (``experts -> data``, ``expert_mlp -> model``) and
    the dry run's ``ep_model`` / ``ep_tp`` rules, in f32 with the division
    unit in ``taylor_pallas``, on (data 2, model 2), (data 4, model 1) and
    (data 1, model 4): forward logits (every rank given the whole batch)
    and the logits of each rank's rows (the batch split over ``data``: the
    expert exchange) within ``LOGIT_RTOL`` of the reference's; greedy
    tokens and ``serve()`` equal to the unsharded engine's.
  * ``local`` dispatch under ``experts -> data``, a rank's rows (the
    reference's D = 4 shards exchanged side by side) and the whole batch
    (D = 2 shards on every rank), against ``_dispatch_local``.
  * Train steps against the reference's GSPMD step at
    ``test_torch_tensor_parallel.py``'s tolerances (m and v 1e-5, the
    parameters 1e-4 of each leaf's largest value, the loss 1e-5);
    replicated leaves bit-equal on their ranks; the DTensor state's
    checkpoint read by both packages.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.core import division_modes as ref_dm
from repro.core.division_modes import DivisionConfig as RefDivisionConfig
from repro.models import forward as ref_forward
from repro.models import moe as ref_moe
from repro.models.layers import gated_mlp as ref_gated_mlp
from repro.serving import pad_cache_to as ref_pad_cache_to
from repro.train import checkpoint as ref_checkpoint
from repro_torch import convert, tree
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import rules_for
from repro_torch.core.division_modes import DivisionConfig
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import init_params, parallel
from repro_torch.models.params import model_specs
from repro_torch.optim import adamw
from repro_torch.serving import ServingEngine
from repro_torch.sharding import rules as shr
from repro_torch.train import checkpoint, step
import _torch_mesh
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_tensor_parallel import _ref_init, _np

N_RANKS = 4
DEADLINE_S = 300.0
LOGIT_RTOL = 1e-5
MOE_RTOL = 1e-6
MODE = "taylor_pallas"
PROMPT, N_DECODE, BATCH = 32, 2, 4
GEN_LENS, GEN_NEW = (13, 7), 6
# serve() admits each prompt alone, generate_batch prefills them together:
# the capacities differ unless none drops (the chip's MoE serve gate too).
GEN_CF = 8.0
ARCHS = ("deepseek_moe_16b", "moonshot_v1_16b_a3b")
EP_RULES = dict(ref_get_config("deepseek_moe_16b").sharding_rules)
# layout: (mesh, the MoE rules over the config's own)
LAYOUTS = {"2x2": ("2x2", EP_RULES), "4x1": ("4x1", EP_RULES),
           "ep_model": ("1x4", {"experts": "model", "expert_mlp": None}),
           "ep_tp": ("1x4", {"experts": None, "expert_mlp": "model"})}
MESH_SHAPES = {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}
FAULT = [(d, cf) for d in ("cumsum", "sort") for cf in (1.25, 0.5)]
# name: (arch, layout, dispatch) of a train step
TRAINS = {"deepseek_2x2": ("deepseek_moe_16b", "2x2", "cumsum"),
          "moonshot_4x1": ("moonshot_v1_16b_a3b", "4x1", "sort"),
          "deepseek_ep_tp": ("deepseek_moe_16b", "ep_tp", "cumsum")}
TRAIN_BATCH, TRAIN_SEQ, N_MICRO = 8, 32, 2
CLIP_SHARE = 0.5


def _pair(arch, rules=None, **kw):
    """The reference's and the port's smoke configs of ``arch`` in f32, the
    unit in taylor_pallas, with ``rules`` over their sharding rules."""
    div = dict(mode=MODE, schedule="paper")
    extra = {} if rules is None else {"sharding_rules": dict(rules)}
    ref = dataclasses.replace(ref_smoke_config(arch), param_dtype="float32",
                              division=RefDivisionConfig(**div), **extra, **kw)
    port = dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                               division=DivisionConfig(**div), **extra, **kw)
    return ref, port


def _moe_layer(rp):
    """The first MoE layer's leaves of a reference tree (group 1, layer 0)."""
    return jax.tree_util.tree_map(lambda a: np.asarray(a)[0],
                                  rp["groups"][1]["layers"][0]["ffn"])


def _port_leaves(layer):
    return tree.map_tree(lambda a: torch.from_numpy(np.array(a)), layer)


def _fault_inputs():
    """deepseek's smoke MoE layer without shared experts, x (4, 64, 64)."""
    x = np.random.default_rng(0).normal(size=(4, 64, 64)).astype(np.float32)
    out = {}
    for d, cf in FAULT:
        rc, pc = _pair("deepseek_moe_16b", n_shared_experts=0, moe_dispatch=d,
                       capacity_factor=cf)
        layer = _moe_layer(_ref_init(rc))
        out[d, cf] = (rc, pc, layer, x)
    return out


def _case(arch, layout):
    mesh, rules = LAYOUTS[layout]
    rc, pc = _pair(arch, {**EP_RULES, **rules})
    rp = _ref_init(rc)
    pp = convert.params_from_reference(_np(rp), pc, "cpu")
    rng = np.random.default_rng(zlib.crc32(f"{arch}/{layout}".encode()))
    toks = rng.integers(0, rc.vocab, (BATCH, PROMPT + N_DECODE))
    prompts = [rng.integers(1, pc.vocab, n).tolist() for n in GEN_LENS]
    return {"rc": rc, "rp": rp, "toks": toks,
            "port": {"cfg": pc, "params": pp, "mesh": mesh, "prompt_len": PROMPT,
                     "kw": {"tokens": torch.from_numpy(toks[:, :PROMPT])},
                     "decode": [torch.from_numpy(toks[:, PROMPT + t:PROMPT + t + 1])
                                for t in range(N_DECODE)],
                     "prompts": prompts, "hand": {}, "max_new": GEN_NEW, "serve": True,
                     "gen_cfg": dataclasses.replace(pc, capacity_factor=GEN_CF)}}


def _local_inputs():
    """deepseek's smoke MoE layer in ``local`` dispatch at capacity factor
    0.5 under experts -> data: a rank's rows on (4, 1), the whole batch on
    (2, 2)."""
    rc, pc = _pair("deepseek_moe_16b", EP_RULES, moe_dispatch="local", capacity_factor=0.5)
    layer = _moe_layer(_ref_init(rc))
    x = np.random.default_rng(3).normal(size=(N_RANKS, 24, pc.d_model)).astype(np.float32)
    return rc, pc, layer, x


def _train_inputs(tmp):
    out = {}
    tokens = np.random.default_rng(5).integers(0, 512, (TRAIN_BATCH, TRAIN_SEQ + 1))
    batch = {"tokens": torch.from_numpy(tokens[:, :-1]).int(),
             "labels": torch.from_numpy(tokens[:, 1:]).int()}
    for name, (arch, layout, dispatch) in TRAINS.items():
        mesh, rules = LAYOUTS[layout]
        rc, pc = _pair(arch, {**EP_RULES, **rules}, moe_dispatch=dispatch)
        rp = _ref_init(rc)
        pp = convert.params_from_reference(_np(rp), pc, "cpu")
        _, _, grads = step.grads_fn(pc, pp, batch, N_MICRO)
        opt_cfg = adamw.AdamWConfig(division=pc.division,
                                    grad_clip=CLIP_SHARE * float(adamw.global_norm(grads)))
        out[name] = {"cfg": pc, "params": pp, "batch": batch, "opt_cfg": opt_cfg,
                     "n_micro": N_MICRO, "mesh": mesh, "rc": rc, "rp": rp, "tokens": tokens}
    out["deepseek_2x2"]["ckpt_dir"] = str(tmp)
    return out


XLA_REF = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.core.division_modes import DivisionConfig
from repro.launch.mesh import _axis_type_kwargs
from repro.models import init_params
from repro.optim import adamw
from repro.sharding import rules
from repro.train import step

d = np.load(sys.argv[1])
out = {}
for name, arch, shape, rules_, dispatch in json.loads(str(d["cells"])):
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                              division=DivisionConfig(mode="taylor_pallas", schedule="paper"),
                              sharding_rules=dict(rules_), moe_dispatch=dispatch)
    opt_cfg = adamw.AdamWConfig(division=cfg.division, grad_clip=float(d[f"{name}_clip"]))
    like = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(like), [
        jnp.asarray(d[f"{name}_param_{i}"])
        for i in range(len(jax.tree_util.tree_leaves(like)))])
    mesh = jax.make_mesh(tuple(shape), ("data", "model"), **_axis_type_kwargs(2))
    params = jax.device_put(params, rules.param_shardings(cfg, mesh))
    state = step.init_state(cfg, params, opt_cfg)
    tokens = jnp.asarray(d["tokens"], jnp.int32)
    batch = jax.device_put({"tokens": tokens[:, :-1], "labels": tokens[:, 1:]},
                           rules.data_sharding(mesh, 2))
    with rules.use_mesh(mesh), jax.set_mesh(mesh):
        new, metrics = jax.jit(lambda s, b: step.train_step(cfg, opt_cfg, s, b, n_micro=2))(
            state, batch)
    out[f"{name}_loss"] = np.float32(metrics["loss"])
    for what, t in (("params", new.params), ("m", new.opt.m), ("v", new.opt.v)):
        for i, leaf in enumerate(jax.tree_util.tree_leaves(t)):
            out[f"{name}_{what}_{i}"] = np.asarray(leaf)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    fault = _fault_inputs()
    cases = {(a, lay): _case(a, lay) for a in ARCHS for lay in LAYOUTS}
    lrc, lpc, llayer, lx = _local_inputs()
    train = _train_inputs(tmp_path_factory.mktemp("ep_ckpt"))
    d = tmp_path_factory.mktemp("xla_ep")
    cells = json.dumps([(n, a, MESH_SHAPES[LAYOUTS[lay][0]], {**EP_RULES, **LAYOUTS[lay][1]},
                         disp) for n, (a, lay, disp) in TRAINS.items()])
    arrays = {f"{n}_param_{i}": np.asarray(a, np.float32)
              for n, t in train.items() for i, a in enumerate(jax.tree_util.tree_leaves(t["rp"]))}
    np.savez(d / "in.npz", cells=np.array(cells), tokens=train["deepseek_2x2"]["tokens"],
             **{f"{n}_clip": t["opt_cfg"].grad_clip for n, t in train.items()}, **arrays)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    xla = subprocess.Popen([sys.executable, "-c", XLA_REF, str(d / "in.npz"),
                            str(d / "out.npz")], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, cwd=root,
                           env={**os.environ, "PYTHONPATH": "src"})
    lp = _port_leaves(llayer)
    inp = {"fault": {k: (pc, _port_leaves(layer), torch.from_numpy(x))
                     for k, (rc, pc, layer, x) in fault.items()},
           "cases": {k: c["port"] for k, c in cases.items()},
           "local": {"split_4x1": (lpc, lp, torch.from_numpy(lx), "4x1", True),
                     "whole_2x2": (lpc, lp, torch.from_numpy(lx), "2x2", False)},
           "train": {n: {k: t[k] for k in ("cfg", "params", "batch", "opt_cfg", "n_micro",
                                           "mesh") + (("ckpt_dir",) if "ckpt_dir" in t else ())}
                     for n, t in train.items()},
           "remat": {"cfg": dataclasses.replace(train["deepseek_2x2"]["cfg"], remat=True),
                     "params": train["deepseek_2x2"]["params"],
                     "tokens": train["deepseek_2x2"]["batch"]["tokens"]},
           "draws": {"cfg": train["deepseek_2x2"]["cfg"], "seed": 3,
                     "reference": _np(train["deepseek_2x2"]["rp"])}}
    try:
        ranks = run_ranks(_torch_mesh.ep_rank, N_RANKS, inp, device_type="cpu",
                          timeout_s=DEADLINE_S)
        stdout, stderr = xla.communicate(timeout=DEADLINE_S)
    finally:
        if xla.poll() is None:
            xla.kill()
    assert xla.returncode == 0, stderr[-3000:]
    return {"fault": fault, "cases": cases, "local": (lrc, llayer, lx), "train": train,
            "ranks": ranks, "xla": dict(np.load(d / "out.npz"))}


# ------------------------------------------------------- the data-parallel fault

def _ref_kept(rc, layer, x):
    """The reference's kept (token, choice) pairs on the whole batch: its
    router, top-k and positions (``src/repro/models/moe.py``) on T tokens."""
    xt = jnp.asarray(x.reshape(-1, x.shape[-1]))
    probs = ref_dm.softmax(xt @ jnp.asarray(layer["router"]), axis=-1, cfg=rc.division)
    _, idx = jax.lax.top_k(probs, rc.experts_per_tok)
    T, E, k = xt.shape[0], rc.n_experts, rc.experts_per_tok
    C = max(math.ceil(T * k / E * rc.capacity_factor), min(T * k, 8))
    flat_e = np.asarray(idx).reshape(-1)
    pos = np.zeros_like(flat_e)
    for e in range(E):                       # first come, first served
        hit = flat_e == e
        pos[hit] = np.arange(hit.sum())
    return (pos < C).reshape(T, k)


@pytest.mark.parametrize("dispatch,cf", FAULT)
def test_data_parallel_moe_keeps_the_references_pairs(run, dispatch, cf):
    """Two data ranks each given half the batch keep exactly the (token,
    choice) pairs the reference keeps on the whole batch (its capacity from
    the global T, its positions in global token order), and drop some."""
    rc, _, layer, x = run["fault"][dispatch, cf]
    want = _ref_kept(rc, layer, x)
    for pair in ((0, 1), (2, 3)):
        got = torch.cat([run["ranks"][r]["fault"][dispatch, cf]["kept"] for r in pair]).numpy()
        np.testing.assert_array_equal(got, want)
    if cf < 1:
        assert not want.all()


@pytest.mark.parametrize("dispatch,cf", FAULT)
def test_data_parallel_moe_is_the_references_on_the_global_batch(run, dispatch, cf):
    """The ranks' outputs side by side within 1e-6 of the reference's
    unsharded moe_ffn's largest value, the aux (the global batch's) within
    1e-6 on every rank."""
    rc, _, layer, x = run["fault"][dispatch, cf]
    want, aux = ref_moe.moe_ffn(jax.tree_util.tree_map(jnp.asarray, layer), jnp.asarray(x), rc)
    want = np.asarray(want)
    for pair in ((0, 1), (2, 3)):
        outs = [run["ranks"][r]["fault"][dispatch, cf] for r in pair]
        got = torch.cat([o["y"] for o in outs]).numpy()
        assert np.abs(got - want).max() <= MOE_RTOL * np.abs(want).max()
        for o in outs:
            assert abs(o["aux"] - float(aux)) <= MOE_RTOL * abs(float(aux))


# ----------------------------------------------------------------- the layouts

@pytest.fixture(scope="module")
def reference(run):
    out = {}
    for key, c in run["cases"].items():
        rc, rp = c["rc"], c["rp"]
        toks = jnp.asarray(c["toks"][:, :PROMPT])
        train, _, aux = ref_forward(rc, rp, tokens=toks, mode="train")
        prefill, cache, _ = ref_forward(rc, rp, tokens=toks, mode="prefill")
        cache = ref_pad_cache_to(cache, PROMPT, PROMPT + N_DECODE, rc)
        steps = []
        for t in range(N_DECODE):
            logits, cache, _ = ref_forward(
                rc, rp, tokens=jnp.asarray(c["toks"][:, PROMPT + t:PROMPT + t + 1]),
                cache=cache, pos=PROMPT + t, mode="decode")
            steps.append(np.asarray(logits))
        out[key] = {"train": np.asarray(train), "aux": float(aux),
                    "prefill": np.asarray(prefill), "decode": steps}
    return out


def _close(got: torch.Tensor, want):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= LOGIT_RTOL, rel
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _model_group(layout):
    """The ranks of one model group of a layout's mesh, in model order."""
    return {"2x2": [0, 1], "4x1": [0], "1x4": [0, 1, 2, 3]}[LAYOUTS[layout][0]]


def _vocab(parts, V):
    return parts[0] if parts[0].shape[-1] == V else torch.cat(parts, -1)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_under_expert_parallelism_is_the_references(run, reference, arch, layout):
    """Every rank given the whole batch (the engine's case: the experts'
    partial outputs summed over their axis): train and prefill logits and
    two decode steps within LOGIT_RTOL of the reference's, the same
    argmax, the same on every data peer."""
    want = reference[arch, layout]
    V = run["cases"][arch, layout]["rc"].vocab
    ranks = run["ranks"]
    outs = [ranks[r]["forward"][arch, layout] for r in _model_group(layout)]
    for what in ("train", "prefill"):
        _close(_vocab([o[what] for o in outs], V), want[what])
    for t in range(N_DECODE):
        _close(_vocab([o["decode"][t] for o in outs], V), want["decode"][t])
    group = _model_group(layout)
    for r in range(N_RANKS):        # rank r's data peer in the first model group
        assert torch.equal(ranks[r]["forward"][arch, layout]["prefill"],
                           ranks[group[r % len(group)]]["forward"][arch, layout]["prefill"])


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_split_rows_run_the_expert_exchange(run, reference, arch, layout):
    """Each rank given its block of the batch over 'data' (the train step's
    case): the logits of the blocks side by side are the reference's on
    the whole batch, the aux its global one; on a data axis above 1 the
    experts on 'data' are reached by all-to-all and all-gather."""
    want = reference[arch, layout]
    cfg = run["cases"][arch, layout]["port"]["cfg"]
    mesh, _ = LAYOUTS[layout]
    n_data, n_model = MESH_SHAPES[mesh]
    ranks = run["ranks"]
    rows = []
    for i in range(n_data):
        group = [ranks[i * n_model + j]["split"][arch, layout]["logits"] for j in range(n_model)]
        rows.append(_vocab(group, cfg.vocab))
    _close(torch.cat(rows), want["train"])
    for r in ranks:
        got = r["split"][arch, layout]
        assert abs(got["aux"] - want["aux"]) <= 1e-5 * abs(want["aux"])
        exchange = n_data > 1 and LAYOUTS[layout][1].get("experts", "data") == "data"
        assert ("all-to-all" in got["ops"]) == exchange


@pytest.fixture(scope="module")
def unsharded_tokens(run):
    out = {}
    for key, c in run["cases"].items():
        p = c["port"]
        eng = ServingEngine(p["gen_cfg"], p["params"], max_len=64)
        out[key] = eng.generate_batch(p["prompts"], p["max_new"])
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_and_serve_are_the_unsharded_runs(run, unsharded_tokens, arch, layout):
    """generate_batch and serve() (2 slots) on the mesh give the unsharded
    engine's greedy tokens on every rank (at a capacity factor that drops
    nothing, GEN_CF)."""
    for out in run["ranks"]:
        assert out["generate"][arch, layout]["batch"] == unsharded_tokens[arch, layout]
        assert out["generate"][arch, layout]["serve"] == unsharded_tokens[arch, layout]


# ----------------------------------------------------------------------- local

@pytest.mark.parametrize("name", ["split_4x1", "whole_2x2"])
def test_local_dispatch_under_experts_on_data_is_the_references(run, name):
    """``local`` dispatch with the experts on 'data': a rank's rows of 4
    data ranks (the reference's D = 4 shards, exchanged side by side) and
    the whole batch on (2, 2) (D = 2 shards on every rank, each rank's
    experts summed over 'data'), against the reference's _dispatch_local
    and shared experts; the aux is the global batch's."""
    rc, layer, x = run["local"]
    D = 4 if name == "split_4x1" else 2
    p = jax.tree_util.tree_map(jnp.asarray, layer)
    xt = jnp.asarray(x.reshape(-1, x.shape[-1]))
    probs = ref_dm.softmax(xt @ p["router"], axis=-1, cfg=rc.division)
    gate_vals, idx = jax.lax.top_k(probs, rc.experts_per_tok)
    gates = gate_vals * ref_dm.recip(jnp.sum(gate_vals, -1, keepdims=True), rc.division)
    out, counts = ref_moe._dispatch_local(p, xt, probs, gates, idx, rc, D)
    want = np.asarray(out + ref_gated_mlp(p["shared"], xt))
    T, E, k = xt.shape[0], rc.n_experts, rc.experts_per_tok
    aux = E * np.sum(np.asarray(counts) / (T * k) * E * np.asarray(jnp.mean(probs, 0))) \
        * rc.router_aux_weight
    outs = [r["local"][name] for r in run["ranks"]]
    if name == "split_4x1":
        got = torch.cat([o["y"] for o in outs]).reshape(-1, x.shape[-1]).numpy()
    else:
        got = outs[0]["y"].reshape(-1, x.shape[-1]).numpy()
        assert all(torch.equal(o["y"], outs[0]["y"]) for o in outs)
    assert np.abs(got - want).max() <= MOE_RTOL * np.abs(want).max()
    for o in outs:
        assert abs(o["aux"] - aux) <= MOE_RTOL * abs(aux)


# -------------------------------------------------------------------- training

class _Sizes:
    """A stand-in mesh: its axes' sizes only."""

    def __init__(self, **shape):
        self.shape = shape


def _split_of(cfg, mesh_name):
    """Each leaf's executed spec on a stand-in mesh of ``mesh_name``."""
    mesh = _Sizes(**dict(zip(("data", "model"), MESH_SHAPES[mesh_name])))
    return [parallel.executed_spec(p, shr.spec_for(p.shape, p.axes, rules_for(cfg), mesh))
            for p in tree.leaves(model_specs(cfg))]


def _glue(cfg, mesh_name, leaves_of_ranks, coords):
    """Each leaf's global tensor from the ranks' blocks (``leaves_of_ranks``,
    ``coords`` their mesh coordinates): the blocks placed by their
    coordinates on the leaf's split dims."""
    specs = _split_of(cfg, mesh_name)
    sizes = dict(zip(("data", "model"), MESH_SHAPES[mesh_name]))
    out = []
    for i, spec in enumerate(specs):
        parts = {tuple(c[a] for a in sizes): leaves[i]
                 for leaves, c in zip(leaves_of_ranks, coords)}

        def build(dim, fixed):
            if dim == len(spec):
                return parts[tuple(fixed.get(a, 0) for a in sizes)]
            ax = spec[dim]
            if ax is None or sizes[ax] == 1:
                return build(dim + 1, fixed)
            return torch.cat([build(dim + 1, {**fixed, ax: j}) for j in range(sizes[ax])], dim)

        out.append(build(0, {}))
    return out


def _assembled(run, name, what):
    """The ranks' new blocks of ``what`` put together as global tensors."""
    ranks = [r["train"][name] for r in run["ranks"]]
    return _glue(run["train"][name]["cfg"], LAYOUTS[TRAINS[name][1]][0],
                 [o[what] for o in ranks], [o["coord"] for o in ranks])


def _within(got, want, rtol):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= rtol * float(w.abs().max())


@pytest.mark.parametrize("name", list(TRAINS))
@pytest.mark.parametrize("what", ["loss", "params", "m", "v"])
def test_train_step_is_the_references_gspmd_step(run, name, what):
    """The expert-parallel step (DTensor state; the batch split over 'data',
    2 microbatches of the global batch's; gradients clipped at half their
    norm) against the reference's train_step under GSPMD on the same mesh:
    the loss within 1e-5, m and v within 1e-5 and the parameters within
    1e-4 of each leaf's largest value."""
    xla = run["xla"]
    if what == "loss":
        for r in run["ranks"]:
            assert abs(r["train"][name]["loss"] - float(xla[f"{name}_loss"])) <= 1e-5
        return
    t = run["train"][name]
    like = jax.tree_util.tree_structure(t["rp"])
    ref_leaves = [xla[f"{name}_{what}_{i}"] for i in range(like.num_leaves)]
    want = tree.leaves(convert.params_from_reference(
        jax.tree_util.tree_unflatten(like, ref_leaves), t["cfg"], "cpu"))
    _within(_assembled(run, name, what), want, 1e-4 if what == "params" else 1e-5)


@pytest.mark.parametrize("name", list(TRAINS))
def test_train_step_is_the_single_process_step(run, name):
    """The same step against the port's single-process step on the whole
    batch: the loss within 1e-5, the parameters within 1e-4, m and v within
    1e-5."""
    t = run["train"][name]
    state = step.init_state(t["cfg"], t["params"], t["opt_cfg"])
    new, metrics = step.train_step(t["cfg"], t["opt_cfg"], state, t["batch"], n_micro=N_MICRO)
    assert abs(run["ranks"][0]["train"][name]["loss"] - float(metrics["loss"])) <= 1e-5
    for what, want in (("params", new.params), ("m", new.opt.m), ("v", new.opt.v)):
        _within(_assembled(run, name, what), tree.leaves(want),
                1e-4 if what == "params" else 1e-5)


@pytest.mark.parametrize("name", list(TRAINS))
def test_replicated_leaves_and_blocks_are_bit_equal_on_their_ranks(run, name):
    """After the step each leaf has the same bits on every rank that holds
    the same block of it: replicated leaves on all 4, an expert block on
    its peers of the other axis; the state stays DTensors."""
    t = run["train"][name]
    mesh = LAYOUTS[TRAINS[name][1]][0]
    specs = _split_of(t["cfg"], mesh)
    ranks = [r["train"][name] for r in run["ranks"]]
    bits = lambda x: x.view(torch.int32)
    n_split = 0
    for what in ("params", "m", "v"):
        for i, spec in enumerate(specs):
            axes = {a for a in spec if a is not None and dict(
                zip(("data", "model"), MESH_SHAPES[mesh]))[a] > 1}
            n_split += bool(axes)
            groups = {}
            for o in ranks:
                groups.setdefault(tuple(o["coord"][a] for a in sorted(axes)), []).append(
                    bits(o[what][i]))
            for same in groups.values():
                assert all(torch.equal(x, same[0]) for x in same), (what, i)
    assert n_split > 0 and all(o["dtensors"] for o in ranks)


def test_compressed_mean_refuses_experts_split_over_data(run):
    """train_step(compress_axis=) with the experts on data (model = 1)
    raises the ValueError of a split leaf on every rank: the int8 mean's
    scale is per tensor of the reference's layout (F12)."""
    for r in run["ranks"]:
        msg = r["compress_refusal"]
        assert "experts data" in msg and "item 18" in msg, msg


def test_an_expert_parallel_checkpoint_holds_the_global_values(run):
    """The (2, 2) step's DTensor state (experts split over data and model),
    saved by every rank: the port's restore and the reference's give the
    ranks' blocks put together, bit for bit."""
    t = run["train"]["deepseek_2x2"]
    like_state = step.init_state(t["cfg"], t["params"], t["opt_cfg"])
    got = checkpoint.restore(t["ckpt_dir"], 1, like_state)
    for w, g in (("params", got.params), ("m", got.opt.m), ("v", got.opt.v)):
        want = _assembled(run, "deepseek_2x2", w)
        assert all(torch.equal(a, b) for a, b in zip(tree.leaves(g), want))
    theirs = ref_checkpoint.restore(t["ckpt_dir"], 1, _np(tree.map_tree(
        lambda x: x.numpy(), like_state)))
    for a, b in zip(jax.tree_util.tree_leaves(theirs), tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(a).reshape(b.shape), b.numpy())


def test_remat_recompute_on_another_thread_routes_as_the_forward(run):
    """remat's recompute runs in the backward pass, which autograd runs on
    its own threads on the card, where no mesh is active: the MoE layers
    take their placement from the forward, so the gradients are the same
    bits as a backward pass on the forward's thread."""
    for r in run["ranks"]:
        assert r["remat"]["error"] is None, r["remat"]["error"]
        same, other = r["remat"]["same"], r["remat"]["other"]
        assert len(same) == len(other) > 0
        assert all(torch.equal(a, b) for a, b in zip(same, other))


# ------------------------------------------------------------------ placement

def test_a_rank_draws_and_converts_only_its_expert_blocks(run):
    """init_params(shardings=) on each rank of (2, 2) keeps its block of the
    values this process draws whole from the same seed -- the experts cut
    over data and expert_mlp over model -- and params_from_reference(
    shardings=) its block of the reference's: put together, the ranks'
    blocks are the whole tree."""
    t = run["train"]["deepseek_2x2"]
    cfg = t["cfg"]
    want = {"init": tree.leaves(init_params(cfg, torch.Generator().manual_seed(3))),
            "convert": tree.leaves(convert.params_from_reference(_np(t["rp"]), cfg, "cpu"))}
    draws = [r["draws"] for r in run["ranks"]]
    for what, whole in want.items():
        got = _glue(cfg, "2x2", [d[what] for d in draws], [d["coord"] for d in draws])
        assert all(torch.equal(a, b) for a, b in zip(got, whole))
    wi = [s for s in _split_of(cfg, "2x2") if s[0] == "data"]
    assert wi and all(s == ("data", None, "model") or s == ("data", "model", None) for s in wi)


# -------------------------------------------------------------------- the plan

@pytest.mark.parametrize("arch,shape,per_rank", [
    ("deepseek_moe_16b", {"data": 16, "model": 16}, 4),
    ("moonshot_v1_16b_a3b", {"pod": 2, "data": 16, "model": 16}, 4),
    ("jamba_1_5_large", {"data": 16, "model": 16}, 1),
    ("jamba_1_5_large", {"data": 256, "model": 1}, 16)])
def test_the_experts_lie_where_their_specs_put_them(arch, shape, per_rank):
    """64 experts over data 16 are 4 a rank, jamba's 16 over 16 one, and an
    expert axis that does not divide (16 over 256) runs whole; expert_mlp
    lies on model where the axis holds more than one rank; jamba's embed
    leaves stay whole (FSDP is not executed)."""
    cfg = get_config(arch)
    mesh = _Sizes(**shape)
    for p in tree.leaves(model_specs(cfg)):
        spec = parallel.executed_spec(p, shr.spec_for(p.shape, p.axes, rules_for(cfg), mesh))
        local = shr.local_shape(p.shape, shr.NamedSharding(mesh, spec))
        if p.expert:
            assert local[0] == per_rank
            assert spec[p.axes.index("expert_mlp")] == "model"
        assert "data" not in spec or p.expert
