"""The Mamba-2 mixer over the ``model`` axis, on 4 gloo ranks, held against
the reference's unsharded mixer and forward and its GSPMD train step.

One module-scoped fixture runs ``_torch_mesh.ssm_rank`` on 4 CPU ranks once
(``launch.mesh.run_ranks``, one torch thread each) over the meshes
(data 1, model 4), (data 2, model 2) and two (data 1, model 2) meshes of
ranks {0, 1} and {2, 3}; meanwhile one 4-device XLA subprocess runs the
reference's ``train_step`` under GSPMD from the test's parameters.

Cases: the smoke configs of mamba2_780m and jamba_1_5_large carrying their
full configs' ``sharding_rules`` (mamba2: ``DEFAULT_RULES``, ``ssm_inner``
and ``ssm_heads`` on model; jamba's own, experts on data and
``expert_mlp`` on model beside them), and ``mamba_drops``: mamba2's smoke
config with 6 heads of d_inner 96, whose columns split at model 4 and whose
heads do not, so the mixer runs whole there (the divisibility drop; split
at model 2). Every case in f32 with the division unit in ``taylor_pallas``.
The split mixer sums its out-projection in another order: the mixer's
output, state and conv tails and the logits are held to ``RTOL`` (1e-5) of
the largest value, as ``test_torch_models.py`` holds the unsharded port;
greedy tokens, the blocks across ranks and checkpoints exactly.

The train steps' bounds are these models' own sum-order floor, not
``test_torch_tensor_parallel.py``'s 1e-5: the split step against the
single process already reads m 3.6e-5 / v 7.2e-5 of a leaf's largest value
on jamba's smoke config at (1, 4) (``tools/ssm_step_noise.py --arch
jamba_1_5_large --smoke --mesh 1x4 --seq 32``; the Mamba leaves whose
gradients sum over every token: dt_bias, A_log, wB, wC), and AdamW's first
step turns a gradient below that noise into +-lr (``PERF.md`` §6, the ep
phase).
So: the loss within 1e-5; m and v within ``STATE_RTOL`` (2e-4) of each
leaf's largest value; the parameters within 1e-4 of it where the first
moment is above ``STATE_RTOL`` of its largest, and within 2 lr elsewhere.
A rank missing a sum over model is off by a share of the whole gradient
(7-15% of a leaf's largest value with the wB / wC sum dropped), not by
1e-4.
"""
import dataclasses
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
from repro.core.division_modes import DivisionConfig as RefDivisionConfig
from repro.models import forward as ref_forward
from repro.models.mamba2 import decode_mamba as ref_decode_mamba
from repro.models.mamba2 import mamba_mixer as ref_mamba_mixer
from repro.serving import pad_cache_to as ref_pad_cache_to
from repro.train import checkpoint as ref_checkpoint
from repro_torch import convert, tree
from repro_torch.configs import get_smoke_config
from repro_torch.core.division_modes import DivisionConfig
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import init_params
from repro_torch.models.parallel import tensor_parallel
from repro_torch.optim import adamw
from repro_torch.serving import ServingEngine
from repro_torch.sharding import rules as shr
from repro_torch.train import checkpoint, step
import _torch_mesh
from _ref_params import ref_init
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

N_RANKS = 4
DEADLINE_S = 300.0
RTOL = 1e-5
MODE = "taylor_pallas"
PROMPT, N_DECODE = 32, 2
GEN_LENS, GEN_NEW = (13, 7), 6
MIX_LENGTHS = (32, 21)
# name: (arch, replacements)
CASES = {"mamba2_780m": ("mamba2_780m", {}),
         "jamba_1_5_large": ("jamba_1_5_large", {}),
         "mamba_drops": ("mamba2_780m", {"ssm_heads": 6, "d_inner": 96})}
MESHES = {"1x4": 4, "2x2": 2, "1x2": 2}          # name: model-axis size
# name: (case, mesh); the (2, 2) step is checkpointed.
TRAIN = {"mamba2_2x2": ("mamba2_780m", "2x2"), "jamba_1x4": ("jamba_1_5_large", "1x4")}
TRAIN_BATCH, TRAIN_SEQ, N_MICRO = 8, 32, 2
CLIP_SHARE = 0.5
STATE_RTOL = 2e-4


def _pair(arch, **kw):
    """The reference's and the port's smoke configs of ``arch`` in f32,
    with the full config's sharding rules."""
    div = dict(mode=MODE, schedule="paper")
    rules = ref_get_config(arch).sharding_rules
    ref = dataclasses.replace(ref_smoke_config(arch), param_dtype="float32",
                              division=RefDivisionConfig(**div), sharding_rules=rules, **kw)
    port = dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                               division=DivisionConfig(**div), sharding_rules=rules, **kw)
    return ref, port


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _case(name):
    arch, repl = CASES[name]
    rc, pc = _pair(arch, **repl)
    rp = ref_init(rc)
    pp = convert.params_from_reference(_np(rp), pc, "cpu")
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    toks = rng.integers(0, rc.vocab, (2, PROMPT + N_DECODE))
    prompts = [rng.integers(1, pc.vocab, n).tolist() for n in GEN_LENS]
    x = rng.normal(size=(2, PROMPT, pc.d_model)).astype(np.float32)
    x_step = rng.normal(size=(2, 1, pc.d_model)).astype(np.float32)
    return {"rc": rc, "rp": rp, "toks": toks, "x": x, "x_step": x_step,
            "port": {"cfg": pc, "params": pp, "prompt_len": PROMPT,
                     "kw": {"tokens": torch.from_numpy(toks[:, :PROMPT])},
                     "decode": [torch.from_numpy(toks[:, PROMPT + t:PROMPT + t + 1])
                                for t in range(N_DECODE)],
                     "prompts": prompts, "hand": {}, "max_new": GEN_NEW,
                     "serve": name != "mamba_drops"}}


def _layer0(c):
    """The first Mamba layer's parameters (the port's layout, which the
    reference's mixer takes as they are: one layer, no stacked axis)."""
    return {k: jnp.asarray(v.numpy())
            for k, v in c["port"]["params"]["groups"][0]["layers"][0]["mamba"].items()}


def _mixer_reference(c):
    """The reference's mixer on one layer: prefill with lengths, its cache,
    and one decode step from that cache."""
    p = _layer0(c)
    y, cache = ref_mamba_mixer(p, jnp.asarray(c["x"]), c["rc"], return_state=True,
                               lengths=jnp.asarray(MIX_LENGTHS, jnp.int32))
    y_step, stepped = ref_decode_mamba(p, jnp.asarray(c["x_step"]), cache, c["rc"])
    return {"y": np.asarray(y), "cache": _np(cache), "y_step": np.asarray(y_step),
            "stepped": _np(stepped)}


def _train_inputs():
    out = {}
    tokens = np.random.default_rng(5).integers(0, 256, (TRAIN_BATCH, TRAIN_SEQ + 1))
    batch = {"tokens": torch.from_numpy(tokens[:, :-1]).int(),
             "labels": torch.from_numpy(tokens[:, 1:]).int()}
    for name, (case, mesh_name) in TRAIN.items():
        rc, pc = _pair(CASES[case][0], **CASES[case][1])
        rp = ref_init(rc)
        pp = convert.params_from_reference(_np(rp), pc, "cpu")
        _, _, grads = step.grads_fn(pc, pp, batch, N_MICRO)
        norm = float(adamw.global_norm(grads))
        opt_cfg = adamw.AdamWConfig(division=pc.division, grad_clip=CLIP_SHARE * norm)
        out[name] = {"cfg": pc, "params": pp, "batch": batch, "opt_cfg": opt_cfg,
                     "n_micro": N_MICRO, "mesh": mesh_name, "rc": rc, "rp": rp,
                     "grads": grads}
    return out, tokens


XLA_REF = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, get_smoke_config
from repro.core.division_modes import DivisionConfig
from repro.launch.mesh import _axis_type_kwargs
from repro.models import init_params
from repro.optim import adamw
from repro.sharding import rules
from repro.train import step

d = np.load(sys.argv[1])
out = {}
for name, arch, shape in (("mamba2_2x2", "mamba2_780m", (2, 2)),
                          ("jamba_1x4", "jamba_1_5_large", (1, 4))):
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                              division=DivisionConfig(mode="taylor_pallas", schedule="paper"),
                              sharding_rules=get_config(arch).sharding_rules)
    opt_cfg = adamw.AdamWConfig(division=cfg.division, grad_clip=float(d[f"{name}_clip"]))
    like = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(like), [
        jnp.asarray(d[f"{name}_param_{i}"])
        for i in range(len(jax.tree_util.tree_leaves(like)))])
    mesh = jax.make_mesh(shape, ("data", "model"), **_axis_type_kwargs(2))
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
    cases = {name: _case(name) for name in CASES}
    train, tokens = _train_inputs()
    d = tmp_path_factory.mktemp("xla_ssm")
    arrays = {"tokens": tokens}
    for name, t in train.items():
        arrays[f"{name}_clip"] = np.float64(t["opt_cfg"].grad_clip)
        for i, a in enumerate(jax.tree_util.tree_leaves(t["rp"])):
            arrays[f"{name}_param_{i}"] = np.asarray(a, np.float32)
    np.savez(d / "in.npz", **arrays)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    xla = subprocess.Popen([sys.executable, "-c", XLA_REF, str(d / "in.npz"),
                            str(d / "out.npz")], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, cwd=root,
                           env={**os.environ, "PYTHONPATH": "src"})
    ckpt = str(tmp_path_factory.mktemp("ssm_ckpt"))
    mixers = {}
    for name, c in cases.items():
        ref = _mixer_reference(c)
        pc = c["port"]["cfg"]
        mixers[name] = {"cfg": pc, "p": c["port"]["params"]["groups"][0]["layers"][0]["mamba"],
                        "x": torch.from_numpy(c["x"]), "x_step": torch.from_numpy(c["x_step"]),
                        "lengths": torch.tensor(MIX_LENGTHS, dtype=torch.int32),
                        "cache": {k: torch.from_numpy(np.array(v))
                                  for k, v in ref["cache"].items()}}
        c["mixer_ref"] = ref
    draw_cfg = _pair("mamba2_780m")[1]
    inp = {"cases": {n: c["port"] for n, c in cases.items()}, "mixers": mixers,
           "train": {n: {k: t[k] for k in ("cfg", "params", "batch", "opt_cfg", "n_micro",
                                            "mesh")} | ({"ckpt_dir": ckpt}
                                                       if n == "mamba2_2x2" else {})
                     for n, t in train.items()},
           "draws": {"cfg": draw_cfg, "seed": 3,
                     "reference": _np(train["mamba2_2x2"]["rp"])}}
    try:
        ranks = run_ranks(_torch_mesh.ssm_rank, N_RANKS, inp, device_type="cpu",
                          timeout_s=DEADLINE_S)
        _, stderr = xla.communicate(timeout=DEADLINE_S)
    finally:
        if xla.poll() is None:
            xla.kill()
    assert xla.returncode == 0, stderr[-3000:]
    return {"cases": cases, "train": train, "ranks": ranks, "ckpt": ckpt,
            "xla": dict(np.load(d / "out.npz")), "draw_cfg": draw_cfg}


# ----------------------------------------------------------------- helpers

def _groups(mesh_name: str, pair: int = 0):
    """The model groups of ``mesh_name`` (each in model order) that ran a
    case: (1, 2) on one pair, (2, 2) on its two data rows."""
    return {"1x4": [[0, 1, 2, 3]], "2x2": [[0, 1], [2, 3]],
            "1x2": [[2 * pair, 2 * pair + 1]]}[mesh_name]


def _pair_of(name):
    return list(CASES).index(name) % 2


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= rtol, rel


def _gather(parts, full: int):
    if parts[0].shape[-1] == full:
        assert all(torch.equal(p, parts[0]) for p in parts)
        return parts[0]
    return torch.cat(parts, -1)


def _dims(cfg, mesh_name):
    class _Sizes:
        shape = {"data": 2 if mesh_name == "2x2" else 1, "model": MESHES[mesh_name]}

    return tree.leaves(shr.model_dims(cfg, _Sizes()))


def _blocks(cfg, mesh_name, leaves_of_ranks):
    out = []
    for i, parts in enumerate(zip(*leaves_of_ranks)):
        dim = _dims(cfg, mesh_name)[i]
        out.append(parts[0] if dim is None else torch.cat(parts, dim))
    return out


# -------------------------------------------------------------------- mixer

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", list(CASES))
def test_mixer_is_the_references(run, name, mesh_name):
    """One layer's mixer on the rank's heads against the reference's
    ``mamba_mixer`` (with lengths) and ``decode_mamba``: the output on every
    rank; the state and ``conv_x`` of the ranks' heads put together;
    ``conv_B``, ``conv_C`` whole on every rank; each within RTOL of the
    reference's largest value."""
    want = run["cases"][name]["mixer_ref"]
    for group in _groups(mesh_name, _pair_of(name)):
        outs = [run["ranks"][r]["mixer"][name, mesh_name] for r in group]
        for o in outs:
            _close(o["y"], want["y"])
            _close(o["y_step"], want["y_step"])
        for key, got in (("cache", [o["cache"] for o in outs]),
                         ("stepped", [o["stepped"] for o in outs])):
            split = outs[0]["split"]
            for leaf, dim in (("state", 1), ("conv_x", 2)):
                parts = [g[leaf] for g in got]
                _close(torch.cat(parts, dim) if split else parts[0], want[key][leaf])
            for leaf in ("conv_B", "conv_C"):
                for g in got:
                    _close(g[leaf], want[key][leaf])


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_the_mixer_splits_where_its_heads_do(run, mesh_name):
    """The plan splits the mixer by heads where ``ssm_heads`` divides the
    model axis, each prefill and decode step issuing one all-gather (the
    gated norm's rows) and one all-reduce (the out-projection); at model 4
    mamba_drops' 6 heads do not divide, its leaves are held whole and the
    mixer issues no collective."""
    for name in CASES:
        for group in _groups(mesh_name, _pair_of(name)):
            for r in group:
                o = run["ranks"][r]["mixer"][name, mesh_name]
                split = not (name == "mamba_drops" and mesh_name == "1x4")
                assert o["split"] == split == run["ranks"][r]["plan"][name, mesh_name]["ssm"]
                want = ["all-gather", "all-reduce"] if split else []
                assert o["ops"] == want and o["decode_ops"] == want
                if name != "jamba_1_5_large":        # (its dense MLP splits too)
                    placements = run["ranks"][r]["plan"][name, mesh_name]["placements"]
                    assert any("model" in p for p in placements) == split


def test_a_decode_step_issues_one_gather_and_one_reduce_a_mamba_layer(run):
    """On (1, 4): per Mamba layer one all-gather and one all-reduce over
    model; jamba's attention, MLP, MoE and vocab add their all-reduces;
    mamba_drops' mixers none (its vocab of 257 does not split either)."""
    for name, c in run["cases"].items():
        cfg = c["port"]["cfg"]
        n_mamba = sum(s.mixer == "mamba" for s in cfg.layer_specs())
        ops = run["ranks"][0]["ops"][name]
        if name == "mamba_drops":
            assert ops == []
        elif name == "mamba2_780m":
            assert ops == ["all-gather", "all-reduce"] * n_mamba
        else:
            assert ops.count("all-gather") == n_mamba and ops.count("all-reduce") > n_mamba


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_the_cache_holds_the_ranks_heads(run, mesh_name):
    for name in CASES:
        cfg = run["cases"][name]["port"]["cfg"]
        m = MESHES[mesh_name]
        split = cfg.ssm_heads % m == 0
        want = ((cfg.ssm_heads // m, cfg.d_inner // m) if split
                else (cfg.ssm_heads, cfg.d_inner)) + (cfg.ssm_state,)
        for group in _groups(mesh_name, _pair_of(name)):
            for r in group:
                assert run["ranks"][r]["forward"][name, mesh_name]["cache_ssm"] == {want}


# ------------------------------------------------------------------ forward

@pytest.fixture(scope="module")
def reference(run):
    out = {}
    for name, c in run["cases"].items():
        rc, rp = c["rc"], c["rp"]
        tokens = jnp.asarray(c["toks"][:, :PROMPT])
        train, _, _ = ref_forward(rc, rp, tokens=tokens, mode="train")
        prefill, cache, _ = ref_forward(rc, rp, tokens=tokens, mode="prefill")
        cache = ref_pad_cache_to(cache, PROMPT, PROMPT + N_DECODE, rc)
        steps = []
        for t in range(N_DECODE):
            logits, cache, _ = ref_forward(
                rc, rp, tokens=jnp.asarray(c["toks"][:, PROMPT + t:PROMPT + t + 1]),
                cache=cache, pos=PROMPT + t, mode="decode")
            steps.append(np.asarray(logits))
        out[name] = {"train": np.asarray(train), "prefill": np.asarray(prefill),
                     "decode": steps}
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", list(CASES))
def test_forward_logits_are_the_references(run, reference, name, mesh_name):
    """Train and prefill logits and two decode steps from the prefill's
    cache, the ranks' vocab blocks side by side, against the reference's
    unsharded forward: within RTOL of the largest logit, the same argmax."""
    want = reference[name]
    V = run["cases"][name]["rc"].vocab
    for group in _groups(mesh_name, _pair_of(name)):
        outs = [run["ranks"][r]["forward"][name, mesh_name] for r in group]
        got = {"train": _gather([o["train"] for o in outs], V),
               "prefill": _gather([o["prefill"] for o in outs], V)}
        for what in ("train", "prefill"):
            _close(got[what], want[what])
            np.testing.assert_array_equal(got[what].argmax(-1).numpy(),
                                          want[what].argmax(-1))
        for t in range(N_DECODE):
            _close(_gather([o["decode"][t] for o in outs], V), want["decode"][t])


# --------------------------------------------------------------- greedy tokens

@pytest.fixture(scope="module")
def unsharded_tokens(run):
    out = {}
    for name, c in run["cases"].items():
        p = c["port"]
        out[name] = ServingEngine(p["cfg"], p["params"], max_len=64).generate_batch(
            p["prompts"], p["max_new"])
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_greedy_tokens_are_the_unsharded_runs(run, unsharded_tokens, name):
    """f32 generate_batch on (1, 4) gives the unsharded engine's tokens on
    every rank, and serve() (continuous batching into the rank's heads of
    the cache) the same for mamba2 and jamba."""
    for out in run["ranks"]:
        got = out["generate"][name]
        assert got["batch"] == unsharded_tokens[name]
        if run["cases"][name]["port"]["serve"]:
            assert got["serve"] == unsharded_tokens[name]


# ---------------------------------------------------------------- training

def _train_ranks(run, name):
    mesh_name = run["train"][name]["mesh"]
    return mesh_name, _groups(mesh_name)[0]


def _assembled(run, name, what):
    t = run["train"][name]
    mesh_name, group = _train_ranks(run, name)
    return _blocks(t["cfg"], mesh_name, [run["ranks"][r]["train"][name][what] for r in group])


def _within(got, want, rtol):
    for i, (g, w) in enumerate(zip(got, want)):
        assert float((g - w).abs().max()) <= rtol * float(w.abs().max()), i


def _params_within(got, want, m, lr):
    """The parameters within 1e-4 of each leaf's largest value where the
    first moment ``m`` resolves the gradient's sign (above STATE_RTOL of its
    largest), within 2 lr elsewhere."""
    for i, (g, w, mi) in enumerate(zip(got, want, m)):
        d = (g - w).abs()
        sure = mi.abs() > STATE_RTOL * float(mi.abs().max())
        assert float(torch.where(sure, d, 0).max()) <= 1e-4 * float(w.abs().max()), i
        assert float(d.max()) <= 2 * lr + 1e-4 * float(w.abs().max()), i


def _check_step(run, name, what, want):
    """``want``: {params, m, v} leaf lists of the step the mesh's is held to."""
    got = _assembled(run, name, what)
    if what == "params":
        _params_within(got, want["params"], want["m"], run["train"][name]["opt_cfg"].lr)
    else:
        _within(got, want[what], STATE_RTOL)


@pytest.mark.parametrize("what", ["loss", "params", "m", "v"])
@pytest.mark.parametrize("name", list(TRAIN))
def test_train_step_is_the_references_gspmd_step(run, name, what):
    """The step on the mesh (mamba2 on (2, 2), jamba on (1, 4)) against the
    reference's train_step under GSPMD on the same mesh, the gradients
    clipped at half their norm, within the module's step bounds."""
    xla = run["xla"]
    t = run["train"][name]
    if what == "loss":
        for out in run["ranks"]:
            assert abs(out["train"][name]["loss"] - float(xla[f"{name}_loss"])) <= 1e-5
        return
    like = jax.tree_util.tree_structure(t["rp"])
    want = {w: tree.leaves(convert.params_from_reference(jax.tree_util.tree_unflatten(
        like, [xla[f"{name}_{w}_{i}"] for i in range(like.num_leaves)]), t["cfg"], "cpu"))
        for w in ("params", "m", "v")}
    _check_step(run, name, what, want)


@pytest.mark.parametrize("what", ["loss", "params", "m", "v"])
@pytest.mark.parametrize("name", list(TRAIN))
def test_train_step_is_the_single_process_step(run, name, what):
    t = run["train"][name]
    state = step.init_state(t["cfg"], t["params"], t["opt_cfg"])
    new, metrics = step.train_step(t["cfg"], t["opt_cfg"], state, t["batch"], n_micro=N_MICRO)
    if what == "loss":
        assert abs(run["ranks"][0]["train"][name]["loss"] - float(metrics["loss"])) <= 1e-5
        return
    _check_step(run, name, what, {"params": tree.leaves(new.params),
                                  "m": tree.leaves(new.opt.m), "v": tree.leaves(new.opt.v)})


@pytest.mark.parametrize("name", list(TRAIN))
def test_the_whole_ssm_leaves_take_every_ranks_gradient(run, name):
    """The first moments of wB, wC, conv_B and conv_C (whole on every rank,
    each rank reading them for its own heads) are (1 - b1) * clip * g with
    g the single process's gradient: the sum over the model ranks. Without
    that sum a rank would hold its heads' part alone."""
    t = run["train"][name]
    norm = float(adamw.global_norm(t["grads"]))
    clip = t["opt_cfg"].grad_clip / (norm + 1e-9)
    paths = tree.paths(t["params"])
    got = _assembled(run, name, "m")
    picked = [i for i, p in enumerate(paths)
              if any(p.endswith(f"mamba/{k}") for k in ("wB", "wC", "conv_B", "conv_C"))]
    assert picked
    grads = tree.leaves(t["grads"])
    _within([got[i] for i in picked], [(1 - t["opt_cfg"].b1) * clip * grads[i] for i in picked],
            STATE_RTOL)


@pytest.mark.parametrize("name", list(TRAIN))
def test_each_leaf_is_bit_equal_on_the_ranks_that_hold_its_block(run, name):
    """After the step every leaf has the same bits on the ranks holding the
    same block of it: a replicated one (wB, wC, the norms) on all 4 ranks,
    a split one on its data peers; the state stays DTensors."""
    t = run["train"][name]
    mesh_name = t["mesh"]
    dims = _dims(t["cfg"], mesh_name)
    ranks = [r["train"][name] for r in run["ranks"]]
    m = MESHES[mesh_name]
    bits = lambda x: x.view(torch.int32)
    for what in ("params", "m", "v"):
        for i, dim in enumerate(dims):
            holders = ([list(range(N_RANKS))] if dim is None
                       else [[r for r in range(N_RANKS) if r % m == k] for k in range(m)])
            for rs in holders:
                assert all(torch.equal(bits(ranks[r][what][i]), bits(ranks[rs[0]][what][i]))
                           for r in rs), (what, i)
    assert all(o["dtensors"] for o in ranks)
    paths = tree.paths(t["params"])
    split = {p.rsplit("/", 1)[-1] for p, d in zip(paths, dims) if d is not None and "mamba" in p}
    assert split == {"wz", "wx", "conv_x", "norm", "wout", "wdt", "A_log", "D", "dt_bias"}


def test_a_split_mamba_checkpoint_holds_the_global_values(run):
    """The (2, 2) step's DTensor state, saved by every rank (one writes):
    the port's restore in this process and the reference's give the ranks'
    blocks put together, bit for bit."""
    t = run["train"]["mamba2_2x2"]
    like = step.init_state(t["cfg"], t["params"], t["opt_cfg"])
    got = checkpoint.restore(run["ckpt"], 1, like)
    for w, g in (("params", got.params), ("m", got.opt.m), ("v", got.opt.v)):
        assert all(torch.equal(a, b) for a, b in zip(tree.leaves(g),
                                                       _assembled(run, "mamba2_2x2", w)))
    theirs = ref_checkpoint.restore(run["ckpt"], 1, _np(tree.map_tree(lambda x: x.numpy(),
                                                                      like)))
    for a, b in zip(jax.tree_util.tree_leaves(theirs), tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(a).reshape(b.shape), b.numpy())


def test_a_rank_draws_and_converts_only_its_mamba_blocks(run):
    """init_params(shardings=) and params_from_reference(shardings=) on each
    rank of (2, 2) cut the Mamba leaves one at a time: put together, each
    model group's blocks are the whole tree this process draws and converts."""
    cfg = run["draw_cfg"]
    want = {"init": tree.leaves(init_params(cfg, torch.Generator().manual_seed(3))),
            "convert": tree.leaves(convert.params_from_reference(
                _np(run["train"]["mamba2_2x2"]["rp"]), cfg, "cpu"))}
    for what, whole in want.items():
        for group in ((0, 1), (2, 3)):
            got = _blocks(cfg, "2x2", [run["ranks"][r]["draws"][what] for r in group])
            assert all(torch.equal(a, b) for a, b in zip(got, whole))
    assert any(run["ranks"][0]["draws"]["init"][i].shape != whole[i].shape
               for i in range(len(whole)))


def test_the_drop_plan_holds_the_mixer_whole():
    """At ssm_heads 48 on a model axis of 32 (mamba2_780m's own widths:
    d_inner 3072 divides, 48 heads do not) the plan runs the mixer whole and
    holds its leaves whole; at 16 it splits them by heads."""
    from repro_torch.configs import get_config

    cfg = get_config("mamba2_780m")

    class _Mesh:
        mesh_dim_names = ("data", "model")

        def __init__(self, model):
            self.shape = (256 // model, model)

        def get_coordinate(self):
            return [0, 1]

    for model, split in ((32, False), (16, True)):
        tp = tensor_parallel(cfg, _Mesh(model))
        assert tp.ssm == split
        layer = tp.shardings["groups"][0]["layers"][0]["mamba"]
        assert ("model" in layer["wx"].spec) == split and layer["wB"].spec == (None, None)
