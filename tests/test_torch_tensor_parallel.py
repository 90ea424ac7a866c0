"""Tensor parallelism over the ``model`` axis, on 4 gloo ranks, held against
the reference's unsharded forward and its GSPMD train step.

One module-scoped fixture runs ``_torch_mesh.tp_rank`` on 4 CPU ranks once
(``launch.mesh.run_ranks``, one torch thread each) over the meshes
(data 1, model 4), (data 2, model 2) and two (data 1, model 2) meshes of
ranks {0, 1} and {2, 3}, all built from the same 4 ranks; the tests below
assert on what the ranks returned. Meanwhile one 4-device XLA subprocess
runs the reference's ``train_step`` under GSPMD on the same meshes, from
the test's parameters (the reference's ``init_params`` draws others when
XLA has 4 devices).

The smoke configs run in f32 with the division unit in ``taylor_pallas``
(the port's kernels' plain versions on the CPU, the reference's Pallas
kernels in interpret mode). Tensor parallelism sums the row-split products
in another order: logits are held to ``LOGIT_RTOL`` (1e-5) of the largest
logit, as ``test_torch_models.py`` holds the unsharded port; the train
steps to
``test_torch_sharded_paths.py``'s step tolerances (m and v 1e-5 and the
parameters 1e-4 of each leaf's largest value, the loss 1e-5); greedy
tokens, the replicated leaves across ranks and checkpoints exactly.
"""
import dataclasses
import os
import subprocess
import sys
import zlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.core.division_modes import DivisionConfig as RefDivisionConfig
from repro.models import forward as ref_forward
from repro.serving import pad_cache_to as ref_pad_cache_to
from repro.train import checkpoint as ref_checkpoint
from repro_torch import convert, tree
from repro_torch.configs import get_smoke_config
from repro_torch.core.division_modes import DivisionConfig
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import forward, init_params
from repro_torch.optim import adamw
from repro_torch.serving import ServingEngine
from repro_torch.sharding import rules as shr
from repro_torch.train import checkpoint, step
import _torch_mesh
from _ref_params import ref_init
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

N_RANKS = 4
DEADLINE_S = 300.0
LOGIT_RTOL = 1e-5
MODE = "taylor_pallas"
PROMPT, N_DECODE = 32, 2
GEN_LENS, GEN_NEW = (13, 7), 6
# name: (arch, replacements). whisper_drops has 6 heads (replicated at
# model 4, split at model 2) and a vocab of 257 (replicated at any model
# size), as whisper_tiny's 6 heads and 51865 tokens are at model 4 and 16.
CASES = {"paper_fpdiv": ("paper_fpdiv", {}),
         "tinyllama_1_1b": ("tinyllama_1_1b", {}),
         "llama3_8b": ("llama3_8b", {}),
         "granite_8b": ("granite_8b", {}),
         "gemma3_12b": ("gemma3_12b", {}),
         "llava_next_mistral_7b": ("llava_next_mistral_7b", {}),
         "whisper_tiny": ("whisper_tiny", {}),
         "whisper_drops": ("whisper_tiny", {"n_heads": 6, "n_kv_heads": 6, "vocab": 257})}
MESHES = {"1x4": 4, "2x2": 2, "1x2": 2}          # name: model-axis size
SSM_ARCHS = ("mamba2_780m", "jamba_1_5_large")   # Mamba-2 layers under model 2
TRAIN_BATCH, TRAIN_SEQ, N_MICRO = 8, 32, 2
CLIP_SHARE = 0.5                  # grad_clip at this share of the gradients' norm


def _pair(arch, **kw):
    div = dict(mode=MODE, schedule="paper")
    ref = dataclasses.replace(ref_smoke_config(arch), param_dtype="float32",
                              division=RefDivisionConfig(**div), **kw)
    port = dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                               division=DivisionConfig(**div), **kw)
    return ref, port


def _ref_init(cfg, seed=0):
    """The reference's ``init_params`` with its per-leaf key the same in
    every process (``_ref_params.ref_init``, ROADMAP F13)."""
    return ref_init(cfg, seed)


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _case(name):
    """The reference's and the port's configs, parameters and inputs of a
    case: a 32-token prompt (tokens, or embeddings for llava; encoder frames
    for whisper), two decode tokens, and the greedy prompts."""
    arch, repl = CASES[name]
    rc, pc = _pair(arch, **repl)
    rp = _ref_init(rc)
    pp = convert.params_from_reference(_np(rp), pc, "cpu")
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    toks = rng.integers(0, rc.vocab, (2, PROMPT + N_DECODE))
    rk, pk = {}, {}
    if pc.embed_inputs and not pc.is_encoder_decoder:
        e = rng.normal(size=(2, PROMPT, pc.d_model)).astype(np.float32)
        rk["embeds"], pk["embeds"] = jnp.asarray(e), torch.from_numpy(e)
    else:
        rk["tokens"], pk["tokens"] = jnp.asarray(toks[:, :PROMPT]), torch.from_numpy(
            toks[:, :PROMPT])
    hand = {}
    if pc.is_encoder_decoder:
        e = rng.normal(size=(2, pc.encoder_seq, pc.d_model)).astype(np.float32)
        rk["enc_embeds"], pk["enc_embeds"] = jnp.asarray(e), torch.from_numpy(e)
        hand["enc_embeds"] = torch.from_numpy(e)
    prompts = [rng.integers(1, pc.vocab, n).tolist() for n in GEN_LENS]
    if pc.embed_inputs and not pc.is_encoder_decoder:
        hand["embeds"] = [torch.from_numpy(rng.normal(size=(n, pc.d_model)).astype(np.float32))
                          for n in GEN_LENS]
        prompts = None
    return {"rc": rc, "rp": rp, "rk": rk, "toks": toks,
            "port": {"cfg": pc, "params": pp, "kw": pk, "prompt_len": PROMPT,
                     "decode": [torch.from_numpy(toks[:, PROMPT + t:PROMPT + t + 1])
                                for t in range(N_DECODE)],
                     "prompts": prompts, "hand": hand, "max_new": GEN_NEW,
                     "serve": name == "llama3_8b"}}


def _train_inputs():
    """llama3_8b's smoke config (kv 2: split at model 2) for the (2, 2)
    step and tinyllama_1_1b's (kv 2 of 8 heads: replicated at model 4, each
    rank projecting the KV head its queries read) for the (1, 4) step, with
    a grad_clip at CLIP_SHARE of the first config's gradient norm."""
    rc, pc = _pair("llama3_8b")
    rc14, pc14 = _pair("tinyllama_1_1b")
    rp, rp14 = _ref_init(rc), _ref_init(rc14)
    pp = convert.params_from_reference(_np(rp), pc, "cpu")
    pp14 = convert.params_from_reference(_np(rp14), pc14, "cpu")
    tokens = np.random.default_rng(5).integers(0, min(pc.vocab, pc14.vocab),
                                               (TRAIN_BATCH, TRAIN_SEQ + 1))
    batch = {"tokens": torch.from_numpy(tokens[:, :-1]).int(),
             "labels": torch.from_numpy(tokens[:, 1:]).int()}
    _, _, grads = step.grads_fn(pc, pp, batch, N_MICRO)
    norm = float(adamw.global_norm(grads))
    opt_cfg = adamw.AdamWConfig(division=pc.division, grad_clip=CLIP_SHARE * norm)
    return {"cfg": pc, "cfg14": pc14, "params": pp, "params14": pp14, "batch": batch,
            "opt_cfg": opt_cfg, "n_micro": N_MICRO, "norm": norm, "tokens": tokens,
            "ref": {"2x2": (rc, rp), "1x4": (rc14, rp14)}}


XLA_REF = r"""
import dataclasses, os, sys
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
for mesh_name, arch, shape in (("2x2", "llama3_8b", (2, 2)), ("1x4", "tinyllama_1_1b", (1, 4))):
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                              division=DivisionConfig(mode="taylor_pallas", schedule="paper"))
    opt_cfg = adamw.AdamWConfig(division=cfg.division, grad_clip=float(d["grad_clip"]))
    like = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(like), [
        jnp.asarray(d[f"{mesh_name}_param_{i}"])
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
    out[f"{mesh_name}_loss"] = np.float32(metrics["loss"])
    for name, t in (("params", new.params), ("m", new.opt.m), ("v", new.opt.v)):
        for i, leaf in enumerate(jax.tree_util.tree_leaves(t)):
            out[f"{mesh_name}_{name}_{i}"] = np.asarray(leaf)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cases = {name: _case(name) for name in CASES}
    train = _train_inputs()
    d = tmp_path_factory.mktemp("xla_tp")
    np.savez(d / "in.npz", tokens=train["tokens"], grad_clip=train["opt_cfg"].grad_clip,
             **{f"{m}_param_{i}": np.asarray(a, np.float32)
                for m, (_, rp) in train["ref"].items()
                for i, a in enumerate(jax.tree_util.tree_leaves(rp))})
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    xla = subprocess.Popen([sys.executable, "-c", XLA_REF, str(d / "in.npz"),
                            str(d / "out.npz")], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, cwd=root,
                           env={**os.environ, "PYTHONPATH": "src"})
    ssm = {}
    for arch in SSM_ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32")
        ssm[arch] = (cfg, init_params(cfg, torch.Generator().manual_seed(0)),
                     torch.arange(16, dtype=torch.int64)[None] % cfg.vocab)
    draw_cfg = _pair("llama3_8b")[1]
    ckpt = str(tmp_path_factory.mktemp("tp_ckpt"))
    inp = {"cases": {n: c["port"] for n, c in cases.items()},
           "train": {k: train[k] for k in ("cfg", "cfg14", "params", "params14", "batch",
                                           "opt_cfg", "n_micro")},
           "ssm": ssm, "ckpt_dir": ckpt,
           "draws": {"cfg": draw_cfg, "seed": 3, "reference": _np(train["ref"]["2x2"][1])}}
    try:
        ranks = run_ranks(_torch_mesh.tp_rank, N_RANKS, inp, device_type="cpu",
                          timeout_s=DEADLINE_S)
        stdout, stderr = xla.communicate(timeout=DEADLINE_S)
    finally:
        if xla.poll() is None:
            xla.kill()
    assert xla.returncode == 0, stderr[-3000:]
    return {"cases": cases, "train": train, "ranks": ranks, "ckpt": ckpt,
            "xla": dict(np.load(d / "out.npz")), "draw_cfg": draw_cfg, "ssm": ssm}


# ----------------------------------------------------------------- helpers

class _Sizes:
    """A mesh's sizes, for ``rules.model_dims``."""

    def __init__(self, mesh_name):
        self.shape = {"data": 2 if mesh_name == "2x2" else 1, "model": MESHES[mesh_name]}


def _dims(cfg, mesh_name):
    """Each leaf's dim on 'model' (None: replicated), in leaf order."""
    return tree.leaves(shr.model_dims(cfg, _Sizes(mesh_name)))


def _blocks(cfg, mesh_name, leaves_of_ranks):
    """Each leaf's global tensor from the blocks of one model group (in
    model order): put side by side along its dim on 'model'."""
    dims = _dims(cfg, mesh_name)
    out = []
    for i, parts in enumerate(zip(*leaves_of_ranks)):
        out.append(parts[0] if dims[i] is None else torch.cat(parts, dims[i]))
    return out


def _model_ranks(mesh_name: str, rank_pair: int = 0):
    """The ranks of one model group of ``mesh_name``, in model order."""
    return {"1x4": [0, 1, 2, 3], "2x2": [0, 1], "1x2": [2 * rank_pair, 2 * rank_pair + 1]}[
        mesh_name]


def _gather(parts, full: int):
    """The ranks' vocab blocks side by side (a block of ``full`` columns
    already holds all of them)."""
    if parts[0].shape[-1] == full:
        assert all(torch.equal(p, parts[0]) for p in parts)
        return parts[0]
    return torch.cat(parts, -1)


def _close(got: torch.Tensor, want):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= LOGIT_RTOL, rel
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.fixture(scope="module")
def reference(run):
    """Each case's reference logits: train, prefill, and the decode steps
    from the prefill's cache, padded to the decode length."""
    out = {}
    for name, c in run["cases"].items():
        rc, rp, rk = c["rc"], c["rp"], c["rk"]
        train, _, _ = ref_forward(rc, rp, mode="train", **rk)
        prefill, cache, _ = ref_forward(rc, rp, mode="prefill", **rk)
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


def _forward_runs(run, name, mesh_name):
    """(model group's outputs, pair index) of a case on a mesh; a (1, 2)
    case ran on one of the two pairs."""
    ranks = run["ranks"]
    pair = list(CASES).index(name) % 2 if mesh_name == "1x2" else 0
    return [ranks[r]["forward"][name, mesh_name] for r in _model_ranks(mesh_name, pair)]


# ------------------------------------------------------------------ forward

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", list(CASES))
def test_forward_logits_are_the_references(run, reference, name, mesh_name):
    """Train and prefill logits and two decode steps from the prefill's
    cache, the ranks' vocab blocks side by side, against the reference's
    unsharded forward: within LOGIT_RTOL of the largest logit, the same
    argmax everywhere."""
    want = reference[name]
    outs = _forward_runs(run, name, mesh_name)
    V = run["cases"][name]["rc"].vocab
    for what in ("train", "prefill"):
        _close(_gather([o[what] for o in outs], V), want[what])
    for t in range(N_DECODE):
        _close(_gather([o["decode"][t] for o in outs], V), want["decode"][t])


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_data_peers_compute_the_same_forward(run, mesh_name):
    """On (2, 2) the data rows' model groups run the same forward: their
    logits are bit-equal; every rank's cache holds its KV heads."""
    ranks = run["ranks"]
    for name in CASES:
        cfg = run["cases"][name]["port"]["cfg"]
        m = MESHES[mesh_name]
        for r in _model_ranks(mesh_name, list(CASES).index(name) % 2
                              if mesh_name == "1x2" else 0):
            o = ranks[r]["forward"][name, mesh_name]
            heads_split = cfg.n_heads % m == 0
            kv = (cfg.n_kv_heads // m if cfg.n_kv_heads % m == 0 else
                  -(-cfg.n_heads // m // cfg.q_per_kv) if heads_split else cfg.n_kv_heads)
            assert o["cache_kv_heads"] == {kv}, (name, mesh_name, o["cache_kv_heads"])
        if mesh_name == "2x2":
            for a, b in ((0, 2), (1, 3)):
                x, y = ranks[a]["forward"][name, "2x2"], ranks[b]["forward"][name, "2x2"]
                assert torch.equal(x["prefill"], y["prefill"])
                assert all(torch.equal(u, v) for u, v in zip(x["decode"], y["decode"]))


# --------------------------------------------------------------- greedy tokens

@pytest.fixture(scope="module")
def unsharded_tokens(run):
    out = {}
    for name, c in run["cases"].items():
        p = c["port"]
        eng = ServingEngine(p["cfg"], p["params"], max_len=64)
        out[name] = eng.generate_batch(p["prompts"], p["max_new"], **p["hand"])
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_greedy_tokens_are_the_unsharded_runs(run, unsharded_tokens, name):
    """f32 generate_batch on (1, 4) (the split argmax over vocab blocks)
    gives the unsharded engine's tokens on every rank."""
    for out in run["ranks"]:
        assert out["generate"][name]["batch"] == unsharded_tokens[name]


def test_serve_under_tensor_parallelism_is_generate_batch(run, unsharded_tokens):
    for out in run["ranks"]:
        assert out["generate"]["llama3_8b"]["serve"] == unsharded_tokens["llama3_8b"]


def test_split_argmax_takes_the_lowest_index_of_a_tie():
    """Ties across vocab blocks: the first rank's maximum wins, as
    torch.argmax takes the first; checked on the blocks of one tensor."""
    from repro_torch.serving.engine import greedy

    class _Plan:
        vocab, mesh = True, None

        def __init__(self, rank):
            self.rank = rank

        def vocab_offset(self, n):
            return self.rank * n

    logits = torch.tensor([[0.0, 3.0, 1.0, 3.0, 3.0, 2.0], [5.0, 1.0, 1.0, 1.0, 2.0, 5.0]])
    blocks = logits.split(2, -1)
    pairs = []
    with mock.patch("repro_torch.sharding.comm.all_gather",
                    lambda t, mesh, axes, dim=0: torch.cat(pairs, 0)):
        for r, b in enumerate(blocks):
            idx = torch.argmax(b, -1)
            pairs.append(torch.stack([b.gather(-1, idx[:, None])[:, 0].double(),
                                      (idx + 2 * r).double()])[None])
        got = greedy(blocks[2], _Plan(2))
    assert got[:, 0].tolist() == torch.argmax(logits, -1).tolist() == [1, 0]


# ---------------------------------------------------------------- training

def _single_step(run, mesh_name):
    t = run["train"]
    cfg, params = (t["cfg"], t["params"]) if mesh_name == "2x2" else (t["cfg14"], t["params14"])
    state = step.init_state(cfg, params, t["opt_cfg"])
    new, metrics = step.train_step(cfg, t["opt_cfg"], state, t["batch"], n_micro=N_MICRO)
    return cfg, new, float(metrics["loss"])


def _assembled(run, mesh_name, what):
    """The ranks' new blocks of ``what`` (params, m, v) as global tensors."""
    t = run["train"]
    cfg = t["cfg"] if mesh_name == "2x2" else t["cfg14"]
    return _blocks(cfg, mesh_name, [run["ranks"][r]["train"][mesh_name][what]
                                    for r in _model_ranks(mesh_name)])


def _within(got, want, rtol):
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= rtol * float(w.abs().max())


@pytest.mark.parametrize("mesh_name", ["2x2", "1x4"])
@pytest.mark.parametrize("what", ["loss", "params", "m", "v"])
def test_train_step_is_the_references_gspmd_step(run, mesh_name, what):
    """The tensor-parallel step against the reference's train_step under
    GSPMD on the same mesh (4 XLA devices), with the gradients clipped
    (grad_clip at half their norm): the loss within 1e-5, m and v within
    1e-5 and the parameters within 1e-4 of each leaf's largest value."""
    xla = run["xla"]
    if what == "loss":
        for r in range(N_RANKS):
            assert abs(run["ranks"][r]["train"][mesh_name]["loss"]
                       - float(xla[f"{mesh_name}_loss"])) <= 1e-5
        return
    rc, rp = run["train"]["ref"][mesh_name]
    cfg = run["train"]["cfg"] if mesh_name == "2x2" else run["train"]["cfg14"]
    like = jax.tree_util.tree_structure(rp)
    ref_leaves = [xla[f"{mesh_name}_{what}_{i}"] for i in range(like.num_leaves)]
    want = tree.leaves(convert.params_from_reference(
        jax.tree_util.tree_unflatten(like, ref_leaves), cfg, "cpu"))
    _within(_assembled(run, mesh_name, what), want, 1e-4 if what == "params" else 1e-5)


@pytest.mark.parametrize("mesh_name", ["2x2", "1x4"])
@pytest.mark.parametrize("what", ["loss", "params", "m", "v"])
def test_train_step_is_the_single_process_step(run, mesh_name, what):
    """The same step against the port's single-process step on the whole
    batch, at the same tolerances."""
    cfg, new, loss = _single_step(run, mesh_name)
    if what == "loss":
        assert abs(run["ranks"][0]["train"][mesh_name]["loss"] - loss) <= 1e-5
        return
    want = tree.leaves({"params": new.params, "m": new.opt.m, "v": new.opt.v}[what])
    _within(_assembled(run, mesh_name, what), want, 1e-4 if what == "params" else 1e-5)


@pytest.mark.parametrize("mesh_name", ["2x2", "1x4"])
def test_the_split_global_norm_clips_as_the_whole_one(run, mesh_name):
    """The first moments are (1 - b1) * clip * g, with clip = grad_clip /
    |g| below 1 and |g| the single process's norm of the whole gradient
    tree: the ranks' split sums of squares give every rank that factor."""
    t = run["train"]
    cfg, params = (t["cfg"], t["params"]) if mesh_name == "2x2" else (t["cfg14"], t["params14"])
    _, _, grads = step.grads_fn(cfg, params, t["batch"], N_MICRO)
    norm = float(adamw.global_norm(grads))
    clip = t["opt_cfg"].grad_clip / (norm + 1e-9)
    assert clip < 0.9
    want = [(1 - t["opt_cfg"].b1) * clip * g for g in tree.leaves(grads)]
    _within(_assembled(run, mesh_name, "m"), want, 1e-5)


@pytest.mark.parametrize("mesh_name", ["2x2", "1x4"])
def test_replicated_leaves_are_bit_equal_on_every_rank(run, mesh_name):
    """After the step every replicated leaf (norms, a replicated kv
    projection) has the same bits on all 4 ranks, and each split block the
    same bits on its data peers; the state stays DTensors."""
    ranks = [r["train"][mesh_name] for r in run["ranks"]]
    cfg = run["train"]["cfg"] if mesh_name == "2x2" else run["train"]["cfg14"]
    split = [d is not None for d in _dims(cfg, mesh_name)]
    bits = lambda t: t.view(torch.int32)
    for what in ("params", "m", "v"):
        for i, is_split in enumerate(split):
            leaves = [bits(o[what][i]) for o in ranks]
            if not is_split:
                assert all(torch.equal(x, leaves[0]) for x in leaves), (what, i)
            elif mesh_name == "2x2":
                assert torch.equal(leaves[0], leaves[2]) and torch.equal(leaves[1], leaves[3])
    assert 0 < sum(split) < len(split) and all(o["dtensors"] for o in ranks)


# --------------------------------------------------------------- checkpoints

def test_a_tensor_parallel_checkpoint_holds_the_global_values(run):
    """The (2, 2) step's DTensor state, saved by every rank (one writes):
    the port's restore in this process and the reference's give the
    ranks' blocks put together, bit for bit."""
    t = run["train"]
    cfg = t["cfg"]
    like_state = step.init_state(cfg, t["params"], t["opt_cfg"])
    got = checkpoint.restore(run["ckpt"], 1, like_state)
    want = {w: _assembled(run, "2x2", w) for w in ("params", "m", "v")}
    for w, g in (("params", got.params), ("m", got.opt.m), ("v", got.opt.v)):
        assert all(torch.equal(a, b) for a, b in zip(tree.leaves(g), want[w]))
    assert int(got.step) == 1 and int(got.opt.step) == 1
    theirs = ref_checkpoint.restore(run["ckpt"], 1, _np(tree.map_tree(
        lambda x: x.numpy(), like_state)))
    for a, b in zip(jax.tree_util.tree_leaves(theirs), tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(a).reshape(b.shape), b.numpy())


# ------------------------------------------------------------------ placement

def test_a_rank_draws_and_converts_only_its_blocks(run):
    """init_params(shardings=) on each rank of (2, 2) keeps its block of the
    values this process draws whole from the same seed, and
    params_from_reference(shardings=) its block of the reference's: put
    together, each model group's blocks are the whole tree."""
    cfg = run["draw_cfg"]
    want = {"init": tree.leaves(init_params(cfg, torch.Generator().manual_seed(3))),
            "convert": tree.leaves(convert.params_from_reference(
                _np(run["train"]["ref"]["2x2"][1]), cfg, "cpu"))}
    for what, whole in want.items():
        for group in ((0, 1), (2, 3)):
            got = _blocks(cfg, "2x2", [run["ranks"][r]["draws"][what] for r in group])
            assert all(torch.equal(a, b) for a, b in zip(got, whole))
    assert any("Shard" in str(p) for p in run["ranks"][0]["draws"]["placements"])


# ------------------------------------------------------------- Mamba-2 layers

@pytest.mark.parametrize("arch", list(SSM_ARCHS))
def test_ssm_and_moe_layers_refuse_a_model_axis(run, arch):
    """Until ROADMAP Queue 1 item 22 Mamba-2 layers under a model axis
    raised a ValueError here; now they run split by heads. Under model = 2
    (both model groups of the (2, 2) mesh) mamba2's and jamba's logits,
    the ranks' vocab blocks side by side, are the unsharded port's within
    LOGIT_RTOL, with the same argmax (tests/test_torch_ssm_parallel.py holds
    the split mixer to the reference)."""
    cfg, params, toks = run["ssm"][arch]
    with torch.no_grad():
        want, _, _ = forward(cfg, params, tokens=toks)
    for group in ((0, 1), (2, 3)):
        _close(_gather([run["ranks"][r]["ssm"][arch] for r in group], cfg.vocab), want.numpy())
