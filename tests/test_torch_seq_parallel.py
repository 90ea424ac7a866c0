"""The sequence on ``model`` and ``data``: Megatron sequence parallelism
(``seq_shard``), the decode cache split by sequence over ``model``
(``kvseq``) and, at batch 1, over ``data``, on 4 gloo ranks, held against
the reference under the same layouts.

One module-scoped fixture runs ``_torch_mesh.seq_rank`` on 4 CPU ranks once
(``launch.mesh.run_ranks``, one torch thread each) over (data 2, model 2)
and the two (data 1, model 2) meshes of ranks {0, 1} and {2, 3}.
Meanwhile one 4-device XLA subprocess runs the reference under GSPMD with
the same rules and the same parameters (``_ref_params.ref_init``): its
``seq_shard`` forwards and train steps (``__seq_shard__: model``), and its
prefill and decode steps with the cache placed by its own
``launch.dryrun._cache_shardings`` (``__kv_seq_shard__: model``, or a batch
of 1, whose cache's sequence lies on ``data``).

Every case in f32 with the division unit in ``taylor_pallas``. The layouts
change the order of sums only, so the bounds are the tensor-parallel
tests': logits within ``LOGIT_RTOL`` (1e-5) of the largest logit (measured
on an 8-core CPU: up to 5.0e-6, jamba under seq_shard; 2.4e-6 in decode),
the train step within ``test_torch_tensor_parallel.py``'s
step tolerances (``TP_STEP_RTOL``: the parameters 1e-4, m and v 1e-5 of
each leaf's largest value, the loss 1e-5; measured for llama3_8b: 9.4e-6,
1.2e-6, 2.4e-6), greedy tokens exactly. jamba's step, whose Mamba-2
leaves sum in another order, is held to ``test_torch_fsdp.py``'s bounds
for the same model (``SSM_STEP_RTOL``; measured: m 2.0e-5, v 4.0e-5, the
parameters 1.9e-7 where the first moment resolves the gradient's sign).
``make_cache`` on rank 0 of the production meshes is held against the
reference's cache shardings leaf by leaf.
"""
import dataclasses
import json
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
from repro_torch import convert, tree
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.core.division_modes import DivisionConfig
from repro_torch.launch.mesh import run_ranks
from repro_torch.optim import adamw
from repro_torch.serving import ServingEngine
from repro_torch.train import step
import _torch_mesh
from _ref_params import ref_init
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

N_RANKS = 4
DEADLINE_S = 300.0
LOGIT_RTOL = 1e-5
TP_STEP_RTOL = {"params": 1e-4, "m": 1e-5, "v": 1e-5}
MODE = "taylor_pallas"
SEQ = {"__seq_shard__": "model"}
KVSEQ = {"__kv_seq_shard__": "model"}
PROMPT = 32
N_DECODE = 3
MAX_LEN = 64
# (arch, mesh): seq_shard forwards of a (2, PROMPT) prompt.
SEQ_CASES = (("llama3_8b", "2x2"), ("llama3_8b", "1x2"), ("jamba_1_5_large", "2x2"),
             ("whisper_tiny", "2x2"))
# name: (arch, rules, batch, prompt length, greedy prompt lengths, cache
# slots). The llama3 prompt of 30 tokens decodes across the boundary of the
# model ranks' slot blocks (32); at batch 1 the data rank holding slots
# 32..63 has every slot masked (a fully-masked rank); gemma3's rings split
# too. gemma3's 63 slots at batch 1 do not split over data: the reference
# holds them whole, the port rounds them up to 64 (the slot past 62 never
# valid).
DECODE_CASES = {
    "llama3_8b_kvseq": ("llama3_8b", KVSEQ, 2, 30, (13, 7), MAX_LEN),
    "gemma3_12b_kvseq": ("gemma3_12b", KVSEQ, 2, PROMPT, (20, 9), MAX_LEN),
    "whisper_tiny_kvseq": ("whisper_tiny", KVSEQ, 2, 16, None, MAX_LEN),
    "gemma3_12b_batch1": ("gemma3_12b", {}, 1, 16, (11,), MAX_LEN - 1),
    "jamba_1_5_large_batch1": ("jamba_1_5_large", {}, 1, PROMPT, (21,), MAX_LEN),
}
GEN_NEW = 5
# name: (arch, rules, batch, cache slots): the reference's prefill cache of
# a PROMPT prompt, carried across whole and cut by convert.cache_block on
# (2, 2).
CARRY_CASES = {"gemma3_12b_kvseq": ("gemma3_12b", KVSEQ, 2, MAX_LEN),
               "gemma3_12b_batch1": ("gemma3_12b", {}, 1, MAX_LEN - 1)}
TRAIN_BATCH, TRAIN_SEQ, N_MICRO = 8, 32, 2
STEP_ARCHS = ("llama3_8b", "jamba_1_5_large")      # seq_shard train steps on (2, 2)
# jamba's step differs from the reference's by the Mamba-2 leaves' sum
# order: the bounds of test_torch_fsdp.py for the same model's GSPMD step
# (m and v 2e-4 of each leaf's largest value; the parameters 1e-4 of it
# where the reference's first moment resolves the gradient's sign, and
# 2 lr elsewhere: such a lane moves by +-lr).
SSM_STEP_ARCHS = ("jamba_1_5_large",)
SSM_STEP_RTOL = {"params": 1e-4, "m": 2e-4, "v": 2e-4}


def _pair(arch, rules):
    """The reference's and the port's smoke configs of ``arch`` in f32 with
    the full config's rules and ``rules``."""
    div = dict(mode=MODE, schedule="paper")
    r = {**ref_get_config(arch).sharding_rules, **rules}
    ref = dataclasses.replace(ref_smoke_config(arch), param_dtype="float32",
                              division=RefDivisionConfig(**div), sharding_rules=r)
    port = dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                               division=DivisionConfig(**div), sharding_rules=r)
    return ref, port


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _inputs():
    """The ranks' inputs, and the XLA subprocess's spec and arrays."""
    spec, arrays = {"seq": [], "decode": [], "step": None}, {}
    params = {}

    def draw(arch, rules, key):
        rc, pc = _pair(arch, rules)
        rp = ref_init(rc)
        for i, a in enumerate(jax.tree_util.tree_leaves(rp)):
            arrays[f"{key}_param_{i}"] = np.asarray(a, np.float32)
        return rp, pc, convert.params_from_reference(_np(rp), pc, "cpu")

    seq = {}
    for arch, mesh_name in SEQ_CASES:
        if arch not in params:
            params[arch] = draw(arch, SEQ, f"seq_{arch}")
        _, pc, pp = params[arch]
        toks = np.random.default_rng(zlib.crc32(arch.encode())).integers(0, pc.vocab,
                                                                         (2, PROMPT))
        arrays[f"seq_{arch}_{mesh_name}_tokens"] = toks
        kw = {"tokens": torch.from_numpy(toks)}
        if pc.is_encoder_decoder:
            e = np.random.default_rng(7).normal(size=(2, pc.encoder_seq, pc.d_model))
            arrays[f"seq_{arch}_{mesh_name}_enc"] = e.astype(np.float32)
            kw["enc_embeds"] = torch.from_numpy(e.astype(np.float32))
        spec["seq"].append([arch, mesh_name])
        seq[arch, mesh_name] = {"cfg": pc, "params": pp, "kw": kw}
    decode = {}
    for name, (arch, rules, B, s, gen, slots) in DECODE_CASES.items():
        _, pc, pp = draw(arch, rules, name)
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        toks = rng.integers(0, pc.vocab, (B, s + N_DECODE))
        arrays[f"{name}_tokens"] = toks
        kw = {"tokens": torch.from_numpy(toks[:, :s])}
        hand = {}
        if pc.is_encoder_decoder:
            e = rng.normal(size=(B, pc.encoder_seq, pc.d_model)).astype(np.float32)
            arrays[f"{name}_enc"] = e
            kw["enc_embeds"] = hand["enc_embeds"] = torch.from_numpy(e)
        spec["decode"].append([name, arch, rules, B, s, slots])
        decode[name] = {"cfg": pc, "params": pp, "kw": kw, "prompt_len": s, "max_len": slots,
                        "decode": [torch.from_numpy(toks[:, s + t:s + t + 1])
                                   for t in range(N_DECODE)],
                        "prompts": None if gen is None else [
                            rng.integers(1, pc.vocab, n).tolist() for n in gen],
                        "max_new": GEN_NEW, "hand": hand}
    st, spec["step"], spec["like"] = {}, {"n_micro": N_MICRO, "archs": list(STEP_ARCHS)}, {}
    for arch in STEP_ARCHS:
        rp, pc, pp = draw(arch, SEQ, f"step_{arch}")
        tokens = np.random.default_rng(5).integers(0, pc.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1))
        arrays[f"step_{arch}_tokens"] = tokens
        batch = {"tokens": torch.from_numpy(tokens[:, :-1]).int(),
                 "labels": torch.from_numpy(tokens[:, 1:]).int()}
        _, _, grads = step.grads_fn(pc, pp, batch, N_MICRO)
        clip = 0.5 * float(adamw.global_norm(grads))
        arrays[f"step_{arch}_clip"] = np.float64(clip)
        opt_cfg = adamw.AdamWConfig(division=pc.division, grad_clip=clip)
        st[arch] = {"cfg": pc, "params": pp, "batch": batch, "opt_cfg": opt_cfg,
                    "n_micro": N_MICRO}
        spec["like"][arch] = jax.tree_util.tree_structure(rp)
    carry = {}
    for name, (arch, rules, B, slots) in CARRY_CASES.items():
        rc, pc = _pair(arch, rules)
        toks = np.random.default_rng(zlib.crc32(name.encode())).integers(0, pc.vocab,
                                                                         (B, PROMPT))
        _, cache, _ = ref_forward(rc, ref_init(rc), tokens=jnp.asarray(toks), mode="prefill")
        carry[name] = {"cfg": pc, "cache": convert.cache_from_reference(_np(cache), pc, "cpu"),
                       "max_len": slots, "batch": B}
    return {"seq_shard": seq, "decode": decode, "step": st, "carry": carry}, spec, arrays


XLA_REF = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, get_smoke_config
from repro.configs.base import ShapeConfig
from repro.core.division_modes import DivisionConfig
from repro.launch.dryrun import _cache_shardings
from repro.launch.mesh import _axis_type_kwargs
from repro.models import forward, init_params
from repro.optim import adamw
from repro.serving import pad_cache_to
from repro.sharding import rules
from repro.train import step

d = np.load(sys.argv[1])
spec = json.loads(sys.argv[3])
out = {}


def config(arch, extra):
    return dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                               division=DivisionConfig(mode="taylor_pallas", schedule="paper"),
                               sharding_rules={**get_config(arch).sharding_rules, **extra})


def params_of(cfg, key):
    like = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(like), [
        jnp.asarray(d[f"{key}_param_{i}"]) for i in range(len(jax.tree_util.tree_leaves(like)))])


def mesh_of(name):
    shape = {"2x2": (2, 2), "1x2": (1, 2)}[name]
    devs = np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    return jax.sharding.Mesh(devs, ("data", "model"), **_axis_type_kwargs(2))


SEQ = {"__seq_shard__": "model"}
for arch, mesh_name in spec["seq"]:
    cfg = config(arch, SEQ)
    mesh = mesh_of(mesh_name)
    p = jax.device_put(params_of(cfg, f"seq_{arch}"), rules.param_shardings(cfg, mesh))
    toks = jnp.asarray(d[f"seq_{arch}_{mesh_name}_tokens"], jnp.int32)
    kw = ({"enc_embeds": jnp.asarray(d[f"seq_{arch}_{mesh_name}_enc"])}
          if cfg.is_encoder_decoder else {})
    with rules.use_mesh(mesh), jax.set_mesh(mesh):
        for mode in ("train", "prefill"):
            logits = jax.jit(lambda p_, t_, kw_: forward(cfg, p_, tokens=t_, mode=mode,
                                                         **kw_)[0])(p, toks, kw)
            out[f"seq_{arch}_{mesh_name}_{mode}"] = np.asarray(logits)

mesh = mesh_of("2x2")
for name, arch, extra, B, s, slots in spec["decode"]:
    cfg = config(arch, extra)
    p = jax.device_put(params_of(cfg, name), rules.param_shardings(cfg, mesh))
    toks = jnp.asarray(d[f"{name}_tokens"], jnp.int32)
    kw = {"enc_embeds": jnp.asarray(d[f"{name}_enc"])} if cfg.is_encoder_decoder else {}
    with rules.use_mesh(mesh), jax.set_mesh(mesh):
        _, cache, _ = jax.jit(lambda p_, t_, kw_: forward(cfg, p_, tokens=t_, mode="prefill",
                                                          **kw_))(p, toks[:, :s], kw)
        cache = pad_cache_to(cache, s, slots, cfg)
        _, sh = _cache_shardings(cfg, ShapeConfig("decode", "decode", slots, B), mesh)
        cache = jax.device_put(cache, sh)
        dec = jax.jit(lambda p_, c_, t_, pos: forward(cfg, p_, tokens=t_, cache=c_, pos=pos,
                                                      mode="decode"))
        for t in range({n_decode}):
            logits, cache, _ = dec(p, cache, toks[:, s + t:s + t + 1], jnp.int32(s + t))
            out[f"{name}_decode_{t}"] = np.asarray(logits)

for arch in spec["step"]["archs"]:
    cfg = config(arch, SEQ)
    opt_cfg = adamw.AdamWConfig(division=cfg.division, grad_clip=float(d[f"step_{arch}_clip"]))
    state = step.init_state(cfg, jax.device_put(params_of(cfg, f"step_{arch}"),
                                                rules.param_shardings(cfg, mesh)), opt_cfg)
    tokens = jnp.asarray(d[f"step_{arch}_tokens"], jnp.int32)
    batch = jax.device_put({"tokens": tokens[:, :-1], "labels": tokens[:, 1:]},
                           rules.data_sharding(mesh, 2))
    with rules.use_mesh(mesh), jax.set_mesh(mesh):
        new, metrics = jax.jit(lambda s_, b_: step.train_step(
            cfg, opt_cfg, s_, b_, n_micro=spec["step"]["n_micro"]))(state, batch)
    out[f"step_{arch}_loss"] = np.float32(metrics["loss"])
    for what, t in (("params", new.params), ("m", new.opt.m), ("v", new.opt.v)):
        for i, leaf in enumerate(jax.tree_util.tree_leaves(t)):
            out[f"step_{arch}_{what}_{i}"] = np.asarray(leaf)
np.savez(sys.argv[2], **out)
""".replace("{n_decode}", str(N_DECODE))


def _unsharded_tokens(decode) -> dict:
    """Greedy tokens of each decode case's prompts from the unsharded port."""
    out = {}
    for name, c in decode.items():
        if c["prompts"] is not None:
            eng = ServingEngine(c["cfg"], c["params"], max_len=c["max_len"])
            out[name] = eng.generate_batch(c["prompts"], c["max_new"], **c["hand"])
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    inp, spec, arrays = _inputs()
    d = tmp_path_factory.mktemp("xla_seq")
    like = spec.pop("like")
    np.savez(d / "in.npz", **arrays)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    xla = subprocess.Popen([sys.executable, "-c", XLA_REF, str(d / "in.npz"),
                            str(d / "out.npz"), json.dumps(spec)], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, cwd=root,
                           env={**os.environ, "PYTHONPATH": "src"})
    try:
        ranks = run_ranks(_torch_mesh.seq_rank, N_RANKS, inp, device_type="cpu",
                          timeout_s=DEADLINE_S)
        tokens = _unsharded_tokens(inp["decode"])
        stderr = xla.communicate(timeout=DEADLINE_S)[1]
    finally:
        if xla.poll() is None:
            xla.kill()
    assert xla.returncode == 0, stderr[-3000:]
    return {"inp": inp, "ranks": ranks, "tokens": tokens, "like": like,
            "ref": dict(np.load(d / "out.npz"))}


def _vocab(ranks, pick):
    """The logits of data row 0's two model ranks (0 and 1), their vocab
    blocks side by side."""
    return torch.cat([pick(ranks[r]) for r in (0, 1)], -1)


def _close(got, want, rtol=LOGIT_RTOL):
    want = torch.as_tensor(want)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= rtol, f"off by {err} of the largest logit"
    return err


@pytest.mark.parametrize("arch,mesh_name", SEQ_CASES)
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_seq_shard_logits_are_the_references(run, arch, mesh_name, mode):
    """Train and prefill logits under seq_shard, against the reference's
    GSPMD forward under ``__seq_shard__`` (whisper: the cross attention's
    queries gathered, its K/V from the whole encoder output); each block
    saw half the sequence."""
    ranks = run["ranks"]
    for pair in ((0, 1), (2, 3)):
        got = torch.cat([ranks[r]["seq_shard"][arch, mesh_name][mode] for r in pair], -1)
        _close(got, run["ref"][f"seq_{arch}_{mesh_name}_{mode}"])
    cfg = run["inp"]["seq_shard"][arch, mesh_name]["cfg"]
    # The encoder's blocks run whole (the reference splits the decoder's).
    want = sorted({PROMPT // 2} | ({cfg.encoder_seq} if cfg.is_encoder_decoder else set()))
    assert all(o["seq_shard"][arch, mesh_name]["rows"] == want for o in ranks)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_seq_shard_train_step_is_the_references_gspmd_step(run, arch):
    """One seq_shard train step on (2, 2) (2 microbatches a data rank,
    grad_clip at half the gradients' norm) against the reference's GSPMD
    step under ``__seq_shard__``; remat on and off give the same
    gradients bit for bit. jamba runs the backward of the whole-compute
    branches: the Mamba-2 mixer and the MoE FFN on the gathered sequence,
    its FSDP blocks gathered over data."""
    ref, got = run["ref"], run["ranks"][0]["step"][arch]
    loss = float(ref[f"step_{arch}_loss"])
    assert abs(got["loss"] - loss) <= 1e-5 * abs(loss)
    like, cfg = run["like"][arch], run["inp"]["step"][arch]["cfg"]
    want = {what: tree.leaves(convert.params_from_reference(jax.tree_util.tree_unflatten(
        like, [ref[f"step_{arch}_{what}_{i}"] for i in range(like.num_leaves)]), cfg, "cpu"))
        for what in TP_STEP_RTOL}
    bounds = SSM_STEP_RTOL if arch in SSM_STEP_ARCHS else TP_STEP_RTOL
    lr = run["inp"]["step"][arch]["opt_cfg"].lr
    for what, tol in bounds.items():
        for i, (g, w) in enumerate(zip(got["state"][what], want[what])):
            d, top = (g - w).abs(), float(w.abs().max())
            if what == "params" and arch in SSM_STEP_ARCHS:
                m = want["m"][i]
                assert float(d.max()) <= 2 * lr + tol * top, (what, i)
                d = torch.where(m.abs() > bounds["m"] * float(m.abs().max()), d, 0)
            assert float(d.max()) <= tol * top, (what, i)
    assert all(o["step"][arch]["remat_bit_equal"] for o in run["ranks"])


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_split_cache_decode_is_the_references(run, name):
    """Teacher-forced decode steps from the prefill's cache cut to the
    rank's blocks, against the reference's decode with its cache placed by
    its own cache shardings: logits, and their greedy tokens exactly; no
    nan on a rank whose slots are all masked."""
    ranks = run["ranks"]
    for t in range(N_DECODE):
        got = _vocab(ranks, lambda o: o["decode"][name]["decode"][t])
        want = run["ref"][f"{name}_decode_{t}"]
        _close(got, want)
        assert torch.equal(torch.argmax(got, -1), torch.from_numpy(want.argmax(-1)))
    assert not any(o["decode"][name]["nan"] for o in ranks)


@pytest.mark.parametrize("name", [n for n, c in DECODE_CASES.items() if c[4]])
def test_split_cache_greedy_tokens_are_the_unsharded_runs(run, name):
    """generate_batch with the cache split by sequence (the prefill's cut
    by ``convert.cache_block``) chooses the unsharded port's tokens."""
    for o in run["ranks"]:
        assert o["decode"][name]["generate"] == run["tokens"][name]


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_the_rank_holds_its_block_of_slots(run, name):
    """Each K/V leaf holds MAX_LEN / 2 slots (63 rounded up to 64 and
    halved; the window / 2 for a ring, ``encoder_seq`` / 2 for cross K/V),
    with every KV head under kvseq and the rank's KV heads at batch 1."""
    arch, rules, B, _, _, _ = DECODE_CASES[name]
    cfg = run["inp"]["decode"][name]["cfg"]
    heads = cfg.n_kv_heads if rules else cfg.n_kv_heads // 2
    want = {("attn", MAX_LEN // 2)}
    if cfg.sliding_window:
        want.add(("attn", cfg.sliding_window // 2))
    if cfg.is_encoder_decoder:
        want.add(("cross", cfg.encoder_seq // 2))
    for o in run["ranks"]:
        shapes = o["decode"][name]["shapes"]
        got = {(kind, shp[1]) for kind, _, shp in shapes if kind in ("attn", "cross")}
        assert got == want
        assert {shp[2] for kind, _, shp in shapes if kind in ("attn", "cross")} == {heads}
        assert {shp[0] for _, _, shp in shapes} == {B}


def test_a_fully_masked_rank_adds_zeros(run):
    """The split softmax over data, with the one valid key on data rank 0
    and every key of data rank 1 masked, gives the whole row's output bit
    for bit; a row masked on every rank gives zeros (no nan)."""
    for o in run["ranks"]:
        m = o["masked"]
        assert torch.equal(m["one_valid"], m["want"])
        assert torch.equal(m["none_valid"], torch.zeros_like(m["none_valid"]))


@pytest.mark.parametrize("name", list(CARRY_CASES))
def test_cache_block_cuts_the_references_cache(run, name):
    """``convert.cache_block`` cuts the reference's prefill cache, carried
    across (``convert.cache_from_reference``), into blocks of the shapes
    ``models.make_cache`` makes on the mesh, each the whole cache's slots
    [lo, lo + L) (zero past the prompt) and the rank's KV heads."""
    whole = tree.leaves(run["inp"]["carry"][name]["cache"])
    axis = "model" if CARRY_CASES[name][1] else "data"
    for o in run["ranks"]:
        c = o["carry"][name]
        assert [tuple(b.shape) for b in c["blocks"]] == c["made"]
        for w, b in zip(whole, c["blocks"]):
            L, h = b.shape[1], b.shape[2]
            lo = c["coord"][axis] * L        # every K/V leaf splits at these lengths
            h0 = 0 if h == w.shape[2] else c["coord"]["model"] * h
            want = torch.zeros_like(b)
            have = max(0, min(lo + L, w.shape[1]) - lo)
            want[:, :have] = w[:, lo:lo + have, h0:h0 + h]
            assert torch.equal(b, want)


class _Mesh:
    """A stand-in mesh: its axes' sizes, and rank 0's coordinates."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.mesh_dim_names = tuple(shape)

    def get_coordinate(self):
        return [0] * len(self.shape)


PRODUCTION = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("rules", [{}, KVSEQ], ids=["base", "kvseq"])
def test_make_cache_holds_the_references_blocks(arch, rules):
    """``models.make_cache`` on rank 0 of both production meshes (the
    rank's rows under ``split_tokens``, as the dry run makes it) holds
    each leaf's block under the reference's ``launch.dryrun._cache_shardings``
    for every decode cell of the architecture, but for the two differences
    ``make_cache`` states: K/V leaves whose KV heads the reference keeps
    whole where the plan splits the query heads and not the KV heads hold
    the KV heads the rank's queries read; the Mamba-2 ``conv_B`` /
    ``conv_C`` windows are whole."""
    from jax.sharding import AbstractMesh

    from repro.configs import ShapeConfig as RefShape
    from repro.launch.dryrun import _cache_shardings
    from repro_torch.configs import get_config, shapes_for
    from repro_torch.models import make_cache
    from repro_torch.models.parallel import tensor_parallel
    from repro_torch.sharding import rules as shr

    cfg = dataclasses.replace(get_config(arch), sharding_rules={
        **get_config(arch).sharding_rules, **rules})
    rc = dataclasses.replace(ref_get_config(arch), sharding_rules=cfg.sharding_rules)
    n_leaves = 0
    for shape in [s for s in shapes_for(cfg) if s.kind == "decode"]:
        for sizes in PRODUCTION.values():
            ref_cache, ref = _cache_shardings(rc, RefShape(shape.name, "decode",
                                                           shape.seq_len, shape.global_batch),
                                              AbstractMesh(tuple(sizes.values()), tuple(sizes)))
            mesh, B = _Mesh(sizes), shape.global_batch
            rows = shr.batch_partition(mesh, B)
            with shr.use_mesh(mesh), shr.split_tokens(rows):
                made = make_cache(cfg, B // shr.axes_size(mesh, rows), shape.seq_len,
                                  device="meta")
                tp = tensor_parallel(cfg)
            size = lambda part: int(np.prod([sizes[a] for a in (
                () if part is None else part if isinstance(part, tuple) else (part,))]))
            for gi, group in enumerate(cfg.groups()):
                period = len(group.period)
                for li, lc in enumerate(made["groups"][gi]["layers"]):
                    want = ref["groups"][gi]["layers"][li % period]
                    like = ref_cache["groups"][gi]["layers"][li % period]
                    for kind, leaves in lc.items():
                        for name, t in leaves.items():
                            g = like[kind][name]
                            spec = tuple(want[kind][name].spec)
                            spec = (spec + (None,) * (g.ndim - len(spec)))[-t.ndim:]
                            block = [d // size(p) for d, p in zip(g.shape[-t.ndim:], spec)]
                            if name in ("k", "v", "ck", "cv") and spec[2] is None and (
                                    tp is not None and tp.heads and not tp.kv
                                    and spec[1] != "model"):
                                block[2] = tp.kv_local
                            if name in ("conv_B", "conv_C"):
                                block[-1] = g.shape[-1]
                            assert tuple(t.shape) == tuple(block), (shape.name, kind, name)
                            n_leaves += 1
    assert n_leaves > 0
