"""The port's launch tooling against the reference's: the shape cells, the
``abstract_*`` stand-in trees, the HBM-traffic model, the collective tally,
the H100 roofline, and the dry run's fake-tensor trace.

Tolerances: the shape cells, the stand-in trees (shapes and dtypes), the
HBM model's dict and the collective tally are held equal, exactly. The dry
run's FLOPs and unit calls are held equal to those of a real CPU step of
the same smoke config; its argument bytes equal the real parameters'.
The production-mesh cell runs in a child process (its fake process group of
256 ranks must not outlive it).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode, is_fake
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as ref_configs
from repro.launch import memmodel as ref_memmodel
from repro.launch import roofline as ref_rl
from repro.models import abstract_params as ref_abstract_params
from repro.models import make_cache as ref_make_cache
from repro.models.attention import abstract_cache_attn as ref_abstract_cache_attn
from repro.models.mamba2 import abstract_cache_mamba as ref_abstract_cache_mamba
from repro.optim import adamw as ref_adamw
from repro.train import step as ref_step
from repro_torch import configs, tree
from repro_torch.configs import ShapeConfig
from repro_torch.core.division_modes import DivisionConfig
from repro_torch.core.seeds import compute_segments
from repro_torch.kernels import common, fake, flash_attention, ilm, rmsnorm, softmax, tsdiv
from repro_torch.launch import dryrun, memmodel
from repro_torch.launch import roofline as rl
from repro_torch.models import abstract_params, init_params, make_cache
from repro_torch.models.attention import abstract_cache_attn
from repro_torch.models.mamba2 import abstract_cache_mamba
from repro_torch.optim import adamw
from repro_torch.train import step as train_step_lib
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_roofline import HLO as ROOFLINE_HLO

ROOT = Path(__file__).resolve().parents[1]
ARCHS = configs.ARCH_IDS


# ------------------------------------------------------------ shape cells

@pytest.mark.parametrize("arch", ARCHS)
def test_shape_cells_are_the_references(arch):
    mine, theirs = configs.get_config(arch), ref_configs.get_config(arch)
    assert configs.long_context_ok(mine) == ref_configs.long_context_ok(theirs)
    assert [vars(s) for s in configs.shapes_for(mine)] == \
        [vars(s) for s in ref_configs.shapes_for(theirs)]
    assert {k: vars(v) for k, v in configs.LM_SHAPES.items()} == \
        {k: vars(v) for k, v in ref_configs.LM_SHAPES.items()}
    assert configs.base.SUBQUADRATIC_FAMILIES == ref_configs.base.SUBQUADRATIC_FAMILIES


# ------------------------------------------------------- abstract trees

def _sd(t):
    """(shape, dtype name) of a port stand-in or a reference ShapeDtypeStruct."""
    if isinstance(t, torch.Tensor):
        return tuple(t.shape), str(t.dtype).removeprefix("torch.")
    return tuple(t.shape), np.dtype(t.dtype).name


def _ref_groups(groups, cfg, n_encoder=None):
    """The reference's stacked groups as the port's lists of layers."""
    shapes = ([(1, n_encoder)] if n_encoder is not None
              else [(len(g.period), g.repeat) for g in cfg.groups()])
    out = []
    for (period, repeat), g in zip(shapes, groups):
        pick = (lambda a: (tuple(a.shape[1:]), np.dtype(a.dtype).name)) if repeat > 1 else _sd
        out.append({"layers": [jax.tree_util.tree_map(pick, g["layers"][i])
                               for _ in range(repeat) for i in range(period)]})
    return out


def _ref_params_layout(p, cfg):
    out = {k: jax.tree_util.tree_map(_sd, v) for k, v in p.items()
           if k not in ("groups", "encoder")}
    out["groups"] = _ref_groups(p["groups"], cfg)
    if "encoder" in p:
        out["encoder"] = {"groups": _ref_groups(p["encoder"]["groups"], cfg,
                                                cfg.n_encoder_layers),
                          "final_norm": _sd(p["encoder"]["final_norm"])}
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_are_the_references(arch):
    """abstract_params, adamw / train_step abstract_state, make_cache(abstract=True)
    and the two cache helpers: the reference's ShapeDtypeStruct trees, leaf
    for leaf, in the port's layout; meta tensors and fake tensors alike,
    none with storage."""
    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    want = _ref_params_layout(ref_abstract_params(rcfg), rcfg)
    fm = FakeTensorMode()
    for kw in ({}, {"device": "cpu", "fake_mode": fm}):
        params = abstract_params(cfg, **kw)
        leaves = tree.leaves(params)
        assert all(t.is_meta for t in leaves) if not kw else all(is_fake(t) for t in leaves)
        assert tree.map_tree(_sd, params) == want

        opt_cfg = adamw.AdamWConfig(state_dtype=cfg.opt_state_dtype)
        st = train_step_lib.abstract_state(cfg, params, opt_cfg)
        rst = ref_step.abstract_state(rcfg, ref_abstract_params(rcfg),
                                      ref_adamw.AdamWConfig(state_dtype=rcfg.opt_state_dtype))
        assert _sd(st.step) == _sd(rst.step) and _sd(st.opt.step) == _sd(rst.opt.step)
        for got, theirs in ((st.opt.m, rst.opt.m), (st.opt.v, rst.opt.v),
                            (st.params, rst.params)):
            assert tree.map_tree(_sd, got) == _ref_params_layout(theirs, rcfg)
        assert _sd(adamw.abstract_state(params, opt_cfg).step) == ((), "int32")

        cache = make_cache(cfg, 2, 64, abstract=True, **kw)
        rcache = ref_make_cache(rcfg, 2, 64, abstract=True)
        assert tree.map_tree(_sd, cache) == {"groups": _ref_groups(rcache["groups"], rcfg)}
        assert all(t.is_meta for t in tree.leaves(cache)) if not kw else \
            all(is_fake(t) for t in tree.leaves(cache))
    if cfg.n_kv_heads and cfg.head_dim:
        for w in (0, 16):
            assert tree.map_tree(_sd, abstract_cache_attn(cfg, 3, 40, w)) == \
                jax.tree_util.tree_map(_sd, ref_abstract_cache_attn(rcfg, 3, 40, w))
    if cfg.ssm_heads:
        assert tree.map_tree(_sd, abstract_cache_mamba(cfg, 3, torch.bfloat16)) == \
            jax.tree_util.tree_map(_sd, ref_abstract_cache_mamba(rcfg, 3, jax.numpy.bfloat16))


# ---------------------------------------------------------- HBM model

class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


MESHES = {"single_tp1": {"data": 256, "model": 1},
          "multi_tp1": {"pod": 2, "data": 256, "model": 1},
          "single_m16": {"data": 16, "model": 16},
          "multi_m16": {"pod": 2, "data": 16, "model": 16}}


@pytest.mark.parametrize("arch", ARCHS)
def test_hbm_traffic_is_the_references_key_for_key(arch):
    """Every shape cell of the arch x {single, multi} x {tp1, model 16} x
    fused attention on and off, at the dry run's microbatch count: the
    reference's dict, equal key for key (no tolerance)."""
    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    n = 0
    for shape, rshape in zip(configs.shapes_for(cfg), ref_configs.shapes_for(rcfg)):
        for sizes in MESHES.values():
            n_batch = sizes["data"] * sizes.get("pod", 1)
            n_micro = (max(1, max(1, shape.global_batch // n_batch) // cfg.train_microbatch_size)
                       if shape.kind == "train" else 1)
            for fused in (False, True):
                got = memmodel.hbm_traffic(cfg, shape, FakeMesh(sizes), n_micro=n_micro,
                                           fused_attention=fused)
                want = ref_memmodel.hbm_traffic(rcfg, rshape, FakeMesh(sizes), n_micro=n_micro,
                                                fused_attention=fused)
                assert got == want, (shape.name, sizes, fused)
                n += 1
    assert n == len(configs.shapes_for(cfg)) * 8


# ------------------------------------------------------------ collectives

def _hlo_records():
    """test_roofline.py's HLO sample as the records sharding/comm.py keeps:
    each op's result bytes and the ranks of the group rank 0's device (or
    the sample's first group) belongs to."""
    a2a = np.arange(512).reshape(2, 256).T.reshape(2, 256)[0].tolist()
    return [{"op": "all-reduce", "bytes": 4 * 1024 * 4, "ranks": [0, 1, 2, 3]},
            {"op": "all-gather", "bytes": 8 * 2048 * 2, "ranks": [0, 1, 2, 3]},
            {"op": "reduce-scatter", "bytes": 2 * 512 * 4, "ranks": list(range(16))},
            {"op": "collective-permute", "bytes": 16 * 128 * 2},
            {"op": "all-to-all", "bytes": 4 * 4096 * 4, "ranks": a2a}]


@pytest.mark.parametrize("pod_size", [256, None])
def test_collective_tally_is_parse_collectives_on_the_hlo_sample(pod_size):
    """The same ops, bytes and groups give the reference's wire bytes and
    pod crossings (its as-compiled tally: the port halves nothing)."""
    want = ref_rl.parse_collectives(ROOFLINE_HLO, 512, pod_size=pod_size)
    got = rl.tally_collectives(_hlo_records(), 512, pod_size=pod_size)
    assert [(o["op"], o["bytes"], o["group"], o["wire_bytes"], o["cross_pod"])
            for o in got["ops"]] == \
        [(o["op"], o["bytes"], o["group"], o["wire_bytes"], o["cross_pod"])
         for o in want["ops"]]
    assert (got["ici_bytes"], got["dcn_bytes"]) == (want["ici_bytes"], want["dcn_bytes"])
    assert rl.allreduce_wire_bytes(1024, 4) == ref_rl.allreduce_wire_bytes(1024, 4)
    assert rl.elementwise_hbm_bytes(10, n_devices=2) == ref_rl.elementwise_hbm_bytes(10, n_devices=2)


# ------------------------------------------------------------- roofline

def test_roofline_terms_bound_and_mfu_with_h100_constants():
    assert (rl.PEAK_FLOPS, rl.PEAK_FLOPS_F32, rl.HBM_BW, rl.HBM_BYTES, rl.NVLINK_BW) == \
        (989e12, 67e12, 3.35e12, 80e9, 450e9)
    r = rl.Roofline(flops=989e12, bytes_accessed=3.35e12 * 2, ici_bytes=450e9 * 0.5,
                    dcn_bytes=rl.INTER_HOST_BW * 0.25, model_flops=494.5e12)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(2.0)
    assert r.t_collective == pytest.approx(0.75)
    assert r.bound == "memory" and r.t_step == pytest.approx(2.0)
    assert r.mfu == pytest.approx(0.25)
    assert r.flops_efficiency == pytest.approx(0.5)
    assert set(r.to_dict()) == {"flops", "bytes_accessed", "ici_bytes", "dcn_bytes",
                                "model_flops", "t_compute", "t_memory", "t_collective",
                                "t_step", "bound", "mfu", "flops_efficiency"}
    assert rl.Roofline(1.0, 0.0, 0.0, 0.0, 1.0).bound == "compute"
    assert rl.model_flops_per_device(1e9, 1e6, 256, "train") == pytest.approx(6e15 / 256)
    assert rl.model_flops_per_device(1e9, 128, 256, "inference") == pytest.approx(2e9 * 128 / 256)
    assert rl.measured_mfu(989e12 * 0.3, 1.0) == pytest.approx(0.3)


# --------------------------------------------------------- the fake path

def _wrapper_calls(fm, device):
    """One call of every kernel wrapper on tensors of ``device`` made in
    ``fm`` (or real ones when ``fm`` is None)."""
    import contextlib

    with fm if fm is not None else contextlib.nullcontext():
        x = torch.rand(8, 16, device=device) + 0.5
        w = torch.ones(16, device=device)
        q = torch.rand(2, 32, 16, device=device)
        u = torch.arange(64, device=device, dtype=torch.int32).view(torch.uint32)
        return {"tsdiv_recip": tsdiv.recip(x), "tsdiv_divide": tsdiv.divide(x, x),
                "tsdiv_rsqrt": tsdiv.rsqrt(x), "softmax_f32": softmax.softmax(x),
                "rmsnorm_f32": rmsnorm.rmsnorm(x, w),
                "flash_attention_f32": flash_attention.flash_attention(q, q, q, block_k=16),
                "ilm_mul_u32": ilm.ilm_mul(u, u), "ilm_square_u32": ilm.ilm_square(u)}


def _launches():
    return {k: v for m in (tsdiv, softmax, rmsnorm, flash_attention, ilm)
            for k, v in m.LAUNCHES.items()}


def test_fake_path_is_taken_only_for_fake_tensors():
    """Fake CUDA tensors (the dry run's) get an empty output of the right
    shape, dtype and device and a count in fake.CALLS, never in LAUNCHES;
    real CPU tensors run the plain versions, fake.CALLS untouched."""
    fake.reset()
    before = _launches()
    outs = _wrapper_calls(FakeTensorMode(), "cuda")
    assert fake.CALLS == {k: 1 for k in outs}
    for name, o in outs.items():
        assert is_fake(o) and o.device.type == "cuda", name
    assert _launches() == before
    fake.reset()
    real = _wrapper_calls(None, "cpu")
    assert fake.CALLS == {} and _launches() == before
    assert not any(is_fake(o) for o in real.values())
    y = torch.rand(8, 16) + 0.5
    assert torch.equal(tsdiv.recip(y), common.recip_f32_bits(y, compute_segments(2, 24), 2,
                                                             "factored"))


@pytest.mark.cuda
def test_a_real_cuda_tensor_still_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    fake.reset()
    before = _launches()
    outs = _wrapper_calls(None, "cuda")
    after = _launches()
    assert fake.CALLS == {}
    assert {k: after[k] - before[k] for k in outs} == {k: 1 for k in outs}


# ------------------------------------------------------------- dry run

SMOKE_ARCHS = ["paper_fpdiv", "deepseek_moe_16b", "jamba_1_5_large", "whisper_tiny",
               "llava_next_mistral_7b"]


def _smoke_batch(cfg, B, S, gen):
    batch = {"labels": torch.randint(0, cfg.vocab, (B, S), generator=gen, dtype=torch.int32)}
    if cfg.embed_inputs and not cfg.is_encoder_decoder:
        batch["embeds"] = torch.randn(B, S, cfg.d_model, generator=gen).to(torch.bfloat16)
    else:
        batch["tokens"] = torch.randint(0, cfg.vocab, (B, S), generator=gen, dtype=torch.int32)
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = torch.randn(B, cfg.encoder_seq, cfg.d_model,
                                          generator=gen).to(torch.bfloat16)
    return batch


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_fake_step_counts_what_a_real_cpu_step_runs(arch, monkeypatch):
    """The smoke config in taylor_pallas, 4 x 32 tokens in 2 microbatches:
    the dry run's FLOPs equal FlopCounterMode around a real CPU train step,
    its unit calls the plain versions' calls, its argument bytes include
    the real parameters' bytes exactly."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              division=DivisionConfig(mode="taylor_pallas"))
    B, S, n_micro = 4, 32, 2
    shape = ShapeConfig("smoke_train", "train", S, B)
    cell = dryrun.run_cell(arch, one_rank=True, shape=shape, cfg=cfg, n_micro=n_micro,
                           device="cpu")

    calls = {}

    def counting(mod, fn_name, kernel):
        fn = getattr(mod, fn_name)

        def wrapped(*a, **k):
            calls[kernel] = calls.get(kernel, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, fn_name, wrapped)

    for mod, fn_name, kernel in ((tsdiv, "recip", "tsdiv_recip"),
                                 (tsdiv, "divide", "tsdiv_divide"),
                                 (tsdiv, "rsqrt", "tsdiv_rsqrt"),
                                 (softmax, "softmax", "softmax_f32"),
                                 (rmsnorm, "rmsnorm", "rmsnorm_f32")):
        counting(mod, fn_name, kernel)
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen)
    opt_cfg = adamw.AdamWConfig(state_dtype=cfg.opt_state_dtype, division=cfg.division)
    state = train_step_lib.init_state(cfg, params, opt_cfg)
    batch = _smoke_batch(cfg, B, S, gen)
    with FlopCounterMode(display=False) as fc:
        train_step_lib.train_step(cfg, opt_cfg, state, batch, n_micro=n_micro)

    assert cell["roofline"]["flops"] == fc.get_total_flops() > 0
    assert cell["unit_calls"] == calls and calls["tsdiv_recip"] >= len(tree.leaves(params))
    param_bytes = sum(t.numel() * t.element_size() for t in tree.leaves(params))
    abstract = abstract_params(cfg, "cpu", FakeTensorMode())
    assert sum(t.numel() * t.element_size() for t in tree.leaves(abstract)) == param_bytes
    mem = cell["memory"]
    assert mem["argument_bytes"] == sum(
        t.numel() * t.element_size() for t in tree.leaves((state, batch)))
    assert mem["total_hbm_bytes"] == mem["argument_bytes"] + mem["output_bytes"] + \
        mem["temp_bytes"] - mem["alias_bytes"]
    assert cell["devices"] == 1 and cell["n_micro"] == n_micro and cell["sharding_fallbacks"] == []
    assert cell["collectives"]["n_ops"] == 0


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_fake_inference_cells_trace_on_one_rank(kind):
    """Prefill and decode cells of the smoke models: FLOPs, the decode
    cache updated in place (aliased), the roofline's keys."""
    for arch in ("jamba_1_5_large", "whisper_tiny"):
        cfg = dryrun.apply_variant(configs.get_smoke_config(arch), "kernels")[0]
        cell = dryrun.run_cell(arch, one_rank=True, cfg=cfg, device="cpu",
                               shape=ShapeConfig("s", kind, 64, 2))
        assert cell["roofline"]["flops"] > 0 and cell["unit_calls"]["softmax_f32"] > 0
        if kind == "decode":
            assert cell["memory"]["alias_bytes"] > 0
        else:
            assert cell["memory"]["alias_bytes"] == 0


def test_a_model_axis_cell_raises_naming_item_18(tmp_path):
    """Since item 18 the attention models run a model axis (the test
    below), and since items 19 and 23 the MoE models too: deepseek's
    train_4k cell (a fake process group of 256 ranks in a child; the kernel
    mode, one microbatch) traces with its 64 experts on data (4 a rank)
    and expert_mlp on model, its exchange an all-to-all over data (forward,
    remat's recompute, backward) and the reduce-scatter of its all-gather's
    backward, once per MoE layer each. Until item 22 a cell whose Mamba-2
    layers a model axis would split raised the ValueError that named it;
    now mamba2_780m's decode_32k cell traces at tp4 (in the same child),
    its mixers split by heads: per Mamba layer one all-gather (the gated
    norm's rows) and one all-reduce (the out-projection) over model, and
    one all-reduce more for the vocab-split embedding."""
    out = tmp_path / "cell.json"
    code = ("import json, sys; from repro_torch.launch import dryrun; "
            "json.dump([dryrun.run_cell('deepseek_moe_16b', 'train_4k', False, "
            "variant='kernels', n_micro=1, device='cpu'), dryrun.run_cell("
            "'mamba2_780m', 'decode_32k', False, variant='tp4', device='cpu')], "
            "open(sys.argv[1], 'w'))")
    r = subprocess.run([sys.executable, "-c", code, str(out)], capture_output=True, text=True,
                       timeout=600, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": "src", "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stdout + r.stderr
    cell, ssm = json.loads(out.read_text())
    cfg = configs.get_config("deepseek_moe_16b")
    n_moe = sum(s.ffn == "moe" for s in cfg.layer_specs())
    assert cell["param_layout"] == "data+model" and n_moe == 27
    data = cell["collectives"]["by_axis"]["data"]
    assert data["all-to-all"]["count"] == 3 * n_moe
    assert data["reduce-scatter"]["count"] == n_moe
    n_mamba = configs.get_config("mamba2_780m").n_layers
    assert ssm["param_layout"] == "model" and set(ssm["collectives"]["by_axis"]) == {"model"}
    model = ssm["collectives"]["by_axis"]["model"]
    assert model["all-gather"]["count"] == n_mamba and model["all-reduce"]["count"] == n_mamba + 1
    assert set(model) == {"all-gather", "all-reduce"}
    assert dryrun.apply_variant(configs.get_config("llama3_8b"), "tp1+kernels")[0] \
        .division.mode == "taylor_pallas"


def test_a_model_axis_cell_traces_the_tensor_parallel_step(tmp_path):
    """llama3_8b train_4k on the single mesh at the default model = 16
    (data 16; a fake process group of 256 ranks in a child), one
    microbatch, in the kernel mode. Its all-reduces over the model axis
    are what models/parallel.py issues: per layer 2 in the forward
    (attention and MLP outputs), 1 in remat's recompute (which stops after
    the attention's, the last tensor its backward reads), 4 in the
    backward (attention and MLP inputs, and the replicated wk and wv: 8 kv
    heads do not split 16 ways); then 1 at the embedding, 1 at the LM
    head's input, 3 in the vocab-split loss and 1 in the global norm. Over
    data: one gradient mean per leaf, and the loss and its two metrics.
    The rank holds its blocks: 1/16 of the split leaves."""
    out = tmp_path / "cell.json"
    code = ("import json, sys; from repro_torch.launch import dryrun; "
            "json.dump(dryrun.run_cell('llama3_8b', 'train_4k', False, variant='kernels', "
            "n_micro=1, device='cpu'), open(sys.argv[1], 'w'))")
    r = subprocess.run([sys.executable, "-c", code, str(out)], capture_output=True, text=True,
                       timeout=600, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": "src", "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stdout + r.stderr
    cell = json.loads(out.read_text())
    cfg = configs.get_config("llama3_8b")
    n_leaves = len(tree.leaves(abstract_params(cfg)))
    assert cell["devices"] == 256 and cell["param_layout"] == "model"
    by_axis = cell["collectives"]["by_axis"]
    assert by_axis["model"]["all-reduce"]["count"] == cfg.n_layers * (2 + 1 + 4) + 6
    assert by_axis["data"]["all-reduce"]["count"] == n_leaves + 3
    assert set(by_axis) == {"model", "data"}
    assert cell["unit_calls"]["tsdiv_recip"] == n_leaves
    mesh = FakeMesh({"data": 16, "model": 16})
    from repro_torch.models.params import model_specs
    from repro_torch.sharding import rules as shr

    held = 0      # the rank's blocks of the parameters, m and v (f32)
    for p, sh in zip(tree.leaves(model_specs(cfg)), tree.leaves(shr.param_shardings(cfg, mesh))):
        n = int(np.prod(shr.local_shape(p.shape, sh)))
        held += n * ((4 if p.dtype == "float32" else 2) + 4 + 4)
    tokens = 2 * 256 * 4096 * 4                       # the global batch, int32
    assert cell["memory"]["argument_bytes"] == held + 2 * 4 + tokens
    assert cell["hbm_traffic_model"] == memmodel.hbm_traffic(
        dryrun.apply_variant(cfg, "kernels")[0],
        configs.LM_SHAPES["train_4k"], mesh, n_micro=1)


def test_full_width_cell_traces_on_fake_tensors_without_allocating(tmp_path):
    """jamba_1_5_large train_4k on the tp1 mesh (data = 256, a fake process
    group in a child process), in the port's kernel mode: 398 B parameters
    and their AdamW state, traced at full depth. The kernel mode traces in
    about half the time of the plain unit's many elementwise ops. The
    child's peak resident memory stays far below what one rank's step
    would hold."""
    code = ("import resource, sys; from repro_torch.launch import dryrun; "
            "dryrun.main(sys.argv[1:]); "
            "print('maxrss_kib', resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)")
    r = subprocess.run([sys.executable, "-c", code, "--arch", "jamba_1_5_large",
                        "--shape", "train_4k", "--mesh", "single", "--variant", "tp1+kernels",
                        "--device", "cpu", "--out", str(tmp_path)],
                       capture_output=True, text=True, timeout=600, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": "src", "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stdout + r.stderr
    cell = json.loads((tmp_path / "jamba_1_5_large_train_4k_single_tp1+kernels.json").read_text())
    rss = int(r.stdout.split("maxrss_kib")[1].split()[0]) * 1024
    assert cell["devices"] == 256 and cell["n_micro"] == 1
    assert rss < 8 * 2**30
    n_leaves = len(tree.leaves(abstract_params(configs.get_config("jamba_1_5_large"))))
    assert cell["unit_calls"]["tsdiv_recip"] >= n_leaves
    assert 0 < cell["roofline"]["flops_efficiency"] < 1
    # FSDP: every leaf with an embed dim lies on data there (the 16 experts
    # do not divide 256, so the expert leaves take data on their embed dim,
    # as GSPMD places them); the rank holds its blocks of the parameters
    # and of AdamW's bf16 m and v; each FSDP leaf is gathered once a
    # forward, a block's again in remat's recompute, its gradient
    # reduce-scattered once (one microbatch); the other leaves' gradients
    # are all-reduced; each MoE layer gathers its routing counts over data
    # (the tokens' axis), again in the recompute
    cfg = dryrun.apply_variant(configs.get_config("jamba_1_5_large"), "tp1+kernels")[0]
    mesh = FakeMesh({"data": 256, "model": 1})
    from repro_torch.models.params import model_specs
    from repro_torch.sharding import rules as shr

    specs = [(p, sh) for p, sh in zip(tree.leaves(model_specs(cfg)),
                                      tree.leaves(shr.param_shardings(cfg, mesh)))]
    n_fsdp = sum("data" in sh.spec for _, sh in specs)
    assert n_fsdp == sum("embed" in p.axes for p, _ in specs)
    held = sum(int(np.prod(shr.local_shape(p.shape, sh)))
               * ((4 if p.dtype == "float32" else 2) + 2 + 2) for p, sh in specs)
    assert cell["memory"]["argument_bytes"] == held + 2 * 4 + 2 * 256 * 4096 * 4
    by_data = cell["collectives"]["by_axis"]["data"]
    n_moe = sum(spec.ffn == "moe" for spec in cfg.layer_specs())
    assert cfg.remat and by_data["all-gather"]["count"] == 3 + 2 * (n_fsdp - 3 + n_moe)
    assert by_data["reduce-scatter"]["count"] == n_fsdp
    assert by_data["all-reduce"]["count"] >= n_leaves - n_fsdp
    # the HBM model sees the layout the rank holds: the reference's rules
    assert cell["param_layout"] == "data"
    assert cell["hbm_traffic_model"] == memmodel.hbm_traffic(
        cfg, configs.LM_SHAPES["train_4k"], mesh)


def test_sequence_layout_cells_issue_their_collectives(tmp_path):
    """Three inference cells on the single mesh (data 16, model 16; a fake
    process group of 256 ranks in one child), in the kernel mode:
    llama3_8b prefill_32k under ``seq_shard``: each of the base layout's
    2L + 1 all-reduces over model (attention and MLP outputs, the
    vocab-split embedding) becomes a reduce-scatter, and each sub-layer's
    and the LM head's input an all-gather (2L + 1 each); llama3_8b
    decode_32k under ``kvseq``: per attention layer the query heads'
    all-gather and the split softmax's three all-reduces (maximum, sum,
    ``probs @ V``) beside the output projection's and the MLP's, and the
    embedding's (5L + 1 all-reduces, L all-gathers); gemma3_12b long_500k
    (batch 1): the split softmax's three all-reduces a layer over data,
    the 2L + 1 all-reduces over model. The rank's cache is its block of
    the slots: S / 16 of each K/V leaf."""
    out = tmp_path / "cells.json"
    code = ("import json, sys; from repro_torch.launch import dryrun; "
            "json.dump([dryrun.run_cell(a, s, False, variant=v, device='cpu') for a, s, v in ("
            "('llama3_8b', 'prefill_32k', 'tp16+seq_shard+kernels'), "
            "('llama3_8b', 'decode_32k', 'kvseq+kernels'), "
            "('gemma3_12b', 'long_500k', 'kernels'))], open(sys.argv[1], 'w'))")
    r = subprocess.run([sys.executable, "-c", code, str(out)], capture_output=True, text=True,
                       timeout=600, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": "src", "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stdout + r.stderr
    prefill, decode, long = json.loads(out.read_text())
    count = lambda cell, axis: {op: v["count"]
                                for op, v in cell["collectives"]["by_axis"][axis].items()}
    L = configs.get_config("llama3_8b").n_layers
    assert set(prefill["collectives"]["by_axis"]) == {"model"}
    assert count(prefill, "model") == {"all-gather": 2 * L + 1, "reduce-scatter": 2 * L + 1}
    assert set(decode["collectives"]["by_axis"]) == {"model"}
    assert count(decode, "model") == {"all-gather": L, "all-reduce": 5 * L + 1}
    g = configs.get_config("gemma3_12b")
    assert set(long["collectives"]["by_axis"]) == {"data", "model"}
    assert count(long, "data") == {"all-reduce": 3 * g.n_layers}
    assert count(long, "model") == {"all-reduce": 2 * g.n_layers + 1}
    # the split softmax kernel's three passes a split attention layer, no fused softmax
    assert decode["unit_calls"]["softmax_split_f32"] == 3 * L
    assert long["unit_calls"]["softmax_split_f32"] == 3 * g.n_layers
    assert "softmax_f32" not in decode["unit_calls"] and "softmax_f32" not in long["unit_calls"]
    cfg = configs.get_config("llama3_8b")
    # 8 rows a data rank, every KV head, 32768 / 16 slots, bf16 K and V
    assert decode["cache_bytes"] == (
        cfg.n_layers * 2 * 8 * (32768 // 16) * cfg.n_kv_heads * cfg.head_dim * 2)
    n_global = sum(s.mixer == "attn" for s in g.layer_specs())
    # one row, 1 of 8 KV heads (the one the rank's query head reads)
    assert long["cache_bytes"] == 2 * g.head_dim * 2 * (
        n_global * 524288 // 16 + (g.n_layers - n_global) * g.sliding_window // 16)
