"""The port's sharded paths on 4 gloo ranks, held against the unsharded port
and the reference.

One module-scoped fixture runs ``_torch_mesh.paths_rank`` on 4 CPU ranks
once (``launch.mesh.run_ranks``: spawned processes, a ``file://`` store,
one torch thread each, a deadline after which every rank is killed) and
keeps what each returned; the tests below assert on it, one check each.
The ranks import no JAX; the reference runs here, in the test process
(Pallas in interpret mode), and in one 4-device XLA subprocess for the
cross-pod int8 mean and the compressed train step. Tolerances: the mesh
dispatch, QR, the int8 mean and the ranks' parameters are compared bit for
bit; K-Means' centroids within 1 int ulp (0 lanes expected on the blocked
path), its inertia within 1e-6 relative (its sum is reduced in another
order, as in the reference); MoE within ``test_torch_moe.py``'s 1e-6 of
the largest value; the train steps as their tests state.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.core import division_modes as ref_dm
from repro.kernels import ops as ref_ops
from repro.models import init_params as ref_init_params
from repro.models import moe as ref_moe
from repro.models.layers import gated_mlp as ref_gated_mlp
from repro.workloads import kmeans as ref_kmeans
from repro_torch import convert, tree
from repro_torch.configs import get_smoke_config
from repro_torch.core.division_modes import DivisionConfig
from repro_torch.eval import workload_metrics as wm
from repro_torch.launch.mesh import run_ranks
from repro_torch.optim import adamw, compress
from repro_torch.train import step
from repro_torch.workloads import kmeans, qr
import _torch_mesh
from _ref_params import ref_init
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

N_RANKS = 4
DEADLINE_S = 360.0
KM_N, KM_D, KM_K = 1 << 17, 8, 8
UNBLOCKED_N = KM_N - 4            # divisible by 4 ranks, not by 8 blocks
DISPATCH_SHAPES = [(1992, 300), (2048, 384), (8, 36, 130)]
MOE_RTOL = 1e-6
# A clip no gradient norm reaches: AdamW's first moment is then (1 - b1)
# times the gradients, so their scale shows in it.
UNCLIPPED = 1e9
FLIP_LANES = 16                   # of 176576 a rank
KM_CFG = DivisionConfig(mode="taylor_pallas")


def _moe_inputs():
    kw = dict(param_dtype="float32", moe_dispatch="local", capacity_factor=0.5)
    rc = dataclasses.replace(ref_smoke_config("deepseek_moe_16b"),
                             division=ref_dm.DivisionConfig(mode="taylor_pallas"), **kw)
    pc = dataclasses.replace(get_smoke_config("deepseek_moe_16b"),
                             division=DivisionConfig(mode="taylor_pallas"), **kw)
    rp = ref_init(rc, 0)["groups"][1]["layers"][0]["ffn"]
    rp = jax.tree_util.tree_map(lambda a: np.asarray(a)[0], rp)       # MoE layer 1
    x = np.random.default_rng(3).normal(size=(N_RANKS, 24, pc.d_model)).astype(np.float32)
    xt = jnp.asarray(x.reshape(-1, pc.d_model))
    probs = ref_dm.softmax(xt @ jnp.asarray(rp["router"]), axis=-1, cfg=rc.division)
    gate_vals, idx = jax.lax.top_k(probs, rc.experts_per_tok)
    gates = gate_vals * ref_dm.recip(jnp.sum(gate_vals, -1, keepdims=True), rc.division)
    return rc, pc, rp, x, probs, gates, idx


def _train_inputs():
    """llama3_8b's smoke config in f32 (so the packages' gradients agree to
    f32 rounding, and int8 rounding ties are rare), its reference params."""
    rcfg = ref_smoke_config("llama3_8b")
    cfg = dataclasses.replace(get_smoke_config("llama3_8b"), param_dtype="float32")
    ref_params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                        ref_init(rcfg, 0))
    params = convert.params_from_reference(ref_params, cfg, "cpu")
    opt_cfg = adamw.AdamWConfig(division=cfg.division)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, size=(8, 33))
    batch = {"tokens": torch.from_numpy(tokens[:, :-1]).int(),
             "labels": torch.from_numpy(tokens[:, 1:]).int()}
    return cfg, opt_cfg, step.init_state(cfg, params, opt_cfg), batch, tokens, ref_params


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rng = np.random.default_rng(0)
    dispatch = [(torch.from_numpy(rng.normal(size=s).astype(np.float32) * 3.0),
                 torch.from_numpy(rng.uniform(0.1, 10.0, size=s).astype(np.float32)))
                for s in DISPATCH_SHAPES]
    x = kmeans.make_blobs(torch.Generator().manual_seed(0), KM_N, KM_D, KM_K)
    init = x[torch.randperm(KM_N, generator=torch.Generator().manual_seed(1))[:KM_K]].clone()
    rc, pc, rp, mx, probs, gates, idx = _moe_inputs()
    grng = np.random.default_rng(7)
    comp = {"g": {"a": grng.normal(size=(2, 2, 64)), "b": grng.normal(size=(2, 2, 3, 5)) * 1e-3},
            "err": {"a": grng.normal(size=(2, 2, 64)) * 0.01, "b": np.zeros((2, 2, 3, 5))}}
    comp = {k: {n: a.astype(np.float32) for n, a in v.items()} for k, v in comp.items()}
    cfg, opt_cfg, state, batch, tokens, ref_params = _train_inputs()
    inp = {"dispatch": dispatch, "kmeans": (x, init), "unblocked_n": UNBLOCKED_N,
           "qr": torch.from_numpy(rng.normal(size=(16, 12, 8)).astype(np.float32)),
           "moe": {"p": tree.map_tree(lambda a: torch.from_numpy(np.array(a)), rp),
                   "x": torch.from_numpy(mx), "xt": torch.from_numpy(mx.reshape(-1, pc.d_model)),
                   "gates": torch.from_numpy(np.array(gates)),
                   "idx": torch.from_numpy(np.array(idx)).long(), "cfg": pc},
           "compress": {k: {n: torch.from_numpy(a) for n, a in v.items()}
                        for k, v in comp.items()},
           "train": {"cfg": cfg, "state": state, "batch": batch, "opt_cfg": opt_cfg,
                     "unclipped_cfg": dataclasses.replace(opt_cfg, grad_clip=UNCLIPPED)},
           "ckpt_dir": str(tmp_path_factory.mktemp("elastic"))}
    ranks = run_ranks(_torch_mesh.paths_rank, N_RANKS, inp, device_type="cpu",
                      timeout_s=DEADLINE_S)
    ref = {"moe": (rc, rp, mx, probs, gates, idx), "compress": comp, "opt_cfg": opt_cfg,
           "tokens": tokens, "params": ref_params}
    return inp, ranks, ref


def _cat(ranks, get):
    return torch.cat([get(r) for r in ranks])


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()


# ------------------------------------------------------------------ placement

def test_a_dim_split_over_pod_and_data_is_pod_major(run):
    _, ranks, _ = run
    for r, out in enumerate(ranks):
        assert out["coord"] == (r // 2, r % 2)
        assert out["rows"] == [2.0 * r, 2.0 * r + 1]


# -------------------------------------------------------------- mesh dispatch

@pytest.mark.parametrize("case", range(len(DISPATCH_SHAPES)))
def test_dispatch_runs_on_each_block_with_no_collective(run, case):
    """No collective, placements kept; on the CPU the plain versions run
    (no kernel launch is counted; test_torch_cuda.py counts the card's)."""
    _, ranks, _ = run
    for out in ranks:
        d = out["dispatch"][case]
        assert d["collectives"] == 0
        assert d["launches"] == {"tsdiv_recip": 0, "tsdiv_divide": 0, "tsdiv_rsqrt": 0}
        assert d["placements_kept"] and d["plain_under_mesh"]


@pytest.mark.parametrize("case", range(len(DISPATCH_SHAPES)))
def test_dispatch_gives_the_unsharded_bits_and_gradients(run, case):
    _, ranks, _ = run
    for out in ranks:
        d = out["dispatch"][case]
        assert d["same_bits"] == {"divide": True, "recip": True, "rsqrt": True}
        assert d["same_grads"] == {"divide": True, "recip": True, "rsqrt": True}


@pytest.mark.parametrize("case", range(len(DISPATCH_SHAPES)))
def test_dispatch_gives_the_references_bits(run, case):
    inp, ranks, _ = run
    a, b = (t.numpy() for t in inp["dispatch"][case])
    want = {"divide": ref_ops.tsdiv_divide(jnp.asarray(a), jnp.asarray(b)),
            "recip": ref_ops.tsdiv_recip(jnp.asarray(a)),
            "rsqrt": ref_ops.tsdiv_rsqrt(jnp.asarray(b))}
    for name, w in want.items():
        got = _cat(ranks, lambda r: r["dispatch"][case]["local"][name])
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.asarray(w).view(np.int32))


@pytest.mark.parametrize("which", ["replicated", "columns", "mixed", "plain_and_dtensor",
                                   "no_mesh", "suspended"])
def test_dispatch_refuses_what_it_cannot_launch_without_gathering(run, which):
    _, ranks, _ = run
    assert all(out["refusals"][which] for out in ranks)


# ------------------------------------------------------------------- K-Means

@pytest.fixture(scope="module")
def kmeans_single(run):
    inp, _, _ = run
    x, init = inp["kmeans"]
    return {n: kmeans.kmeans(x[:n], cfg=KM_CFG, init=init, n_iters=3, device="cpu")
            for n in (KM_N, UNBLOCKED_N)}


@pytest.mark.parametrize("mesh", ["d4", "d4_global", "pd"])
def test_kmeans_sharded_is_the_unsharded_run(run, kmeans_single, mesh):
    """The blocked path: assignments equal, centroids within 1 int ulp (the
    lanes that differ: 0 expected), inertia within 1e-6 relative."""
    _, ranks, _ = run
    want = kmeans_single[KM_N]
    got = [r["kmeans"][mesh] for r in ranks]
    assert torch.equal(torch.cat([g["assign"] for g in got]), want.assignments)
    for g in got:
        ulps = _ulps(g["centroids"], want.centroids)
        assert int(ulps.max()) <= 1
        assert int((ulps > 0).sum()) == 0, f"{int((ulps > 0).sum())} centroid lanes differ"
        assert wm.relative_delta(g["inertia"].numpy(), want.inertia.numpy()) <= 1e-6
        assert wm.relative_delta(g["trace"].numpy(), want.inertia_trace.numpy()) <= 1e-6
    assert all(torch.equal(g["centroids"], got[0]["centroids"]) for g in got)


def test_kmeans_sharded_all_reduces_where_blocks_do_not_fit(run, kmeans_single):
    """N not divisible by the 8 blocks: the sums are all-reduced in another
    order, so a boundary point may switch clusters (measured: 1 of 131068,
    which moves its two centroids by ~1/count)."""
    _, ranks, _ = run
    want = kmeans_single[UNBLOCKED_N]
    got = [r["kmeans"]["d4_unblocked"] for r in ranks]
    agree = (torch.cat([g["assign"] for g in got]) == want.assignments).float().mean()
    assert float(agree) >= 0.999
    for g in got:
        np.testing.assert_allclose(g["centroids"].numpy(), want.centroids.numpy(),
                                   rtol=0, atol=1e-4)
        assert wm.relative_delta(g["inertia"].numpy(), want.inertia.numpy()) <= 1e-6


def test_kmeans_sharded_against_the_reference(run):
    """Within test_torch_workloads.py's tolerance of the reference's kmeans."""
    inp, ranks, _ = run
    x, init = inp["kmeans"]
    ref = ref_kmeans.kmeans(jnp.asarray(x.numpy()), cfg=ref_dm.DivisionConfig(mode="taylor_pallas"),
                            init=jnp.asarray(init.numpy()), n_iters=3)
    got = [r["kmeans"]["d4"] for r in ranks]
    agree = (torch.cat([g["assign"] for g in got]).numpy() == np.asarray(ref.assignments)).mean()
    assert agree >= 0.999
    assert wm.relative_delta(got[0]["inertia"].numpy(), np.asarray(ref.inertia)) <= 1e-5
    assert "Shard(dim=0)" in got[0]["assign_placements"]


def test_kmeans_sharded_without_a_mesh_is_kmeans(run):
    inp, _, _ = run
    x, init = inp["kmeans"]
    x = x[:4096]
    a = kmeans.kmeans_sharded(x, cfg=KM_CFG, init=init, n_iters=2, device="cpu")
    b = kmeans.kmeans(x, cfg=KM_CFG, init=init, n_iters=2, device="cpu")
    assert torch.equal(a.centroids, b.centroids) and torch.equal(a.assignments, b.assignments)


# ------------------------------------------------------------------------ QR

@pytest.mark.parametrize("via", ["div", "rsqrt"])
def test_qr_givens_sharded_is_the_batched_run_bit_for_bit(run, via):
    inp, ranks, _ = run
    q, r = qr.qr_givens_batched(inp["qr"], KM_CFG, via=via, device="cpu")
    got_q = _cat(ranks, lambda o: o["qr"][via][0])
    got_r = _cat(ranks, lambda o: o["qr"][via][1])
    assert torch.equal(got_q.view(torch.int32), q.view(torch.int32))
    assert torch.equal(got_r.view(torch.int32), r.view(torch.int32))


@pytest.mark.parametrize("via", ["div", "rsqrt"])
def test_qr_givens_sharded_without_a_mesh_is_batched(run, via):
    inp, _, _ = run
    a = inp["qr"][:3]
    for got, want in zip(qr.qr_givens_sharded(a, KM_CFG, via=via, device="cpu"),
                         qr.qr_givens_batched(a, KM_CFG, via=via, device="cpu")):
        assert torch.equal(got, want)


# ----------------------------------------------------------------------- MoE

def _ref_local(ref):
    rc, rp, mx, probs, gates, idx = ref
    xt = jnp.asarray(mx.reshape(-1, mx.shape[-1]))
    p = jax.tree_util.tree_map(jnp.asarray, rp)
    out, counts = ref_moe._dispatch_local(p, xt, probs, gates, idx, rc, N_RANKS)
    return p, xt, np.asarray(out), np.asarray(counts)


def test_moe_local_dispatch_at_four_shards_is_the_references(run):
    _, ranks, ref = run
    _, _, want, counts = _ref_local(ref["moe"])
    got = _cat(ranks, lambda r: r["moe"]["dispatch"]).numpy()
    assert np.abs(got - want).max() <= MOE_RTOL * np.abs(want).max()
    for r in ranks:
        np.testing.assert_array_equal(r["moe"]["counts"].numpy(), counts)
    assert counts.sum() < N_RANKS * 24 * ref["moe"][0].experts_per_tok   # tokens drop


def test_moe_ffn_under_the_mesh_has_the_global_aux(run):
    _, ranks, ref = run
    rc, rp, mx, probs, gates, idx = ref["moe"]
    p, xt, out, counts = _ref_local(ref["moe"])
    want = out + np.asarray(ref_gated_mlp(p["shared"], xt))
    got = _cat(ranks, lambda r: r["moe"]["ffn"].reshape(-1, mx.shape[-1])).numpy()
    assert np.abs(got - want).max() <= MOE_RTOL * np.abs(want).max()
    T, E, k = xt.shape[0], rc.n_experts, rc.experts_per_tok
    f_e = counts / (T * k) * E
    aux = E * np.sum(f_e * np.asarray(jnp.mean(probs, axis=0))) * rc.router_aux_weight
    for r in ranks:
        np.testing.assert_allclose(r["moe"]["aux"], aux, rtol=1e-6)


def test_moe_aux_gradient_sums_over_the_shards(run):
    """The ranks' router gradients of the aux, meaned as the train step
    means them, equal the reference's gradient of the global aux."""
    _, ranks, ref = run
    rc, rp, mx, probs, gates, idx = ref["moe"]
    _, xt, _, counts = _ref_local(ref["moe"])
    E, k = rc.n_experts, rc.experts_per_tok
    f_e = jnp.asarray(counts / (xt.shape[0] * k) * E)

    def aux(router):
        pr = ref_dm.softmax(xt @ router, axis=-1, cfg=rc.division)
        return E * jnp.sum(f_e * jnp.mean(pr, axis=0)) * rc.router_aux_weight

    want = np.asarray(jax.grad(aux)(jnp.asarray(rp["router"])))
    got = torch.stack([r["moe"]["router_grad"] for r in ranks]).mean(0).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------------- int8 compression

XLA_REF = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.configs import get_smoke_config
from repro.launch.mesh import _axis_type_kwargs
from repro.models import init_params
from repro.optim import adamw, compress
from repro.train import step

d = np.load(sys.argv[1])
mesh = jax.make_mesh((2, 2), ("pod", "data"), **_axis_type_kwargs(2))

# psum_compressed on one block a device.
g = {n: jnp.asarray(d["g_" + n]) for n in ("a", "b")}
err = {n: jnp.asarray(d["err_" + n]) for n in ("a", "b")}
spec = {n: P("pod", "data") for n in g}
f = shard_map(lambda gg, ee: compress.psum_compressed(
        {n: v[0, 0] for n, v in gg.items()}, {n: v[0, 0] for n, v in ee.items()}, "pod"),
    mesh=mesh, in_specs=(spec, spec),
    out_specs=({n: P(("pod", "data")) for n in g}, {n: P(("pod", "data")) for n in g}))
mean, new_err = jax.jit(f)(g, err)
out = {**{"mean_" + n: np.asarray(v) for n, v in mean.items()},
       **{"err_" + n: np.asarray(v) for n, v in new_err.items()}}

# train_step(compress_axis="pod"): each pod takes half the batch (the data
# peers of a pod share it), its gradients int8-meaned over the pods. The
# parameters are the test process's: init_params draws others on 4 devices.
cfg = dataclasses.replace(get_smoke_config("llama3_8b"), param_dtype="float32")
opt_cfg = adamw.AdamWConfig(division=cfg.division)
like = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
params = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(like), [
    jnp.asarray(d[f"param_{i}"]) for i in range(len(jax.tree_util.tree_leaves(like)))])
state = step.init_state(cfg, params, opt_cfg)
tokens = jnp.asarray(d["tokens"], jnp.int32)
batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

def body(st, b):
    new, _, e = step.train_step(cfg, opt_cfg, st, b, compress_axis="pod",
                                err_tree=compress.init_error_tree(st.params))
    return new, jax.tree_util.tree_map(lambda x: x[None], e)

new, e = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), P("pod")),
                           out_specs=(P(), P("pod")), check_rep=False))(state, batch)
for name, t in (("params", new.params), ("m", new.opt.m), ("v", new.opt.v), ("err", e)):
    for i, leaf in enumerate(jax.tree_util.tree_leaves(t)):
        out[f"train_{name}_{i}"] = np.asarray(leaf.astype(jnp.float32))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def xla_ref(run, tmp_path_factory):
    """The reference's psum_compressed and compressed train step on a
    (pod 2, data 2) mesh of 4 XLA CPU devices, in one subprocess."""
    _, _, ref = run
    d = tmp_path_factory.mktemp("xla_ref")
    np.savez(d / "in.npz", tokens=ref["tokens"],
             **{f"param_{i}": np.asarray(a, np.float32)
                for i, a in enumerate(jax.tree_util.tree_leaves(ref["params"]))},
             **{f"{k}_{n}": a for k, v in ref["compress"].items() for n, a in v.items()})
    r = subprocess.run([sys.executable, "-c", XLA_REF, str(d / "in.npz"),
                        str(d / "out.npz")], capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": "src"},
                       cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("what", ["mean", "err"])
def test_psum_compressed_is_the_references_bit_for_bit(run, xla_ref, what):
    """At (pod 2, data 2): each rank's int8 mean over 'pod' and its new
    error, against the reference's in a 4-device XLA process."""
    _, ranks, ref = run
    for r, out in enumerate(ranks):
        for n in ("a", "b"):
            shape = ref["compress"]["g"][n].shape[2:]
            want = xla_ref[f"{what}_{n}"].reshape((4,) + shape)[r]
            np.testing.assert_array_equal(out["compress"][what][n].numpy().view(np.int32),
                                          want.view(np.int32))


def test_psum_compressed_is_within_one_int8_step_of_the_mean(run):
    _, ranks, ref = run
    for r, out in enumerate(ranks):
        d = r % 2
        for n in ("a", "b"):
            g, e = ref["compress"]["g"][n], ref["compress"]["err"][n]
            gp = (g + e)[:, d]
            exact = gp.mean(0)
            assert np.abs(out["compress"]["mean"][n].numpy() - exact).max() <= (
                np.abs(gp).max() / 127 + 1e-6)


# -------------------------------------------------------------------- training

@pytest.fixture(scope="module")
def int8_steps(run):
    """Each leaf's int8 step s = max|g'| / 127 in the compressed train step:
    g' the pods' half-batch gradients (the error tree starts at 0) from the
    unsharded port, the max taken over the leaf's reference tensor (a
    stack of layers shares one scale). The unit of the tolerances below."""
    inp, _, _ = run
    t = inp["train"]
    halves = [{k: v[4 * p:4 * (p + 1)] for k, v in t["batch"].items()} for p in range(2)]
    gs = [step.grads_fn(t["cfg"], t["state"].params, h, 1)[2] for h in halves]
    tops = [max(float(a.abs().max()), float(b.abs().max()))
            for a, b in zip(tree.leaves(gs[0]), tree.leaves(gs[1]))]
    steps = [0.0] * len(tops)
    for group in compress.stacks(gs[0], [len(g.period) for g in t["cfg"].groups()]):
        for i in group:
            steps[i] = max(tops[j] for j in group) / 127.0
    return steps


def _ref_train_leaves(xla_ref, what, pod=None):
    """The reference's compressed train step's ``what`` (params, m, v, or
    pod ``pod``'s error tree) in the port's layout and leaf order."""
    like = jax.eval_shape(lambda: ref_init_params(ref_smoke_config("llama3_8b"),
                                                  jax.random.PRNGKey(0)))
    treedef = jax.tree_util.tree_structure(like)
    leaves = [xla_ref[f"train_{what}_{i}"] for i in range(treedef.num_leaves)]
    if pod is not None:
        leaves = [a[pod] for a in leaves]
    return tree.leaves(convert.params_from_reference(
        jax.tree_util.tree_unflatten(treedef, leaves), get_smoke_config("llama3_8b"), "cpu"))


@pytest.mark.parametrize("what", ["params", "m", "v", "err"])
def test_compressed_train_step_is_the_references(run, xla_ref, int8_steps, what):
    """Each rank's new parameters, moments and error tree against the
    reference's train_step(compress_axis="pod") on (pod 2, data 2), in f32.
    The gradients of the two packages differ by f32 rounding, so an int8
    rounding tie may go the other way: at most FLIP_LANES lanes (1 and 2
    measured) may differ by more than 1e-4 of the leaf's largest value
    (1e-3 of s in the error tree), and no error lane by more than one int8
    step s, no first-moment lane by more than (1 - b1) s."""
    _, ranks, ref = run
    b1 = ref["opt_cfg"].b1
    for r, out in enumerate(ranks):
        want = _ref_train_leaves(xla_ref, what, r // 2 if what == "err" else None)
        off = 0
        for got, w, s in zip(out["train"][what], want, int8_steps):
            d = (got.double() - w.double()).abs()
            if what == "err":
                assert float(d.max()) <= s * (1 + 1e-3)
                off += int((d > 1e-3 * s).sum())
                continue
            if what == "m":
                assert float(d.max()) <= (1 - b1) * s * (1 + 1e-3)
            off += int((d > 1e-4 * float(w.abs().max())).sum())
        assert off <= FLIP_LANES, f"rank {r}: {off} {what} lanes differ"


@pytest.mark.parametrize("what", ["loss", "params", "m", "v"])
def test_mesh_train_step_is_the_full_batch_step(run, what):
    """The uncompressed data-parallel step on (pod 2, data 2) (gradients
    meaned over both axes in f32) against the single-process step on the
    whole batch, unclipped so the first moment is (1 - b1) times the
    gradients: m and v within 1e-5, the parameters within 1e-4 of each
    leaf's largest value (f32 summation order; 7e-7, 1.2e-6 and 8e-6
    measured), the loss within 1e-5."""
    inp, ranks, _ = run
    t = inp["train"]
    single, metrics = step.train_step(t["cfg"], t["unclipped_cfg"], t["state"], t["batch"])
    if what == "loss":
        for out in ranks:
            assert abs(out["train_mean"]["loss"] - float(metrics["loss"])) <= 1e-5
        return
    want = tree.leaves({"params": single.params, "m": single.opt.m, "v": single.opt.v}[what])
    rtol = 1e-4 if what == "params" else 1e-5
    for out in ranks:
        for got, w in zip(out["train_mean"][what], want):
            assert float((got - w).abs().max()) <= rtol * float(w.abs().max())


def test_compressed_train_step_keeps_the_ranks_bit_equal(run):
    _, ranks, _ = run
    first = ranks[0]["train"]["params"]
    for out in ranks[1:]:
        assert all(torch.equal(a.view(torch.int16) if a.element_size() == 2 else a,
                               b.view(torch.int16) if b.element_size() == 2 else b)
                   for a, b in zip(first, out["train"]["params"]))
    assert len(ranks[0]["train"]["err"]) == len(first)


def test_compressed_train_steps_loss_is_the_full_batchs(run):
    inp, ranks, ref = run
    t = inp["train"]
    _, metrics = step.train_step(t["cfg"], ref["opt_cfg"], t["state"], t["batch"])
    for out in ranks:
        assert abs(out["train"]["loss"] - float(metrics["loss"])) <= 1e-5


# ------------------------------------------------------------- elastic resume

def test_elastic_restore_reshards_without_changing_values(run):
    _, ranks, _ = run
    for out in ranks:
        r = out["restore"]
        assert r["values_equal"] and r["placements_as_specified"]
        assert r["n_dtensors"] > 0 and r["n_split"] > 0
