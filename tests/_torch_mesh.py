"""Rank functions of the port's multi-rank tests (``launch.mesh.run_ranks``).

Each runs on every rank of a gloo group (4 ranks on the CPU; 2 on one card
for ``test_torch_cuda.py``) and returns plain tensors and numbers, which
the test process holds against the unsharded port and the reference. No
JAX here: the ranks import torch and the port only.
"""
import os

import torch


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().view({4: torch.int32, 2: torch.int16}[t.element_size()])


def _raises(fn, *words) -> bool:
    try:
        fn()
    except ValueError as e:
        return all(w in str(e) for w in words)
    return False


def _dispatch(mesh, a, b, dev):
    """The three mesh-dispatched ops on a DTensor of the global (a, b): local
    outputs, gradients, collective counts, launches, and the unsharded
    port's outputs and gradients at this rank's block."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.kernels import ops, tsdiv
    from repro_torch.sharding import rules as shr

    a, b = a.to(dev), b.to(dev)
    sh = shr.batch_sharding(mesh, shr.batch_partition(mesh, a.shape[0]), a.ndim)
    al = shr.local_block(a, sh).clone().requires_grad_()
    bl = shr.local_block(b, sh).clone().requires_grad_()
    A = DTensor.from_local(al, mesh, sh.placements, run_check=False)
    B = DTensor.from_local(bl, mesh, sh.placements, run_check=False)
    g = torch.linspace(-2.0, 3.0, a.numel(), device=dev).reshape(a.shape)
    gl = shr.local_block(g, sh)
    out = {"placements_kept": True}
    tsdiv.reset_launches()
    with shr.use_mesh(mesh), CommDebugMode() as comm:
        ys = {"divide": ops.tsdiv_divide(A, B), "recip": ops.tsdiv_recip(A),
              "rsqrt": ops.tsdiv_rsqrt(B)}
        out["launches"] = dict(tsdiv.LAUNCHES)
        grads = {}
        for name, y in ys.items():
            out["placements_kept"] &= tuple(y.placements) == tuple(A.placements)
            ins = (al, bl) if name == "divide" else (al,) if name == "recip" else (bl,)
            grads[name] = torch.autograd.grad(y.to_local(), ins, gl)
    out["collectives"] = comm.get_total_counts()
    out["local"] = {k: y.to_local().detach().cpu() for k, y in ys.items()}
    af, bf = a.clone().requires_grad_(), b.clone().requires_grad_()
    full = {"divide": (ops.tsdiv_divide(af, bf), (af, bf)),
            "recip": (ops.tsdiv_recip(af), (af,)), "rsqrt": (ops.tsdiv_rsqrt(bf), (bf,))}
    out["same_bits"], out["same_grads"] = {}, {}
    for name, (y, ins) in full.items():
        gf = torch.autograd.grad(y, ins, g)
        out["same_bits"][name] = torch.equal(_bits(shr.local_block(y, sh)),
                                             _bits(ys[name].to_local()))
        out["same_grads"][name] = all(
            torch.equal(_bits(shr.local_block(x, sh)), _bits(w))
            for x, w in zip(gf, grads[name]))
    with shr.use_mesh(mesh):
        plain = ops.tsdiv_recip(al.detach())
    out["plain_under_mesh"] = torch.equal(_bits(plain), _bits(ops.tsdiv_recip(al.detach())))
    return out


def _refusals(mesh):
    """The DTensors the dispatch must refuse, each with a ValueError."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels import ops
    from repro_torch.sharding import rules as shr

    x = torch.ones((8, 16))
    rep = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    cols = DTensor.from_local(x[:, :4].contiguous(), mesh, [Shard(1)] * mesh.ndim,
                              run_check=False)
    rows = shr.distribute(x, shr.batch_sharding(mesh, shr.batch_axes(mesh), 2))
    with shr.use_mesh(mesh):
        out = {"replicated": _raises(lambda: ops.tsdiv_recip(rep), "not gathered"),
               "columns": _raises(lambda: ops.tsdiv_rsqrt(cols), "not gathered"),
               "mixed": _raises(lambda: ops.tsdiv_divide(rows, rep), "placed differently"),
               "plain_and_dtensor": _raises(lambda: ops.tsdiv_divide(x, rows),
                                            "placed differently")}
    out["no_mesh"] = _raises(lambda: ops.tsdiv_recip(rows), "no active mesh")
    with shr.use_mesh(mesh), shr.suspend_mesh():
        out["suspended"] = _raises(lambda: ops.tsdiv_recip(rows), "no active mesh")
    return out


def _kmeans(mesh, x, init, cfg, as_dtensor: bool):
    from repro_torch.sharding import rules as shr
    from repro_torch.workloads import kmeans

    if as_dtensor:
        x = shr.distribute(x, shr.batch_sharding(mesh, shr.batch_partition(mesh, x.shape[0]), 2))
    with shr.use_mesh(mesh):
        res = kmeans.kmeans_sharded(x, cfg=cfg, init=init, n_iters=3, device="cpu")
    return {"centroids": res.centroids, "assign": res.assignments.to_local(),
            "inertia": res.inertia, "trace": res.inertia_trace,
            "assign_placements": str(tuple(res.assignments.placements))}


def paths_rank(rank: int, inp: dict) -> dict:
    """Every multi-rank check of tests/test_torch_sharded_paths.py, on one of
    4 CPU ranks."""
    import torch.distributed as dist

    from repro_torch.core.division_modes import DivisionConfig
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models import moe
    from repro_torch.optim import adamw, compress
    from repro_torch.sharding import comm
    from repro_torch.sharding import rules as shr
    from repro_torch.train import checkpoint, step
    from repro_torch import tree
    from repro_torch.workloads import qr

    pd = make_mesh((2, 2), ("pod", "data"), "cpu")
    d4 = make_host_mesh(device_type="cpu")            # (data 4, model 1)
    out = {"coord": pd.get_coordinate()}
    rows = shr.distribute(torch.arange(8.0)[:, None],
                          shr.batch_sharding(pd, ("pod", "data"), 2))
    out["rows"] = rows.to_local()[:, 0].tolist()
    out["dispatch"] = [_dispatch(pd, a, b, "cpu") for a, b in inp["dispatch"]]
    out["refusals"] = _refusals(pd)

    cfg = DivisionConfig(mode="taylor_pallas")
    x, init = inp["kmeans"]
    out["kmeans"] = {"d4": _kmeans(d4, x, init, cfg, True),
                     "d4_global": _kmeans(d4, x, init, cfg, False),
                     "pd": _kmeans(pd, x, init, cfg, True),
                     "d4_unblocked": _kmeans(d4, x[:inp["unblocked_n"]], init, cfg, True)}

    a = inp["qr"]
    with shr.use_mesh(d4):
        out["qr"] = {via: [t.to_local() for t in qr.qr_givens_sharded(a, cfg, via=via,
                                                                      device="cpu")]
                     for via in ("div", "rsqrt")}

    m = inp["moe"]
    r = d4.get_coordinate()[0]
    T = m["xt"].shape[0] // 4
    blk = slice(r * T, (r + 1) * T)
    got, counts = moe._dispatch(m["p"], m["xt"][blk], m["gates"][blk], m["idx"][blk], m["cfg"])
    p = {k: (v.clone().requires_grad_() if k == "router" else v) for k, v in m["p"].items()}
    with shr.use_mesh(d4), shr.split_tokens(("data",)):
        y, aux = moe.moe_ffn(p, m["x"][r:r + 1], m["cfg"])
        (g_router,) = torch.autograd.grad(aux, p["router"])
    out["moe"] = {"dispatch": got, "counts": comm.all_reduce(counts, d4, ["data"]),
                  "ffn": y.detach(), "aux": float(aux), "router_grad": g_router}

    c = inp["compress"]
    p_, d_ = pd.get_coordinate()
    pick = lambda t: {k: v[p_, d_] for k, v in t.items()}
    with shr.use_mesh(pd):
        mean, err = compress.psum_compressed(pick(c["g"]), pick(c["err"]), "pod", [])
    out["compress"] = {"mean": mean, "err": err}

    t = inp["train"]
    leaves = lambda x: [v.detach().clone() for v in tree.leaves(x)]
    with shr.use_mesh(pd):
        new_state, metrics, new_err = step.train_step(
            t["cfg"], t["opt_cfg"], t["state"], t["batch"], compress_axis="pod",
            err_tree=compress.init_error_tree(t["state"].params))
        mean_state, mean_metrics = step.train_step(t["cfg"], t["unclipped_cfg"], t["state"],
                                                   t["batch"])
    out["train"] = {"loss": float(metrics["loss"]), "params": leaves(new_state.params),
                    "m": leaves(new_state.opt.m), "v": leaves(new_state.opt.v),
                    "err": leaves(new_err)}
    out["train_mean"] = {"loss": float(mean_metrics["loss"]),
                         "params": leaves(mean_state.params), "m": leaves(mean_state.opt.m),
                         "v": leaves(mean_state.opt.v)}

    d41 = make_mesh((4, 1), ("data", "model"), "cpu")
    d22 = make_mesh((2, 2), ("data", "model"), "cpu")
    with shr.use_mesh(d41):
        if rank == 0:
            checkpoint.save(inp["ckpt_dir"], 1, t["state"])
        dist.barrier()
    ps = shr.param_shardings(t["cfg"], d22)
    state_sh = step.TrainState(params=ps, opt=adamw.AdamWState(step=None, m=ps, v=ps),
                               step=None)
    got = checkpoint.restore(inp["ckpt_dir"], 1, t["state"], shardings=state_sh)
    want_pl = [sh.placements for sh in tree.leaves(state_sh) if sh is not None]
    sharded = [v for v in tree.leaves(got) if hasattr(v, "placements")]
    out["restore"] = {
        "n_dtensors": len(sharded),
        "n_split": sum(any(pl.is_shard() for pl in v.placements) for v in sharded),
        "placements_as_specified": all(tuple(v.placements) == w
                                       for v, w in zip(sharded, want_pl)),
        "values_equal": all(torch.equal(_bits(v.full_tensor() if hasattr(v, "placements")
                                              else v), _bits(w))
                            for v, w in zip(tree.leaves(got), tree.leaves(t["state"])))}
    return out


def failing_rank(rank: int, bad_rank: int) -> int:
    """Rank ``bad_rank`` raises at once; the others wait at a barrier, which
    never completes."""
    import torch.distributed as dist

    if rank == bad_rank:
        raise RuntimeError(f"planted failure on rank {rank}")
    dist.barrier()
    return rank


def cuda_dispatch_rank(rank: int, a: torch.Tensor, b: torch.Tensor) -> dict:
    """The mesh dispatch on a card shared by 2 ranks: one launch per op and
    rank, no collective, the unsharded launch's bits, the plain versions'
    bits on this rank's block."""
    from repro_torch.core.seeds import compute_segments, rsqrt_seed_table
    from repro_torch.kernels import common
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import rules as shr

    mesh = make_host_mesh(device_type="cuda")
    out = _dispatch(mesh, a, b, "cuda")
    sh = shr.batch_sharding(mesh, ("data",), a.ndim)
    al, bl = (shr.local_block(t, sh).cuda().contiguous() for t in (a, b))
    table = compute_segments(2, 24)
    plain = {"divide": common.divide_f32_bits(al, bl, table, 2, "factored"),
             "recip": common.recip_f32_bits(al, table, 2, "factored"),
             "rsqrt": common.rsqrt_f32_bits(bl, rsqrt_seed_table(16), 2)}
    out["plain_bits"] = {k: torch.equal(_bits(v.cpu()), _bits(out["local"][k]))
                         for k, v in plain.items()}
    out["pid"] = os.getpid()
    del out["local"]
    return out


# ------------------------------------------------ tensor parallelism (model axis)

def _pair_meshes(rank: int):
    """The two (data 1, model 2) meshes of ranks {0, 1} and {2, 3}, every
    rank building both (a mesh's groups are made by every rank of the
    process group); returns this rank's and its pair's index."""
    from torch.distributed.device_mesh import DeviceMesh

    pairs = [DeviceMesh("cpu", torch.tensor([[2 * p, 2 * p + 1]]),
                        mesh_dim_names=("data", "model")) for p in range(2)]
    return pairs[rank // 2], rank // 2


def _tp_forward(c: dict) -> dict:
    """A case's forward under the active mesh: train and prefill logits, then
    the decode steps from the prefill's cache; the rank's vocab blocks."""
    from repro_torch.models import forward
    from repro_torch.serving import pad_cache_to

    cfg, params, kw = c["cfg"], c["params"], c["kw"]
    with torch.no_grad():
        train, _, _ = forward(cfg, params, mode="train", **kw)
        prefill, cache, _ = forward(cfg, params, mode="prefill", **kw)
        s = c["prompt_len"]
        cache = pad_cache_to(cache, s, s + len(c["decode"]), cfg)
        steps = []
        for t, tok in enumerate(c["decode"]):
            logits, cache, _ = forward(cfg, params, tokens=tok, cache=cache, pos=s + t,
                                       mode="decode")
            steps.append(logits)
    layers = [lc for g in cache["groups"] for lc in g["layers"]]
    kv_heads = {lc["attn"]["k"].shape[2] for lc in layers if "attn" in lc}
    ssm = {(lc["mamba"]["state"].shape[1], lc["mamba"]["conv_x"].shape[2],
            lc["mamba"]["conv_B"].shape[2]) for lc in layers if "mamba" in lc}
    return {"train": train, "prefill": prefill, "decode": steps, "cache_kv_heads": kv_heads,
            "cache_ssm": ssm}


def _tp_generate(c: dict) -> dict:
    from repro_torch.serving import Request, ServingEngine

    eng = ServingEngine(c["cfg"], c["params"], max_len=64)
    out = {"batch": eng.generate_batch(c["prompts"], c["max_new"], **c["hand"])}
    if c.get("serve"):
        reqs = [Request(list(p), max_new=c["max_new"]) for p in c["prompts"]]
        out["serve"] = [r.out for r in eng.serve(reqs, slots=2)]
    return out


def _tp_train(cfg, opt_cfg, params, batch, mesh, n_micro: int, ckpt_dir=None) -> dict:
    """One train step on ``mesh`` from DTensor parameters cut from the
    global tree: the rank's new blocks, the loss; with ``ckpt_dir`` the new
    state saved there (every rank calls save)."""
    from repro_torch import tree
    from repro_torch.sharding import rules as shr
    from repro_torch.train import checkpoint, step

    sh = shr.param_shardings(cfg, mesh)
    placed = tree.map_tree(shr.distribute, params, sh)
    state = step.init_state(cfg, placed, opt_cfg)
    with shr.use_mesh(mesh):
        new, metrics = step.train_step(cfg, opt_cfg, state, batch, n_micro=n_micro)
    local = lambda t: [v.to_local().detach().clone() for v in tree.leaves(t)]
    out = {"loss": float(metrics["loss"]), "params": local(new.params), "m": local(new.opt.m),
           "v": local(new.opt.v), "dtensors": all(hasattr(v, "placements")
                                                   for v in tree.leaves(new.params))}
    if ckpt_dir is not None:
        checkpoint.save(ckpt_dir, 1, new)
    return out


def tp_rank(rank: int, inp: dict) -> dict:
    """Every multi-rank check of tests/test_torch_tensor_parallel.py, on one
    of 4 CPU ranks: the forward of each case on (1, 4), (2, 2) and the two
    (1, 2) pairs (each pair takes every other case), greedy tokens on (1,
    4), train steps on (2, 2) and (1, 4), the (2, 2) checkpoint, the
    Mamba-2 models on (2, 2), the cut draws."""
    from repro_torch import convert, tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import forward, init_params
    from repro_torch.sharding import rules as shr

    m14 = make_mesh((1, 4), ("data", "model"), "cpu")
    m22 = make_mesh((2, 2), ("data", "model"), "cpu")
    pair, p = _pair_meshes(rank)
    out = {"forward": {}, "generate": {}}
    for i, (name, c) in enumerate(inp["cases"].items()):
        meshes = [("1x4", m14), ("2x2", m22)] + ([("1x2", pair)] if i % 2 == p else [])
        for mesh_name, mesh in meshes:
            with shr.use_mesh(mesh):
                out["forward"][name, mesh_name] = _tp_forward(c)
        with shr.use_mesh(m14):
            out["generate"][name] = _tp_generate(c)

    t = inp["train"]
    out["train"] = {"2x2": _tp_train(t["cfg"], t["opt_cfg"], t["params"], t["batch"], m22,
                                     t["n_micro"], inp["ckpt_dir"]),
                    "1x4": _tp_train(t["cfg14"], t["opt_cfg"], t["params14"], t["batch"], m14,
                                     t["n_micro"])}

    out["ssm"] = {}
    for arch, (cfg, params, toks) in inp["ssm"].items():
        with torch.no_grad(), shr.use_mesh(m22):
            out["ssm"][arch] = forward(cfg, params, tokens=toks)[0]

    d = inp["draws"]
    sh = shr.param_shardings(d["cfg"], m22)
    drawn = init_params(d["cfg"], torch.Generator().manual_seed(d["seed"]), shardings=sh)
    cut = convert.params_from_reference(d["reference"], d["cfg"], "cpu", shardings=sh)
    out["draws"] = {"init": [v.to_local() for v in tree.leaves(drawn)],
                    "convert": [v.to_local() for v in tree.leaves(cut)],
                    "placements": [str(tuple(v.placements)) for v in tree.leaves(drawn)]}
    return out


# --------------------------------------------- expert parallelism (data, model)

def _data_pairs(rank: int):
    """The two (data 2, model 1) meshes of ranks {0, 1} and {2, 3}, every
    rank building both; returns this rank's."""
    from torch.distributed.device_mesh import DeviceMesh

    pairs = [DeviceMesh("cpu", torch.tensor([[2 * p], [2 * p + 1]]),
                        mesh_dim_names=("data", "model")) for p in range(2)]
    return pairs[rank // 2]


def _ep_meshes():
    from repro_torch.launch.mesh import make_mesh

    return {"2x2": make_mesh((2, 2), ("data", "model"), "cpu"),
            "4x1": make_mesh((4, 1), ("data", "model"), "cpu"),
            "1x4": make_mesh((1, 4), ("data", "model"), "cpu")}


def _row_block(mesh, n_rows: int) -> slice:
    """This rank's rows of a batch split over 'data'."""
    from repro_torch.sharding import rules as shr

    n, i = shr.mesh_shape(mesh)["data"], shr.axis_index(mesh, "data")
    return slice(i * n_rows // n, (i + 1) * n_rows // n)


def _moe_kept(p, x, cfg):
    """The kept mask of the rank's (token, choice) pairs, as the MoE FFN
    routes them under the active mesh."""
    from repro_torch.core import division_modes as dm
    from repro_torch.models import moe

    xt = x.reshape(-1, x.shape[-1])
    probs = dm.softmax(xt.float() @ p["router"].float(), axis=-1, cfg=cfg.division)
    _, idx = moe.top_k(probs, cfg.experts_per_tok)
    return moe._assign(idx.reshape(-1), cfg, moe.route(cfg, xt.shape[0]))[1].reshape(idx.shape)


def _remat_grads(c: dict, mesh) -> dict:
    """The gradients of one remat train forward of the rank's rows, with the
    backward pass run on this thread and on another one (where no mesh is
    active, as autograd's device threads on the card)."""
    import threading

    from repro_torch import tree
    from repro_torch.models import forward
    from repro_torch.models.parallel import local_params, tensor_parallel
    from repro_torch.sharding import rules as shr

    cfg = c["cfg"]
    out = {}
    for where in ("same", "other"):
        with shr.use_mesh(mesh):
            params = local_params(cfg, c["params"], tensor_parallel(cfg))
            live = [p.detach().clone().requires_grad_() for p in tree.leaves(params)]
            toks = c["tokens"][_row_block(mesh, c["tokens"].shape[0])]
            with shr.split_tokens(("data",)):
                logits, _, aux = forward(cfg, tree.unflatten(params, live), tokens=toks,
                                         mode="train")
                loss = logits.square().mean() + aux
                if where == "same":
                    grads = torch.autograd.grad(loss, live)
        if where == "other":
            got = {}

            def backward():
                try:
                    got["g"] = torch.autograd.grad(loss, live)
                except Exception as e:            # reported: the test names it
                    got["error"] = repr(e)

            worker = threading.Thread(target=backward)
            worker.start()
            worker.join()
            out["error"] = got.get("error")
            grads = got.get("g", ())
        out[where] = [g.detach() for g in grads]
    return out


def ep_rank(rank: int, inp: dict) -> dict:
    """Every multi-rank check of tests/test_torch_expert_parallel.py, on one
    of 4 CPU ranks: the data-parallel MoE FFN on two (data 2) pairs, the
    MoE models' forward, split forward and greedy tokens on each layout,
    the local dispatch, and the train steps (DTensor state, one checkpoint)."""
    from repro_torch import convert, tree
    from repro_torch.models import forward, init_params, moe
    from repro_torch.models.parallel import tensor_parallel
    from repro_torch.sharding import comm
    from repro_torch.sharding import rules as shr
    from repro_torch.train import step

    out = {"fault": {}, "forward": {}, "split": {}, "generate": {}, "local": {}, "train": {}}
    pair = _data_pairs(rank)
    for key, (cfg, p, x) in inp["fault"].items():
        xl = x[_row_block(pair, x.shape[0])]
        with torch.no_grad(), shr.use_mesh(pair), shr.split_tokens(("data",)):
            y, aux = moe.moe_ffn(p, xl, cfg)
            out["fault"][key] = {"y": y, "aux": float(aux), "kept": _moe_kept(p, xl, cfg)}

    meshes = _ep_meshes()
    for (arch, layout), c in inp["cases"].items():
        mesh = meshes[c["mesh"]]
        with shr.use_mesh(mesh):
            out["forward"][arch, layout] = _tp_forward(c)
            toks = c["kw"]["tokens"]
            with torch.no_grad(), shr.split_tokens(("data",)), comm.record() as ops:
                logits, _, aux = forward(c["cfg"], c["params"], tokens=toks[
                    _row_block(mesh, toks.shape[0])], mode="train")
            out["split"][arch, layout] = {"logits": logits, "aux": float(aux),
                                          "ops": [o["op"] for o in ops]}
            out["generate"][arch, layout] = _tp_generate({**c, "cfg": c["gen_cfg"]})

    for name, (cfg, p, x, mesh_name, split) in inp["local"].items():
        mesh = meshes[mesh_name]
        xl = x[_row_block(mesh, x.shape[0])] if split else x
        blocks = shr.local_tree(p, tensor_parallel(cfg, mesh).shardings["groups"][1][
            "layers"][0]["ffn"])
        with torch.no_grad(), shr.use_mesh(mesh), shr.split_tokens(("data",) if split else ()):
            y, aux = moe.moe_ffn(blocks, xl, cfg)
        out["local"][name] = {"y": y, "aux": float(aux)}

    out["remat"] = _remat_grads(inp["remat"], meshes["2x2"])

    d = inp["draws"]
    sh = shr.param_shardings(d["cfg"], meshes["2x2"])
    drawn = init_params(d["cfg"], torch.Generator().manual_seed(d["seed"]), shardings=sh)
    cut = convert.params_from_reference(d["reference"], d["cfg"], "cpu", shardings=sh)
    out["draws"] = {"init": [v.to_local() for v in tree.leaves(drawn)],
                    "convert": [v.to_local() for v in tree.leaves(cut)],
                    "coord": dict(zip(("data", "model"), meshes["2x2"].get_coordinate()))}

    t = inp["train"]["moonshot_4x1"]
    try:
        with shr.use_mesh(meshes["4x1"]):
            step.train_step(t["cfg"], t["opt_cfg"], step.init_state(t["cfg"], t["params"],
                                                                    t["opt_cfg"]),
                            t["batch"], compress_axis="data")
        out["compress_refusal"] = ""
    except ValueError as e:
        out["compress_refusal"] = str(e)

    for name, t in inp["train"].items():
        mesh = meshes[t["mesh"]]
        out["train"][name] = _tp_train(t["cfg"], t["opt_cfg"], t["params"], t["batch"], mesh,
                                       t["n_micro"], t.get("ckpt_dir"))
        out["train"][name]["coord"] = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    return out


# ------------------------------------------------- the Mamba-2 mixer (model axis)

def _ssm_mixer(c: dict, mesh) -> dict:
    """One layer's mixer on the rank's heads under ``mesh``: prefill with
    lengths (output, state, conv tails), then one decode step from the
    rank's heads of the reference's cache; the collectives each issued."""
    from repro_torch.models.mamba2 import decode_mamba, mamba_mixer
    from repro_torch.models.parallel import gather_tree, tensor_parallel
    from repro_torch.sharding import comm
    from repro_torch.sharding import rules as shr

    cfg = c["cfg"]
    tp = tensor_parallel(cfg, mesh)
    p = shr.local_tree(c["p"], tp.shardings["groups"][0]["layers"][0]["mamba"])
    if tp.fsdp:             # jamba's embed on data: the mixer reads the gathered leaves
        spec = cfg.layer_specs()[0]
        p = gather_tree(p, tp.fsdp[spec, cfg.is_encoder_decoder]["mamba"], mesh)
    m = tp.size if tp.ssm else 1
    i = tp.rank if tp.ssm else 0
    h, n = cfg.ssm_heads // m, cfg.d_inner // m
    cache = dict(c["cache"])
    cache["state"] = cache["state"][:, i * h:(i + 1) * h]
    cache["conv_x"] = cache["conv_x"][..., i * n:(i + 1) * n]
    with torch.no_grad(), shr.use_mesh(mesh):
        with comm.record() as prefill_ops:
            y, new = mamba_mixer(p, c["x"], cfg, return_state=True, lengths=c["lengths"],
                                 tp=tp)
        with comm.record() as decode_ops:
            yd, stepped = decode_mamba(p, c["x_step"], cache, cfg, tp)
    return {"y": y, "cache": new, "y_step": yd, "stepped": stepped, "split": tp.ssm,
            "ops": [o["op"] for o in prefill_ops], "decode_ops": [o["op"] for o in decode_ops]}


def ssm_rank(rank: int, inp: dict) -> dict:
    """Every multi-rank check of tests/test_torch_ssm_parallel.py, on one of
    4 CPU ranks: each case's mixer and forward on (1, 4), (2, 2) and the two
    (1, 2) pairs (each pair takes every other case), the collectives of a
    decode step, greedy tokens and serve() on (1, 4), the train steps
    (DTensor state; the (2, 2) one checkpointed), the cut draws."""
    from repro_torch import convert, tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import forward, init_params, make_cache
    from repro_torch.models.parallel import tensor_parallel
    from repro_torch.sharding import comm
    from repro_torch.sharding import rules as shr

    meshes = {"1x4": make_mesh((1, 4), ("data", "model"), "cpu"),
              "2x2": make_mesh((2, 2), ("data", "model"), "cpu")}
    pair, p = _pair_meshes(rank)
    out = {"mixer": {}, "forward": {}, "generate": {}, "ops": {}, "plan": {}}
    for i, (name, c) in enumerate(inp["cases"].items()):
        run_on = list(meshes.items()) + ([("1x2", pair)] if i % 2 == p else [])
        for mesh_name, mesh in run_on:
            out["mixer"][name, mesh_name] = _ssm_mixer(inp["mixers"][name], mesh)
            with shr.use_mesh(mesh):
                out["forward"][name, mesh_name] = _tp_forward(c)
            tp = tensor_parallel(c["cfg"], mesh)
            out["plan"][name, mesh_name] = {"ssm": tp.ssm, "placements": [
                str(sh.spec) for sh in tree.leaves(tp.shardings["groups"][0]["layers"][0])]}
        with shr.use_mesh(meshes["1x4"]):
            out["generate"][name] = _tp_generate(c)
            with torch.no_grad(), comm.record() as ops:
                forward(c["cfg"], c["params"], tokens=c["decode"][0], mode="decode",
                        cache=make_cache(c["cfg"], c["decode"][0].shape[0], 8), pos=0)
            out["ops"][name] = [o["op"] for o in ops]

    out["train"] = {}
    for name, t in inp["train"].items():
        out["train"][name] = _tp_train(t["cfg"], t["opt_cfg"], t["params"], t["batch"],
                                       meshes[t["mesh"]], t["n_micro"], t.get("ckpt_dir"))

    d = inp["draws"]
    sh = shr.param_shardings(d["cfg"], meshes["2x2"])
    drawn = init_params(d["cfg"], torch.Generator().manual_seed(d["seed"]), shardings=sh)
    cut = convert.params_from_reference(d["reference"], d["cfg"], "cpu", shardings=sh)
    out["draws"] = {"init": [v.to_local() for v in tree.leaves(drawn)],
                    "convert": [v.to_local() for v in tree.leaves(cut)]}
    return out


# ------------------------------------------- FSDP over data, the int8 mean on blocks

def _fsdp_grads(cfg, params, batch, mesh) -> list:
    """The ops of one train forward and backward of the rank's rows:
    ``(op, ranks)`` of each collective, in order."""
    from repro_torch import tree
    from repro_torch.models.parallel import local_params, tensor_parallel
    from repro_torch.sharding import comm
    from repro_torch.sharding import rules as shr
    from repro_torch.train import step

    with shr.use_mesh(mesh):
        local = local_params(cfg, params, tensor_parallel(cfg))
        rows = {k: v[_row_block(mesh, v.shape[0])] for k, v in batch.items()}
        with shr.split_tokens(("data",)), comm.record() as ops:
            step.grads_fn(cfg, local, rows, 1)
    return [(o["op"], tuple(o["ranks"])) for o in ops]


def _steps(cfg, opt_cfg, params, batch, mesh, n_micro: int, n_steps: int,
           ckpt_dir=None, compress_axis=None) -> dict:
    """``n_steps`` train steps on ``mesh`` from DTensor parameters cut from
    the global tree (with ``compress_axis``, the int8 mean from a zero error
    tree): the rank's new blocks, the losses, the mesh coordinates; with
    ``ckpt_dir`` the last state saved there."""
    from repro_torch import tree
    from repro_torch.optim import compress
    from repro_torch.sharding import rules as shr
    from repro_torch.train import checkpoint, step

    sh = shr.param_shardings(cfg, mesh)
    state = step.init_state(cfg, tree.map_tree(shr.distribute, params, sh), opt_cfg)
    err = None if compress_axis is None else compress.init_error_tree(state.params)
    losses = []
    with shr.use_mesh(mesh):
        for _ in range(n_steps):
            if compress_axis is None:
                state, metrics = step.train_step(cfg, opt_cfg, state, batch, n_micro=n_micro)
            else:
                state, metrics, err = step.train_step(cfg, opt_cfg, state, batch,
                                                      n_micro=n_micro,
                                                      compress_axis=compress_axis,
                                                      err_tree=err)
            losses.append(float(metrics["loss"]))
    local = lambda t: [v.to_local().detach().clone() for v in tree.leaves(t)]
    out = {"losses": losses, "params": local(state.params), "m": local(state.opt.m),
           "v": local(state.opt.v),
           "dtensors": all(hasattr(v, "placements") for v in tree.leaves(state.params)),
           "coord": dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))}
    if err is not None:
        out["err"] = local(err)
    if ckpt_dir is not None:
        checkpoint.save(ckpt_dir, n_steps, state)
    return out


def fsdp_rank(rank: int, inp: dict) -> dict:
    """Every multi-rank check of tests/test_torch_fsdp.py, on one of 4 CPU
    ranks: jamba's smoke model under its own rules (embed on data) and with
    embed whole, on (data 2, model 2): the stored blocks, forward, greedy
    tokens and serve(), the cut draws, one step at one microbatch, the collectives of a
    train forward and backward with and without remat, two steps (the
    state checkpointed); then the int8 mean on (pod 2, model 2) blocks and
    the compressed steps on (pod 2, model 2) and (pod 2, data 2)."""
    import torch.distributed as dist

    from repro_torch import convert, tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.models.parallel import tensor_parallel
    from repro_torch.optim import compress
    from repro_torch.sharding import rules as shr

    meshes = {"data_model": make_mesh((2, 2), ("data", "model"), "cpu"),
              "pod_model": make_mesh((2, 2), ("pod", "model"), "cpu"),
              "pod_data": make_mesh((2, 2), ("pod", "data"), "cpu")}
    m22 = meshes["data_model"]
    out = {"coord": dict(zip(m22.mesh_dim_names, m22.get_coordinate())), "forward": {}}
    f = inp["forward"]
    for name, c in f.items():
        with shr.use_mesh(m22):
            out["forward"][name] = _tp_forward(c)
    cfg = f["fsdp"]["cfg"]
    placed = tree.map_tree(shr.distribute, f["fsdp"]["params"],
                           shr.param_shardings(cfg, m22))
    tp = tensor_parallel(cfg, m22)
    out["stored"] = {"shapes": [tuple(v.to_local().shape) for v in tree.leaves(placed)],
                     "specs": [sh.spec for sh in tree.leaves(tp.shardings)],
                     "fsdp": tp.fsdp["top"]}
    with shr.use_mesh(m22):
        out["generate"] = _tp_generate(inp["generate"])
    d = inp["draws"]
    sh = shr.param_shardings(cfg, m22)
    drawn = init_params(cfg, torch.Generator().manual_seed(d["seed"]), shardings=sh)
    cut = convert.params_from_reference(d["reference"], cfg, "cpu", shardings=sh)
    out["draws"] = {"init": [v.to_local() for v in tree.leaves(drawn)],
                    "convert": [v.to_local() for v in tree.leaves(cut)]}

    g = inp["grads"]
    out["one_micro"] = {name: _steps(c, g["opt_cfg"], g["params"], g["batch"], m22, 1, 1)
                        for name, c in (("fsdp", g["cfg"]), ("whole", g["cfg0"]))}
    r = inp["remat"]
    out["ops"] = {name: _fsdp_grads(c, r["params"], r["batch"], m22)
                  for name, c in (("remat", r["cfg"]), ("plain", r["cfg_plain"]))}
    out["data_group"] = tuple(dist.get_process_group_ranks(m22.get_group("data")))

    t = inp["train"]
    out["train"] = _steps(t["cfg"], t["opt_cfg"], t["params"], t["batch"], m22, t["n_micro"],
                          t["n_steps"], t["ckpt_dir"])

    c = inp["compress"]
    pm = meshes["pod_model"]
    coord = dict(zip(pm.mesh_dim_names, pm.get_coordinate()))
    pick = lambda tr: {n: shr.local_block(v[coord["pod"]], shr.NamedSharding(pm, c["specs"][n]))
                       for n, v in tr.items()}
    with shr.use_mesh(pm):
        mean, err = compress.psum_compressed(pick(c["g"]), pick(c["err"]), "pod", [])
    out["compress"] = {"mean": mean, "err": err, "coord": coord}

    out["compressed"] = {}
    for name, t in inp["compressed"].items():
        out["compressed"][name] = _steps(t["cfg"], t["opt_cfg"], t["params"], t["batch"],
                                         meshes[t["mesh"]], 1, 1, compress_axis="pod")
    return out


# ------------------------------------------- the sequence on model and data

def _seq_layouts(c: dict, mesh) -> dict:
    """A ``seq_shard`` case under the active mesh: train and prefill logits
    (the rank's vocab blocks), and the residual stream's rows a block sees."""
    from repro_torch.models import forward, model

    cfg, params, kw = c["cfg"], c["params"], c["kw"]
    seen = []
    real = model.block_forward

    def spy(bp, x, *a, **k):
        seen.append(x.shape[1])
        return real(bp, x, *a, **k)

    model.block_forward = spy
    try:
        with torch.no_grad():
            train = forward(cfg, params, mode="train", **kw)[0]
            prefill = forward(cfg, params, mode="prefill", **kw)[0]
    finally:
        model.block_forward = real
    return {"train": train, "prefill": prefill, "rows": sorted(set(seen))}


def _seq_decode(c: dict, mesh) -> dict:
    """A decode case under the active mesh: the prefill's cache cut to the
    rank's blocks (``convert.cache_block``), then teacher-forced decode steps
    (the rank's vocab blocks of the logits, any nan), the cache blocks'
    shapes, and greedy tokens through the engine."""
    from repro_torch import convert
    from repro_torch.models import forward
    from repro_torch.serving import ServingEngine

    cfg, params, kw = c["cfg"], c["params"], c["kw"]
    s, max_len = c["prompt_len"], c["max_len"]
    with torch.no_grad():
        _, cache, _ = forward(cfg, params, mode="prefill", **kw)
        cache = convert.cache_block(cache, cfg, mesh, max_len=max_len)
        steps = []
        for t, tok in enumerate(c["decode"]):
            logits, cache, _ = forward(cfg, params, tokens=tok, cache=cache, pos=s + t,
                                       mode="decode")
            steps.append(logits)
    layers = [lc for g in cache["groups"] for lc in g["layers"]]
    shapes = sorted({(kind, name, tuple(v.shape)) for lc in layers for kind in lc
                     for name, v in lc[kind].items()})
    out = {"decode": steps, "shapes": shapes,
           "nan": any(bool(torch.isnan(x).any()) for x in steps)}
    if c.get("prompts") is not None:
        eng = ServingEngine(cfg, params, max_len=max_len)
        out["generate"] = eng.generate_batch(c["prompts"], c["max_new"], **c.get("hand", {}))
    return out


def _seq_step(t: dict, mesh) -> dict:
    """One ``seq_shard`` train step on ``mesh`` from DTensor parameters: the
    new state's global leaves and the loss (rank 0 keeps them); and the
    gradients with remat on and off, bit for bit."""
    from repro_torch import tree
    from repro_torch.models.parallel import local_params, tensor_parallel
    from repro_torch.sharding import rules as shr
    from repro_torch.train import step

    cfg, opt_cfg = t["cfg"], t["opt_cfg"]
    sh = shr.param_shardings(cfg, mesh)
    state = step.init_state(cfg, tree.map_tree(shr.distribute, t["params"], sh), opt_cfg)
    with shr.use_mesh(mesh):
        new, metrics = step.train_step(cfg, opt_cfg, state, t["batch"], n_micro=t["n_micro"])
        got = {k: [shr.global_tensor(v).detach().clone() for v in tree.leaves(x)]
               for k, x in (("params", new.params), ("m", new.opt.m), ("v", new.opt.v))}
        grads = {}
        for remat in (True, False):
            c = __import__("dataclasses").replace(cfg, remat=remat)
            local = local_params(c, t["params"], tensor_parallel(c))
            rows = {k: v[_row_block(mesh, v.shape[0])] for k, v in t["batch"].items()}
            with shr.split_tokens(("data",)):
                grads[remat] = tree.leaves(step.grads_fn(c, local, rows, 1)[2])
    same = all(torch.equal(_bits(a), _bits(b)) for a, b in zip(grads[True], grads[False]))
    return {"loss": float(metrics["loss"]), "state": got, "remat_bit_equal": same}


def _masked(mesh) -> dict:
    """The split softmax (``attention._split_sdpa``) over ``data``: a row
    whose one valid key lies on data rank 0, and a row masked on every
    rank, beside the whole row's ``_sdpa``."""
    from repro_torch.core.division_modes import DivisionConfig
    from repro_torch.models import attention
    from repro_torch.models.parallel import kv_split

    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(shape, generator=g) for shape in ((1, 1, 2, 4), (1, 8, 2, 4),
                                                                 (1, 8, 2, 4)))
    div = DivisionConfig(mode="taylor_pallas")
    seq = kv_split(_SeqCfg(), mesh, 1, 8)
    lo = 4 * seq.index
    one = torch.zeros((1, 1, 1, 8), dtype=torch.bool)
    one[..., 1] = True
    none = torch.zeros_like(one)
    block = lambda t: t[:, lo:lo + 4]
    return {"one_valid": attention._split_sdpa(q, block(k), block(v), one[..., lo:lo + 4], div,
                                               0.5, seq),
            "want": attention._sdpa(q, k, v, one, div, 0.5),
            "none_valid": attention._split_sdpa(q, block(k), block(v), none[..., lo:lo + 4],
                                                div, 0.5, seq)}


class _SeqCfg:
    """A stand-in config whose rules name no sequence axis (the batch-1
    cache's sequence goes on data)."""

    sharding_rules: dict = {}


def _carry(c: dict, mesh) -> dict:
    """A whole cache carried across from the reference, cut by
    ``convert.cache_block``: the blocks, and ``make_cache``'s shapes."""
    from repro_torch import convert, tree
    from repro_torch.models import make_cache
    from repro_torch.sharding import rules as shr

    cfg = c["cfg"]
    blocks = convert.cache_block(c["cache"], cfg, mesh, max_len=c["max_len"])
    with shr.use_mesh(mesh):
        made = make_cache(cfg, c["batch"], c["max_len"], device="meta")
    return {"blocks": tree.leaves(blocks),
            "made": [tuple(t.shape) for t in tree.leaves(made)],
            "coord": dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))}


def seq_rank(rank: int, inp: dict) -> dict:
    """Every multi-rank check of tests/test_torch_seq_parallel.py, on one of
    4 CPU ranks: ``seq_shard`` forwards on (2, 2) and on the two (1, 2)
    pairs, one ``seq_shard`` train step of each STEP_ARCHS model on (2, 2);
    decode against a cache split by sequence over ``model`` (``kvseq``)
    and, at batch 1, over ``data``, on (2, 2); the split softmax with a
    fully-masked rank; whole caches from the reference cut to the rank's
    blocks."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import rules as shr

    m22 = make_mesh((2, 2), ("data", "model"), "cpu")
    pair, _ = _pair_meshes(rank)
    meshes = {"2x2": m22, "1x2": pair}
    out = {"coord": dict(zip(m22.mesh_dim_names, m22.get_coordinate())), "seq_shard": {},
           "decode": {}}
    for (name, mesh_name), c in inp["seq_shard"].items():
        with shr.use_mesh(meshes[mesh_name]):
            out["seq_shard"][name, mesh_name] = _seq_layouts(c, meshes[mesh_name])
    for name, c in inp["decode"].items():
        with shr.use_mesh(m22):
            out["decode"][name] = _seq_decode(c, m22)
    out["step"] = {arch: _seq_step(t, m22) for arch, t in inp["step"].items()}
    if rank:
        for o in out["step"].values():
            o.pop("state")
    out["masked"] = _masked(m22)
    out["carry"] = {name: _carry(c, m22) for name, c in inp["carry"].items()}
    return out
