"""The port's sharding rules and meshes against the reference's.

``spec_for``, the batch partition and the parameters' specs and drops are
compared with the reference's on the same stand-in meshes (an object whose
``.shape`` maps axis names to sizes, as ``tests/test_sharding.py``'s
``FakeMesh``), so production shapes (16 x 16, 2 x 16 x 16) are checked
without 256 or 512 ranks. A spec is a plain tuple in the port and a
``PartitionSpec`` (a tuple) in the reference. The port keeps one leaf per
layer where the reference stacks a group's layers under a leading
``layers`` axis, whose rule is None: each port leaf's spec is the
reference's without that dim.
"""
import time

import jax
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import rules_for as ref_rules_for
from repro.models import params as ref_params
from repro.sharding import rules as ref_shr
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, DEFAULT_RULES, get_config, rules_for
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import params
from repro_torch.sharding import rules as shr
import _torch_mesh
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


class Mesh16:
    shape = {"data": 16, "model": 16}


class Mesh2x16:
    shape = {"pod": 2, "data": 16, "model": 16}


class Mesh32:
    shape = {"data": 32, "model": 32}


MESHES = {"16x16": Mesh16, "2x16x16": Mesh2x16}

# tests/test_sharding.py's TestSpecFor / TestSpecForDrops cases:
# (shape, axes, rules, mesh).
SPEC_CASES = [
    ((4096, 32, 128), ("embed", "heads", "head_dim"),
     {"heads": "model", "kv_heads": "model", "embed": None}, Mesh16),
    ((4096, 8, 128), ("embed", "kv_heads", "head_dim"),
     {"heads": "model", "kv_heads": "model", "embed": None}, Mesh16),
    ((16, 8192, 24576), ("experts", "embed", "expert_mlp"),
     {"experts": "data", "embed": "data", "expert_mlp": "model"}, Mesh16),
    ((36, 16, 8192, 24576), ("layers", "experts", "embed", "expert_mlp"),
     "jamba_1_5_large", Mesh2x16),
    ((16, 8192, 12, 100), ("experts", "embed", "kv_heads", "seq"),
     {"experts": "data", "embed": "data", "kv_heads": "model", "seq": "pod"}, Mesh16),
    ((4096, 128), ("embed", "head_dim"), {"embed": None}, Mesh16),
]


@pytest.mark.parametrize("case", range(len(SPEC_CASES)))
def test_spec_for_and_its_drops_are_the_references(case):
    shape, axes, rules, mesh = SPEC_CASES[case]
    if isinstance(rules, str):
        rules, ref_rules = rules_for(get_config(rules)), ref_rules_for(ref_get_config(rules))
        assert rules == ref_rules
    else:
        ref_rules = rules
    drops, ref_drops = [], []
    got = shr.spec_for(shape, axes, rules, mesh, drops=drops)
    want = ref_shr.spec_for(shape, axes, ref_rules, mesh, drops=ref_drops)
    assert got == tuple(want)
    assert drops == ref_drops


def test_spec_for_records_each_drop_reason():
    drops = []
    s = shr.spec_for((16, 8192, 12, 100), ("experts", "embed", "kv_heads", "seq"),
                     {"experts": "data", "embed": "data", "kv_heads": "model", "seq": "pod"},
                     Mesh16, drops=drops)
    assert s == ("data", None, None, None)
    assert {d["dim"]: d["reason"] for d in drops} == {1: "duplicate", 2: "indivisible",
                                                      3: "missing-axis"}


def test_default_rules_and_arch_rules_are_the_references():
    from repro.configs.base import DEFAULT_RULES as REF_DEFAULT

    assert DEFAULT_RULES == REF_DEFAULT
    for arch in ARCH_IDS:
        assert get_config(arch).sharding_rules == ref_get_config(arch).sharding_rules
        assert rules_for(get_config(arch)) == ref_rules_for(ref_get_config(arch))


def _ref_leaf_specs(arch, mesh, drops_out=None):
    """The reference's spec and drops of each leaf, mapped onto the port's
    layout: a stacked group's leaf once per layer, its 'layers' dim left out."""
    cfg = ref_get_config(arch)
    rules = ref_rules_for(cfg)
    abstract, axes = ref_params.abstract_params(cfg), ref_params.logical_axes(cfg)
    is_axes = lambda x: isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)

    def leaf(a, ax):
        drops = []
        spec = tuple(ref_shr.spec_for(a.shape, ax, rules, mesh, drops=drops))
        if ax and ax[0] == "layers":
            spec = spec[1:]
            drops = [dict(d, dim=d["dim"] - 1) for d in drops]
        return spec, drops

    out = jax.tree_util.tree_map(leaf, abstract, axes, is_leaf=is_axes)

    def unstack(groups, shapes):
        layers = []
        for (period, repeat), g in zip(shapes, groups):
            layers.append([g["layers"][i] for _ in range(repeat) for i in range(period)])
        return layers

    shapes = [(len(g.period), g.repeat) for g in cfg.groups()]
    res = {k: v for k, v in out.items() if k not in ("groups", "encoder")}
    res["groups"] = [{"layers": ls} for ls in unstack(out["groups"], shapes)]
    if "encoder" in out:
        res["encoder"] = {"groups": [{"layers": ls} for ls in
                                     unstack(out["encoder"]["groups"],
                                             [(1, cfg.n_encoder_layers)])],
                          "final_norm": out["encoder"]["final_norm"]}
    return res


def _pairs(t):
    """The (spec, drops) leaves of a tree whose leaves are such pairs."""
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _pairs(t[k])]
    if isinstance(t, list):
        return [x for c in t for x in _pairs(c)]
    return [t]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_and_fallbacks_are_the_references(arch, mesh):
    m = MESHES[mesh]
    cfg = get_config(arch)
    want = _pairs(_ref_leaf_specs(arch, m))
    specs = params.model_specs(cfg)
    leaves = tree.leaves(specs)
    shardings = tree.leaves(shr.param_shardings(cfg, m))
    assert len(leaves) == len(want) == len(shardings)
    got_specs = [sh.spec for sh in shardings]
    assert got_specs == [w[0] for w in want]
    fallbacks = shr.param_fallbacks(cfg, m)
    assert [{k: v for k, v in e.items() if k not in ("param", "shape", "bytes")}
            for e in fallbacks] == [d for w in want for d in w[1]]
    for e in fallbacks:
        assert e["bytes"] > 0 and e["param"] in tree.paths(specs)
    for p, s in zip(leaves, got_specs):           # valid by construction
        for dim, part in zip(p.shape, s):
            assert part is None or dim % m.shape[part] == 0


def test_logical_axes_are_the_references_without_layers():
    cfg = get_config("jamba_1_5_large")
    ax = params.logical_axes(cfg)
    assert ax["groups"][0]["layers"][1]["ffn"]["wi"] == ("experts", "embed", "expert_mlp")
    assert ax["embed"] == ("vocab", "embed")
    ref_ax = ref_params.logical_axes(ref_get_config("jamba_1_5_large"))
    assert ref_ax["groups"][0]["layers"][1]["ffn"]["wi"] == ("layers", "experts", "embed",
                                                             "expert_mlp")


def test_param_fallbacks_names_gqa_kv_replication():
    entries = shr.param_fallbacks(get_config("llama3_8b"), Mesh32)
    kv = [e for e in entries if e["reason"] == "indivisible"]
    assert kv and all(e["mesh_axis_size"] == 32 and e["dim_size"] % 32 for e in kv)
    assert {e["param"].rsplit("/", 1)[1] for e in kv} == {"wk", "wv"}


BATCH_CASES = [(Mesh2x16, 16), (Mesh2x16, 64), (Mesh2x16, 7), (Mesh2x16, None),
               (Mesh16, 48), (Mesh16, 10)]


@pytest.mark.parametrize("case", range(len(BATCH_CASES)))
def test_batch_partition_and_data_spec_are_the_references(case):
    mesh, b = BATCH_CASES[case]
    assert shr.batch_partition(mesh, b) == ref_shr.batch_partition(mesh, b)
    assert shr.batch_axes(mesh) == ref_shr.batch_axes(mesh)
    for kw in ({}, {"seq_dim": 1, "seq_axis": "model"}, {"batch_dim": 1}):
        assert shr.data_spec(mesh, 3, batch_size=b, **kw) == tuple(
            ref_shr.data_spec(mesh, 3, batch_size=b, **kw))


def test_batch_partition_regression_pod2_data16():
    assert shr.batch_partition(Mesh2x16, 16) == ("pod",)
    assert shr.data_spec(Mesh2x16, 2, batch_size=64) == (("pod", "data"), None)


def test_placements_split_a_dim_over_pod_and_data():
    from torch.distributed.tensor import Replicate, Shard

    assert shr.placements((("pod", "data"), None), Mesh2x16) == (Shard(0), Shard(0),
                                                                Replicate())
    assert shr.placements((None, "model"), Mesh16) == (Replicate(), Shard(1))
    assert shr.replicated(Mesh16).placements == (Replicate(), Replicate())


def test_the_active_mesh_nests_and_suspends():
    assert shr.active_mesh() is None
    with shr.use_mesh(Mesh16):
        assert shr.active_mesh() is Mesh16
        with shr.suspend_mesh():
            assert shr.active_mesh() is None
        with shr.use_mesh(Mesh2x16):
            assert shr.active_mesh() is Mesh2x16
        assert shr.active_mesh() is Mesh16
    assert shr.active_mesh() is None


def test_shard_dim_leaves_plain_tensors_alone():
    x = torch.ones(4, 8)
    assert shr.shard_dim(x, 1) is x
    with shr.use_mesh(Mesh16):
        assert shr.shard_dim(x, 1) is x


def test_mesh_shape_reads_both_kinds_of_mesh():
    class Dev:                        # DeviceMesh's shape is a tuple
        shape = (2, 4)
        mesh_dim_names = ("data", "model")

    assert shr.mesh_shape(Dev) == {"data": 2, "model": 4}
    assert shr.mesh_shape(Mesh16) == {"data": 16, "model": 16}


# ---------------------------------------------------------------- the meshes

def test_make_host_mesh_refuses_more_model_ranks_than_exist():
    with pytest.raises(ValueError, match="exceeds the 1 available rank"):
        mesh_lib.make_host_mesh(model=2, device_type="cpu")
    with pytest.raises(ValueError, match="start more"):
        mesh_lib.make_host_mesh(model=2, device_type="cpu")


def test_make_host_mesh_refuses_model_below_one():
    with pytest.raises(ValueError, match="must be >= 1"):
        mesh_lib.make_host_mesh(model=0, device_type="cpu")


def test_make_host_mesh_needs_a_process_group():
    with pytest.raises(ValueError, match="no process group"):
        mesh_lib.make_host_mesh(model=1, device_type="cpu")


@pytest.mark.parametrize("multi_pod", [False, True])
def test_make_production_mesh_needs_its_ranks(multi_pod):
    with pytest.raises(ValueError, match="512" if multi_pod else "256"):
        mesh_lib.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    with pytest.raises(ValueError, match="divide"):
        mesh_lib.make_production_mesh(model=3, device_type="cpu")


def test_a_failing_rank_fails_the_run_within_seconds():
    """Rank 1 raises while rank 0 waits at a barrier that cannot complete:
    the run fails, names rank 1, and kills rank 0 long before the
    collectives' timeout."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed") as e:
        mesh_lib.run_ranks(_torch_mesh.failing_rank, 2, 1, device_type="cpu", timeout_s=120.0)
    assert "planted failure on rank 1" in str(e.value)
    assert time.monotonic() - t0 < 60.0
