"""The port's checkpoints: the cases of tests/test_checkpoint.py on torch
trees, the on-disk contract shared with the reference (each package reads
the other's checkpoint of the same tree, bit for bit), a TrainState, and
the writer's copy to the host."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as ref_ck
from repro_torch import tree
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as ck
from repro_torch.train.step import TrainState, init_state
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.int32, torch.int8,
          torch.uint32, torch.bool]


def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.ones(5, dtype=torch.bfloat16) * 1.5,
                       "c": torch.tensor(3, dtype=torch.int32)}}


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a, b))


def test_roundtrip_bit_exact(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 7, t)
    step, restored = ck.restore_latest(str(tmp_path), t)
    assert step == 7
    assert all(_same(a, b) for a, b in zip(tree.leaves(t), tree.leaves(restored)))


def test_latest_and_gc(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ck.save(str(tmp_path), s, _tree(), keep=2)
    assert ck.latest_step(str(tmp_path)) == 5
    assert sorted(ck.all_steps(str(tmp_path))) == [4, 5]


def test_incomplete_and_leftover_checkpoints(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 1, t)
    broken = tmp_path / "step_0000000002"       # a crash mid-write: no marker
    broken.mkdir()
    (broken / "meta.json").write_text("{}")
    (tmp_path / "step_0000000003.tmp").mkdir()  # a writer killed before its rename
    assert ck.latest_step(str(tmp_path)) == 1
    assert ck.restore_latest(str(tmp_path), t)[0] == 1
    with pytest.raises(FileNotFoundError, match="incomplete"):
        ck.restore(str(tmp_path), 2, t)
    ck.save(str(tmp_path), 3, t)                # replaces the leftover .tmp
    assert ck.latest_step(str(tmp_path)) == 3 and not (tmp_path / "step_0000000003.tmp").exists()


def test_restore_missing_returns_like(tmp_path):
    t = _tree()
    step, restored = ck.restore_latest(str(tmp_path / "nope"), t)
    assert step is None and restored is t


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_dtype_survives_the_byte_roundtrip(tmp_path, dtype):
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 100, (4, 5))).to(dtype)
    t = {"x": x, "scalar": x[0, 0].clone()}
    ck.save(str(tmp_path), 1, t)
    _, r = ck.restore_latest(str(tmp_path), t)
    assert _same(r["x"], x) and _same(r["scalar"], t["scalar"])


def test_the_on_disk_contract_is_the_references(tmp_path):
    """Leaf order, raw bytes and dtype names agree: the reference restores
    the port's checkpoint and the port the reference's, bit for bit."""
    rng = np.random.default_rng(1)
    arrays = {"w": rng.normal(size=(3, 4)).astype(np.float32),
              "groups": [{"b": rng.normal(size=(5,)).astype(np.float32)},
                         {"b": rng.normal(size=(2,)).astype(np.float32)}],
              "step": np.asarray(9, np.int32)}
    ref_tree = jax.tree_util.tree_map(jnp.asarray, arrays)
    ref_tree["half"] = jnp.arange(6, dtype=jnp.bfloat16) / 3
    port_tree = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), arrays)
    port_tree["half"] = torch.from_numpy(np.array(ref_tree["half"]).view(np.int16)).view(
        torch.bfloat16)
    assert tree.paths(port_tree) == ["groups/0/b", "groups/1/b", "half", "step", "w"]
    ck.save(str(tmp_path / "port"), 4, port_tree)
    ref_ck.save(str(tmp_path / "ref"), 4, ref_tree)
    mine = np.load(tmp_path / "port" / "step_0000000004" / "arrays.npz")
    theirs = np.load(tmp_path / "ref" / "step_0000000004" / "arrays.npz")
    assert sorted(mine.files) == sorted(theirs.files)
    for k in mine.files:
        np.testing.assert_array_equal(mine[k], theirs[k])
    m1 = json.loads((tmp_path / "port" / "step_0000000004" / "meta.json").read_text())
    m2 = json.loads((tmp_path / "ref" / "step_0000000004" / "meta.json").read_text())
    assert (m1["dtypes"], m1["n_leaves"]) == (m2["dtypes"], m2["n_leaves"])
    # The one difference: the reference writes the 0-d step's shape as [1].
    assert m1["shapes"] == [[5], [2], [6], [], [3, 4]] and m2["shapes"][3] == [1]
    _, got = ck.restore_latest(str(tmp_path / "ref"), port_tree)
    _, back = ref_ck.restore_latest(str(tmp_path / "port"), ref_tree)
    for a, b, c in zip(tree.leaves(port_tree), tree.leaves(got), jax.tree_util.tree_leaves(back)):
        assert _same(a, b)
        np.testing.assert_array_equal(np.asarray(c).reshape(-1).view(np.uint8),
                                      ck._raw_bytes(a))


def test_train_state_roundtrip_and_copy_to_host(tmp_path):
    """A TrainState (bf16 params, f32 moments, int32 steps) comes back leaf
    for leaf on the device asked for; what was saved stays as it was when
    the tensors change afterwards in place."""
    params = {"embed": torch.randn(8, 4).to(torch.bfloat16), "norm": torch.ones(4)}
    state = init_state(None, params, adamw.AdamWConfig())
    state = TrainState(params, state.opt._replace(step=torch.tensor(5, dtype=torch.int32)),
                       torch.tensor(5, dtype=torch.int32))
    want = [t.clone() for t in tree.leaves(state)]
    ck.save(str(tmp_path), 5, state)
    params["embed"].mul_(2)
    meta = json.loads((tmp_path / "step_0000000005" / "meta.json").read_text())
    assert meta["paths"] == ["params/embed", "params/norm", "opt/step", "opt/m/embed",
                             "opt/m/norm", "opt/v/embed", "opt/v/norm", "step"]
    assert meta["dtypes"][0] == "bfloat16" and os.path.exists(
        tmp_path / "step_0000000005" / "COMPLETE")
    _, r = ck.restore_latest(str(tmp_path), state, device="cpu")
    assert isinstance(r, TrainState) and isinstance(r.opt, adamw.AdamWState)
    assert all(_same(a, b) for a, b in zip(want, tree.leaves(r)))
    with pytest.raises(ValueError, match="leaves"):
        ck.restore(str(tmp_path), 5, {"x": torch.zeros(1)})
