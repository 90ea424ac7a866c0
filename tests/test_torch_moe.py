"""The port's MoE FFN against the reference's ``moe_ffn`` on the same inputs.

Inputs come from a seed through numpy; the router, expert and shared
weights are the reference's own init carried across bit for bit. Each
dispatch (``cumsum``, ``sort``, and ``local`` as one shard) runs at a small
``capacity_factor`` so that tokens drop, in every non-ILM division mode: the
drops must be the reference's, so the outputs agree to ``RTOL`` of their
largest value (the packages sum the expert matmuls in different orders;
measured <= 3e-7) and the aux losses to ``AUX_RTOL``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.core.division_modes import DivisionConfig as RefDivisionConfig
from repro.models import moe as ref_moe
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core.division_modes import DivisionConfig
from repro_torch.models import moe
from _ref_params import ref_init
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

DISPATCHES = ["cumsum", "sort", "local"]
NON_ILM = ["exact", "taylor", "taylor_pallas", "goldschmidt", "goldschmidt_pallas"]
RTOL = 1e-6
AUX_RTOL = 1e-6


def _setup(dispatch, mode, cf, seed=0):
    kw = dict(param_dtype="float32", moe_dispatch=dispatch, capacity_factor=cf)
    rc = dataclasses.replace(ref_smoke_config("deepseek_moe_16b"),
                             division=RefDivisionConfig(mode=mode), **kw)
    pc = dataclasses.replace(get_smoke_config("deepseek_moe_16b"),
                             division=DivisionConfig(mode=mode), **kw)
    rp = ref_init(rc, seed)["groups"][1]["layers"][0]["ffn"]
    rp = jax.tree_util.tree_map(lambda a: np.asarray(a)[0], rp)       # MoE layer 1
    pp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), rp)
    return rc, pc, rp, pp


def _run(rc, pc, rp, pp, x):
    want, want_aux = ref_moe.moe_ffn(jax.tree_util.tree_map(jnp.asarray, rp),
                                     jnp.asarray(x), rc)
    got, got_aux = moe.moe_ffn(pp, torch.from_numpy(x), pc)
    return np.asarray(want), float(want_aux), got.numpy(), float(got_aux)


def _drops(cfg, x, rp):
    """How many (token, choice) pairs the reference drops at cfg's capacity."""
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ rp["router"]
    idx = np.argsort(-logits, axis=-1, kind="stable")[:, :cfg.experts_per_tok]
    counts = np.bincount(idx.reshape(-1), minlength=cfg.n_experts)
    cap = moe.capacity(cfg, x.shape[0] * x.shape[1])
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("mode", NON_ILM)
@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_dispatch_matches_the_reference_drops_included(dispatch, mode):
    rc, pc, rp, pp = _setup(dispatch, mode, cf=0.5)
    x = np.random.default_rng(3).normal(size=(2, 24, pc.d_model)).astype(np.float32)
    assert _drops(pc, x, rp) > 0                  # the case drops tokens
    want, want_aux, got, got_aux = _run(rc, pc, rp, pp, x)
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()
    np.testing.assert_allclose(got_aux, want_aux, rtol=AUX_RTOL)


def test_the_dispatches_agree_where_capacity_floors_agree():
    """cumsum and sort give the same positions; local (one shard) differs
    only in its capacity floor, so above both floors all three are equal."""
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 24, 64)).astype(np.float32))
    outs = []
    for dispatch in DISPATCHES:
        _, pc, _, pp = _setup(dispatch, "taylor", cf=0.75)
        outs.append(moe.moe_ffn(pp, x, pc))
    for out, aux in outs[1:]:
        assert torch.equal(out, outs[0][0]) and torch.equal(aux, outs[0][1])


def test_capacity_is_the_reference_formula():
    cfg = get_smoke_config("deepseek_moe_16b")             # E = 8, k = 2
    for T, cf in ((1, 1.25), (2, 1.25), (3, 0.5), (48, 1.25), (48, 0.5), (4096, 1.25)):
        for dispatch, floor in (("cumsum", 8), ("sort", 8), ("local", 4)):
            c = dataclasses.replace(cfg, capacity_factor=cf, moe_dispatch=dispatch)
            want = max(int(np.ceil(T * 2 / 8 * cf)), min(T * 2, floor))
            assert moe.capacity(c, T) == want, (T, cf, dispatch)


def test_top_k_resolves_ties_as_lax_top_k():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 4, (64, 16)).astype(np.float32) / 4      # many ties
    x[0] = 0.25                                                    # a whole row
    for k in (1, 2, 6, 16):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = moe.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_tied_router_probabilities_route_as_the_reference(dispatch):
    """A zero router ties every expert on every token: both packages send
    each token to experts 0..k-1, and capacity drops the later tokens."""
    rc, pc, rp, pp = _setup(dispatch, "taylor_pallas", cf=0.5)
    rp = dict(rp, router=np.zeros_like(rp["router"]))
    pp = dict(pp, router=torch.zeros_like(pp["router"]))
    x = np.random.default_rng(6).normal(size=(1, 16, pc.d_model)).astype(np.float32)
    want, want_aux, got, got_aux = _run(rc, pc, rp, pp, x)
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()
    np.testing.assert_allclose(got_aux, want_aux, rtol=AUX_RTOL)


def test_params_from_reference_maps_the_moe_leaves():
    rc = dataclasses.replace(ref_smoke_config("deepseek_moe_16b"), param_dtype="float32")
    pc = dataclasses.replace(get_smoke_config("deepseek_moe_16b"), param_dtype="float32")
    rp = jax.tree_util.tree_map(np.asarray, ref_init(rc, 2))
    pp = convert.params_from_reference(rp, pc, "cpu")
    assert [len(g["layers"]) for g in pp["groups"]] == [1, 2]
    for r in range(2):                                    # the stacked MoE group
        ffn = pp["groups"][1]["layers"][r]["ffn"]
        for name in ("router", "wi", "wg", "wo"):
            np.testing.assert_array_equal(ffn[name].numpy(),
                                          rp["groups"][1]["layers"][0]["ffn"][name][r])
        np.testing.assert_array_equal(ffn["shared"]["wo"].numpy(),
                                      rp["groups"][1]["layers"][0]["ffn"]["shared"]["wo"][r])
        assert ffn["wi"].shape == (8, 64, 64) and ffn["router"].dtype == torch.float32
    np.testing.assert_array_equal(pp["groups"][0]["layers"][0]["ffn"]["wi"].numpy(),
                                  rp["groups"][0]["layers"][0]["ffn"]["wi"])
