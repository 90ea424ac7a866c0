"""The port's Mamba-2 (SSD) mixer against ``repro.models.mamba2`` on the same
inputs and weights.

The weights are the reference's own init of the mamba2 smoke model in f32
(``convert.params_from_reference``), the activations come from a seed
through numpy. The packages sum the scan's matmuls in different orders
(the port writes the three-operand einsums as batched matmuls) and use
different exp and log implementations, so outputs, final states and conv
tails are held to ``RTOL`` of their largest value (measured: <= 3e-7 on the
outputs); the tails are copies of the projections and held the same way.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.core.division_modes import DivisionConfig as RefDivisionConfig
from repro.models import mamba2 as ref_mamba
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core.division_modes import DivisionConfig
from repro_torch.models import mamba2
from _ref_params import ref_init
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-5
MODES = ["exact", "taylor_pallas"]


def _setup(mode="exact", a_log=None, **kw):
    """(ref cfg, port cfg, ref layer-0 params, port layer-0 params); with
    ``a_log`` every head's A_log is set to it (A = -e^a_log)."""
    div = dict(mode=mode, schedule="paper")
    rc = dataclasses.replace(ref_smoke_config("mamba2_780m"), param_dtype="float32",
                             division=RefDivisionConfig(**div), **kw)
    pc = dataclasses.replace(get_smoke_config("mamba2_780m"), param_dtype="float32",
                             division=DivisionConfig(**div), **kw)
    rp = ref_init(rc, 0)["groups"][0]["layers"][0]["mamba"]
    rp = {k: np.asarray(v)[0] for k, v in rp.items()}     # layer 0 of the stack
    if a_log is not None:
        rp["A_log"] = np.full_like(rp["A_log"], a_log)
    pp = {k: convert.tensor_from_numpy(v, "cpu") for k, v in rp.items()}
    return rc, pc, {k: jnp.asarray(v) for k, v in rp.items()}, pp


def _x(cfg, b, l, seed=1):
    return np.random.default_rng(seed).normal(size=(b, l, cfg.d_model)).astype(np.float32)


def _close(got, want):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert scale > 0
    rel = np.abs(got - want).max() / scale
    assert rel <= RTOL, rel


@pytest.mark.parametrize("lengths", [None, [48, 2, 31]], ids=["unpadded", "lengths"])
@pytest.mark.parametrize("a_log", [None, float(np.log(12.0))], ids=["init", "steep"])
def test_mixer_output_state_and_conv_tails_match_the_reference(lengths, a_log):
    """Three chunks of 16; with ``lengths`` one row (2 tokens) is shorter
    than the conv window's conv_width - 1 = 3 tail positions; ``steep``
    sums a chunk's dt*A below -88, where exp(ac_i - ac_j) overflows above
    the diagonal. (The gated norm's kernel modes: the decode test below.)"""
    rc, pc, rp, pp = _setup("exact", a_log)
    x = _x(rc, 3, 48)
    lv = None if lengths is None else np.array(lengths, np.int32)
    want, wcache = ref_mamba.mamba_mixer(rp, jnp.asarray(x), rc, return_state=True,
                                         lengths=None if lv is None else jnp.asarray(lv))
    got, gcache = mamba2.mamba_mixer(pp, torch.from_numpy(x), pc, return_state=True,
                                     lengths=None if lv is None else torch.from_numpy(lv))
    _close(got, want)
    assert set(gcache) == set(wcache) == {"state", "conv_x", "conv_B", "conv_C"}
    for k in gcache:
        _close(gcache[k], wcache[k])
    if lv is not None:        # the short row's tail: zeros, then its 2 real positions
        assert torch.all(gcache["conv_x"][1, 0] == 0)
        torch.testing.assert_close(gcache["conv_x"][1, 1:],
                                   torch.from_numpy(x[1, :2]) @ pp["wx"])


def test_padded_rows_end_in_the_state_of_their_real_tokens():
    """``lengths`` makes pad tokens no-ops: a padded row's state and tails
    are those of the row run alone at its real length (one chunk of 16)."""
    _, pc, _, pp = _setup()
    x = torch.from_numpy(_x(pc, 2, 32, seed=2))
    _, padded = mamba2.mamba_mixer(pp, x, pc, return_state=True,
                                   lengths=torch.tensor([32, 16]))
    _, alone = mamba2.mamba_mixer(pp, x[1:, :16], pc, return_state=True)
    for k in padded:
        torch.testing.assert_close(padded[k][1:], alone[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("chunk", [8, 16])
def test_chunked_scan_equals_one_chunk(chunk):
    """The chunked SSD (inter-chunk state carried through a loop) equals
    one chunk over the whole sequence, in the port and in the reference."""
    rc, pc, rp, pp = _setup()
    x = _x(rc, 2, 32, seed=3)
    whole_cfg = dataclasses.replace(pc, ssm_chunk=32)
    whole, wstate = mamba2.mamba_mixer(pp, torch.from_numpy(x), whole_cfg, return_state=True)
    got, gstate = mamba2.mamba_mixer(pp, torch.from_numpy(x),
                                     dataclasses.replace(pc, ssm_chunk=chunk),
                                     return_state=True)
    torch.testing.assert_close(got, whole, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gstate["state"], wstate["state"], rtol=1e-5, atol=1e-5)
    want = ref_mamba.mamba_mixer(rp, jnp.asarray(x), dataclasses.replace(rc, ssm_chunk=chunk))
    _close(got, want)
    with pytest.raises(ValueError, match="divisible by chunk"):
        mamba2.mamba_mixer(pp, torch.from_numpy(x[:, :20]), pc)


@pytest.mark.parametrize("mode", MODES)
def test_prefill_state_then_decode_steps_match_the_full_forward(mode):
    """Prefill 16 tokens (state and conv tails), then 8 decode_mamba steps:
    each step's output equals the full forward's at that position, and the
    reference's decode_mamba from the reference's own cache."""
    rc, pc, rp, pp = _setup(mode)
    x = _x(rc, 2, 24, seed=4)
    full = mamba2.mamba_mixer(pp, torch.from_numpy(x), dataclasses.replace(pc, ssm_chunk=8))
    _, cache = mamba2.mamba_mixer(pp, torch.from_numpy(x[:, :16]), pc, return_state=True)
    _, rcache = ref_mamba.mamba_mixer(rp, jnp.asarray(x[:, :16]), rc, return_state=True)
    scale = float(full.abs().max())
    for t in range(16, 24):
        out, cache = mamba2.decode_mamba(pp, torch.from_numpy(x[:, t:t + 1]), cache, pc)
        assert float((out[:, 0] - full[:, t]).abs().max()) / scale < RTOL
        want, rcache = ref_mamba.decode_mamba(rp, jnp.asarray(x[:, t:t + 1]), rcache, rc)
        _close(out, want)
        _close(cache["state"], rcache["state"])


def test_decode_from_a_zero_cache_is_the_mixer_on_one_token():
    _, pc, _, pp = _setup()
    x = torch.from_numpy(_x(pc, 2, 1, seed=5))
    cache = mamba2.init_cache_mamba(pc, 2)
    assert cache["state"].shape == (2, pc.ssm_heads, pc.ssm_head_dim, pc.ssm_state)
    assert cache["conv_x"].shape == (2, pc.conv_width - 1, pc.d_inner)
    out, new = mamba2.decode_mamba(pp, x, cache, pc)
    # lengths: a tail shorter than the window is zero-filled, as in a fresh cache
    want, wstate = mamba2.mamba_mixer(pp, x, pc, return_state=True,
                                      lengths=torch.tensor([1, 1]))
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(new["state"], wstate["state"], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(new["conv_x"], wstate["conv_x"])


def test_segsum_decay_past_the_exp_overflow_is_finite_and_the_references():
    """A chunk whose cumsum of dt*A falls to ~-240: exp(ac_i - ac_j) above
    the diagonal overflows to inf (so exp(diff) * mask would be NaN); the
    decay matrix must be finite, 0 above the diagonal, and the reference's."""
    a = -np.random.default_rng(6).uniform(5.0, 10.0, (2, 3, 32)).astype(np.float32)
    assert a.cumsum(-1).min() < -88
    ac = torch.from_numpy(a).cumsum(-1)
    assert torch.isinf(torch.exp(ac[..., :, None] - ac[..., None, :])).any()
    got = mamba2._segsum_decay(torch.from_numpy(a))
    want = ref_mamba._segsum_decay(jnp.asarray(a))
    assert torch.all(got.triu(1) == 0)
    _close(got, want)        # the cumsums' orders differ: ~2 ulp of 240 in diff


def test_softplus_is_the_references_beyond_the_threshold():
    """jax.nn.softplus is logaddexp(x, 0); F.softplus returns x above 20.
    Below ~-87 the result is subnormal: XLA on the CPU flushes it to 0, the
    port keeps it (ROADMAP F4)."""
    x = np.array([-100.0, -20.0, -1.0, 0.0, 1.0, 19.9, 20.0, 20.5, 40.0, 100.0], np.float32)
    got = mamba2._softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    normal = want >= np.finfo(np.float32).tiny
    np.testing.assert_allclose(got[normal], want[normal], rtol=1e-6, atol=0)
    assert (~normal).sum() == 1 and want[0] == 0 and 0 < got[0] < np.finfo(np.float32).tiny
