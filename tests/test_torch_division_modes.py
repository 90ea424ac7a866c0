"""The port's mode dispatch against the reference's, lane for lane.

Configs round-trip from the reference's ``dataclasses.asdict``; every
approximate mode gives the reference's bits on a seeded corpus with
subnormal operands, under both underflow policies (the ILM mode's own
checks are in ``test_torch_ilm.py``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import division_modes as ref_dm
from repro_torch import convert
from repro_torch.core import division_modes as dm
from test_torch_tsdiv import A, X, assert_bits_equal
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TWIN_MODES = ["taylor", "goldschmidt"]
KERNEL_MODES = ["taylor_pallas", "goldschmidt_pallas"]


def _subnormals(seed, n=512):
    rng = np.random.default_rng(seed)
    bits = rng.integers(1, 2**23, n, dtype=np.int64).astype(np.uint32)
    bits |= rng.integers(0, 2, n).astype(np.uint32) << 31
    return bits.view(np.float32)


XS = np.concatenate([X[:4096], _subnormals(21)])
AS = np.concatenate([A[:4096], _subnormals(22)])


def test_modes_and_fields_match_reference():
    assert dm.MODES == ref_dm.MODES
    ref_fields = [(f.name, f.default) for f in dataclasses.fields(ref_dm.DivisionConfig)]
    assert [(f.name, f.default) for f in dataclasses.fields(dm.DivisionConfig)] == ref_fields


@pytest.mark.parametrize("kw", [
    dict(), dict(mode="goldschmidt_pallas", n_iters=1, precision_bits=12),
    dict(mode="taylor", schedule="paper", underflow="ftz", rsqrt_newton=3),
    dict(mode="ilm", rsqrt_segments=8)])
def test_config_round_trips_from_reference(kw):
    ref = ref_dm.DivisionConfig(**kw)
    cfg = convert.config_from_reference(dataclasses.asdict(ref))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    np.testing.assert_array_equal(cfg.table.slopes, ref.table.slopes)
    assert cfg.gs_iters == ref.gs_iters


def test_config_validation():
    with pytest.raises(ValueError):
        dm.DivisionConfig(mode="nope")
    with pytest.raises(ValueError):
        dm.DivisionConfig(underflow="nope")


@pytest.mark.parametrize("mode", dm.MODES)
def test_effective_underflow(mode):
    """Equal to the reference, except mode="exact": torch keeps subnormals
    on the CPU and on CUDA, where XLA on the CPU flushes (ROADMAP F4)."""
    for underflow in ("gradual", "ftz"):
        cfg = dm.DivisionConfig(mode=mode, underflow=underflow)
        want = ref_dm.effective_underflow(ref_dm.DivisionConfig(mode=mode,
                                                                underflow=underflow))
        if mode == "exact":
            assert (want, dm.effective_underflow(cfg)) == ("ftz", "gradual")
        else:
            assert dm.effective_underflow(cfg) == want


def test_exact_mode_keeps_subnormals():
    x = torch.tensor([3.0 * 2.0 ** -140])
    assert dm.div(x, torch.tensor([3.0]), dm.EXACT).item() == 2.0 ** -140


def _cfgs(modes):
    for mode in modes:
        for schedule in ("paper", "factored"):
            for underflow in ("gradual", "ftz"):
                if mode.startswith("goldschmidt") and schedule == "paper":
                    continue
                yield mode, schedule, underflow


@pytest.mark.parametrize("mode,schedule,underflow", list(_cfgs(TWIN_MODES + KERNEL_MODES)))
def test_recip_div_bit_exact_vs_reference(mode, schedule, underflow):
    kw = dict(mode=mode, schedule=schedule, underflow=underflow)
    ref, cfg = ref_dm.DivisionConfig(**kw), dm.DivisionConfig(**kw)
    assert_bits_equal(dm.recip(torch.from_numpy(XS), cfg),
                      ref_dm.recip(jnp.asarray(XS), ref))
    assert_bits_equal(dm.div(torch.from_numpy(AS), torch.from_numpy(XS), cfg),
                      ref_dm.div(jnp.asarray(AS), jnp.asarray(XS), ref))


@pytest.mark.parametrize("mode", TWIN_MODES + KERNEL_MODES)
@pytest.mark.parametrize("underflow", ["gradual", "ftz"])
@pytest.mark.parametrize("newton", [2, 3])
def test_rsqrt_bit_exact_vs_reference(mode, underflow, newton):
    kw = dict(mode=mode, underflow=underflow, rsqrt_newton=newton)
    x = np.abs(XS)
    assert_bits_equal(dm.rsqrt(torch.from_numpy(x), dm.DivisionConfig(**kw)),
                      ref_dm.rsqrt(jnp.asarray(x), ref_dm.DivisionConfig(**kw)))


@pytest.mark.parametrize("mode", TWIN_MODES + KERNEL_MODES)
def test_div_broadcasts_scalars_and_promotes_bf16(mode):
    d2 = np.abs(XS[np.isfinite(XS)][:1024]).reshape(32, 32)
    cfg, ref = dm.DivisionConfig(mode=mode), ref_dm.DivisionConfig(mode=mode)
    got = dm.div(torch.from_numpy(d2), torch.tensor(16.0), cfg)
    assert got.shape == (32, 32)
    assert_bits_equal(got, ref_dm.div(jnp.asarray(d2), jnp.float32(16.0), ref))
    mixed = dm.div(torch.from_numpy(d2).to(torch.bfloat16), torch.from_numpy(d2), cfg)
    assert mixed.dtype == torch.float32
    assert_bits_equal(mixed, ref_dm.div(jnp.asarray(d2).astype(jnp.bfloat16),
                                        jnp.asarray(d2), ref))


@pytest.mark.parametrize("mode", KERNEL_MODES)
def test_kernel_modes_without_a_kernel_dtype_run_the_ftz_twin_on_cpu(mode):
    x = XS[np.abs(XS) < 6e4][:256].astype(np.float16)
    cfg, ref = dm.DivisionConfig(mode=mode), ref_dm.DivisionConfig(mode=mode)
    got = dm.recip(torch.from_numpy(x), cfg)
    want = np.asarray(ref_dm.recip(jnp.asarray(x), ref))
    assert got.dtype == torch.float16
    np.testing.assert_array_equal(got.numpy().view(np.uint16)[~np.isnan(want)],
                                  want.view(np.uint16)[~np.isnan(want)])


def test_not_ported_parts_raise():
    """Every mode of every division-unit op and consumer runs now (the ILM
    modes and attention included), and every model family of the reference
    resolves (the SSM, encoder-decoder and embedding-input ones included);
    what the reference refuses, an unknown architecture, is still refused."""
    from repro_torch.configs import ARCH_IDS, get_config

    x = torch.ones(1, 4, 16)
    ilm = dm.DivisionConfig(mode="ilm")
    for call in (lambda: dm.recip(x, ilm), lambda: dm.div(x, x, ilm),
                 lambda: dm.rsqrt(x, ilm), lambda: dm.softmax(x, -1, ilm),
                 lambda: dm.rmsnorm(x, x[0, 0], ilm), lambda: dm.attention(x, x, x, ilm),
                 lambda: dm.attention(x, x, x)):
        assert bool(torch.isfinite(call()).all())
    assert {get_config(a).family for a in ARCH_IDS} >= {"ssm", "hybrid", "audio", "vlm"}
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("mamba3_780m")
