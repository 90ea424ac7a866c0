"""Mamba-2 (SSD, state-space duality) mixer: chunked train/prefill and the
recurrent decode step.

The PyTorch counterpart of ``src/repro/models/mamba2.py``, with its
parameters (split ``wz/wx/wB/wC/wdt`` projections, a depthwise causal conv
per part) and its semantics (arXiv:2405.21060, listing 1), per head:

  state:  S_t = exp(dt_t * A) S_{t-1} + dt_t * x_t B_t^T
  output: y_t = S_t C_t + D * x_t

The chunked form adds, per chunk of ``ssm_chunk`` tokens, an intra-chunk
term through the decay matrix L[i, j] = exp(a_i - a_j) (i >= j, a the
within-chunk cumsum of dt*A) and the state carried in from the chunks
before. The reference's three-operand einsums are written as batched
matmuls over (batch, chunk) so that no (b, nc, q, h, n) product is ever
materialised; the sums run in another order than XLA's. The output goes
through the gated RMSNorm, the division unit's consumer.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from .layers import rms_norm

__all__ = ["mamba_mixer", "init_cache_mamba", "abstract_cache_mamba", "decode_mamba"]


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0) (``F.softplus``
    returns x itself above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(u, w, width: int):
    """Depthwise causal conv by explicit shifts. u: (b, l, c); w: (width, c)."""
    out = u * w[-1]
    for k in range(1, width):
        out = out + F.pad(u, (0, 0, k, 0))[:, : u.shape[1]] * w[-1 - k]
    return out


def _segsum_decay(a):
    """L[i, j] = exp(cumsum_i - cumsum_j) where i >= j, else 0. a: (..., q).

    The entries above the diagonal are set to -inf before the exp: their
    exp(ac_i - ac_j) overflows once a chunk's dt*A sums below ~-88, and an
    inf times a 0 mask would be NaN."""
    q = a.shape[-1]
    ac = torch.cumsum(a, dim=-1)
    diff = ac[..., :, None] - ac[..., None, :]
    upper = ~torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return torch.exp(diff.masked_fill(upper, float("-inf")))


def _gated_out(p: Dict, y, z, x, cfg: ModelConfig):
    """y * silu(z), RMSNorm (cast to x's dtype, f32 weight), out-projection."""
    y = y * F.silu(z.to(torch.float32))
    y = rms_norm(y.to(x.dtype), p["norm"], cfg.division, cfg.norm_eps)
    return y @ p["wout"]


def _tail(u, wm1: int, lengths):
    """The last ``wm1`` real positions of each row of u (b, l, c): the
    decode conv window. Positions < 0 (a prompt shorter than the window)
    are zero, as in a fresh decode cache."""
    if lengths is None:
        return u[:, -wm1:]
    tpos = (lengths.to(torch.int64)[:, None] - wm1
            + torch.arange(wm1, device=u.device)[None, :])             # (b, wm1)
    g = torch.gather(u, 1, tpos.clamp_min(0)[:, :, None].expand(-1, -1, u.shape[2]))
    return torch.where((tpos >= 0)[:, :, None], g, 0).to(u.dtype)


def mamba_mixer(p: Dict, x, cfg: ModelConfig, *, initial_state=None,
                return_state: bool = False, lengths=None):
    """x: (b, l, d_model) -> (b, l, d_model), chunked over ``cfg.ssm_chunk``.

    ``lengths`` (the real lengths of a right-padded batch) zeroes dt at pad
    positions, so there the decay is exp(0) = 1 and the input dt*B*x is 0:
    the returned state is the state after each row's real tokens, and the
    conv tails are its last real positions. With ``return_state`` also
    returns the decode cache ``{"state", "conv_x", "conv_B", "conv_C"}``.
    """
    b, l, _ = x.shape
    h, pdim, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    q = min(cfg.ssm_chunk, l)
    if l % q:
        raise ValueError(f"seq {l} not divisible by chunk {q}")
    nc = l // q
    f32 = torch.float32

    z = x @ p["wz"]
    xs_raw = x @ p["wx"]
    B_raw = x @ p["wB"]
    C_raw = x @ p["wC"]
    dt_raw = (x @ p["wdt"]).to(f32)

    xs = F.silu(_causal_conv(xs_raw, p["conv_x"], cfg.conv_width).to(f32))
    Bc = F.silu(_causal_conv(B_raw, p["conv_B"], cfg.conv_width).to(f32))
    Cc = F.silu(_causal_conv(C_raw, p["conv_C"], cfg.conv_width).to(f32))

    dt = _softplus(dt_raw + p["dt_bias"].to(f32))                     # (b, l, h)
    if lengths is not None:
        real = torch.arange(l, device=x.device)[None, :] < lengths.to(x.device)[:, None]
        dt = dt * real[:, :, None]
    A = -torch.exp(p["A_log"].to(f32))                                # (h,)
    xh = xs.reshape(b, l, h, pdim)

    xc = xh.reshape(b, nc, q, h, pdim)
    dtc = dt.reshape(b, nc, q, h)
    Bq = Bc.reshape(b * nc, q, n)
    Cq = Cc.reshape(b * nc, q, n)
    adt = dtc * A                                                     # (b, nc, q, h)

    # Intra-chunk: y_i = sum_{j <= i} (C_i . B_j) L[i, j] dt_j x_j, per head.
    Ldec = _segsum_decay(adt.transpose(-1, -2))                       # (b, nc, h, q, q)
    scores = (Cq @ Bq.transpose(1, 2)).reshape(b, nc, 1, q, q)
    xw = (xc * dtc[..., None]).permute(0, 1, 3, 2, 4)                 # (b, nc, h, q, p)
    y_intra = ((scores * Ldec) @ xw).permute(0, 1, 3, 2, 4)          # (b, nc, q, h, p)

    # Each chunk's end state S_c = sum_j exp(a_end - a_j) dt_j x_j B_j^T.
    acum = torch.cumsum(adt, dim=2)                                   # (b, nc, q, h)
    wj = torch.exp(acum[:, :, -1:, :] - acum) * dtc
    u = (xc * wj[..., None]).permute(0, 1, 3, 4, 2).reshape(b * nc, h * pdim, q)
    Sc = (u @ Bq).reshape(b, nc, h, pdim, n)

    # Across chunks: S_before(c) carried through each chunk's total decay.
    chunk_decay = torch.exp(acum[:, :, -1, :])                        # (b, nc, h)
    S = (torch.zeros((b, h, pdim, n), dtype=f32, device=x.device)
         if initial_state is None else initial_state.to(f32))
    S_prevs = []
    for c in range(nc):
        S_prevs.append(S)
        S = Sc[:, c] + chunk_decay[:, c, :, None, None] * S
    S_prev = torch.stack(S_prevs, dim=1)                              # (b, nc, h, p, n)

    # Inter-chunk: y_i += exp(a_i) S_before C_i.
    y_inter = (Cq @ S_prev.permute(0, 1, 4, 2, 3).reshape(b * nc, n, h * pdim))
    y_inter = y_inter.reshape(b, nc, q, h, pdim) * torch.exp(acum)[..., None]

    y = (y_intra + y_inter).reshape(b, l, h, pdim)
    y = y + p["D"].to(f32)[None, None, :, None] * xh
    out = _gated_out(p, y.reshape(b, l, h * pdim), z, x, cfg)
    if not return_state:
        return out
    wm1 = cfg.conv_width - 1
    return out, {"state": S, "conv_x": _tail(xs_raw, wm1, lengths),
                 "conv_B": _tail(B_raw, wm1, lengths),
                 "conv_C": _tail(C_raw, wm1, lengths)}


def _cache_leaves(cfg: ModelConfig, batch: int, dtype):
    """{name: (shape, dtype)} of the decode cache: the f32 state and the
    conv windows in ``dtype``."""
    h, pdim, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    wm1 = cfg.conv_width - 1
    return {"state": ((batch, h, pdim, n), torch.float32),
            "conv_x": ((batch, wm1, cfg.d_inner), dtype),
            "conv_B": ((batch, wm1, n), dtype),
            "conv_C": ((batch, wm1, n), dtype)}


def init_cache_mamba(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None):
    """A zero decode cache: the f32 state and the conv windows in ``dtype``."""
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in _cache_leaves(cfg, batch, dtype).items()}


def abstract_cache_mamba(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None,
                         fake_mode=None):
    """:func:`init_cache_mamba`'s tree as stand-ins that allocate nothing
    (``repro_torch.tree.abstract``)."""
    return {k: tree.abstract(shape, dt, device, fake_mode)
            for k, (shape, dt) in _cache_leaves(cfg, batch, dtype).items()}


def _conv_step(u_new, conv_state, w):
    """One token of the causal conv. u_new: (b, 1, c); conv_state: (b,
    width-1, c). The window's products are exact in f32 and summed there,
    rounded once (the reference's contraction with f32 accumulation)."""
    window = torch.cat([conv_state, u_new], dim=1)                    # (b, width, c)
    out = (window.to(torch.float32) * w.to(torch.float32)).sum(1).to(u_new.dtype)
    return out[:, None, :], window[:, 1:]


def decode_mamba(p: Dict, x, cache, cfg: ModelConfig):
    """One recurrent step. x: (b, 1, d_model). Returns (out, a new cache)."""
    b = x.shape[0]
    h, pdim = cfg.ssm_heads, cfg.ssm_head_dim
    f32 = torch.float32

    z = x @ p["wz"]
    dt_raw = (x @ p["wdt"]).to(f32)
    xs, cx = _conv_step(x @ p["wx"], cache["conv_x"], p["conv_x"])
    Bc, cB = _conv_step(x @ p["wB"], cache["conv_B"], p["conv_B"])
    Cc, cC = _conv_step(x @ p["wC"], cache["conv_C"], p["conv_C"])
    xs = F.silu(xs.to(f32))
    Bc = F.silu(Bc.to(f32))[:, 0]                                     # (b, n)
    Cc = F.silu(Cc.to(f32))[:, 0]
    dt = _softplus(dt_raw + p["dt_bias"].to(f32))[:, 0]               # (b, h)
    A = -torch.exp(p["A_log"].to(f32))

    xh = xs.reshape(b, h, pdim)
    S = (torch.exp(dt * A)[..., None, None] * cache["state"]
         + (dt[..., None] * xh)[..., None] * Bc[:, None, None, :])   # (b, h, p, n)
    y = (S @ Cc[:, None, :, None])[..., 0]                            # (b, h, p)
    y = y + p["D"].to(f32)[None, :, None] * xh
    out = _gated_out(p, y.reshape(b, 1, h * pdim), z, x, cfg)
    return out, {"state": S, "conv_x": cx, "conv_B": cB, "conv_C": cC}
