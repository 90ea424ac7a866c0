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

With ``tp`` (a ``models.parallel.TensorParallel`` whose ``ssm`` is set) a
rank runs its own heads: ``p`` holds its blocks of the ``ssm_inner`` and
``ssm_heads`` leaves and the whole ``ssm_state`` ones. The input enters
through ``comm.copy_to_split``; the whole ``wB``, ``wC``, ``conv_B`` and
``conv_C`` enter the same way (one sum of their four gradients over the
ranks: a rank reads them for its heads only). The gated RMSNorm is the one
reduction across heads: the rank's (b, l, d_inner/M) slice of its input is
gathered into whole rows (all-gather; reduce-scatter backward), normed by
the same kernel in the unsplit row order, and the rank keeps its columns
for ``wout``, whose partial sums go to ``comm.reduce_from_split``. The
norm's weight is the rank's block, set into a zero row of ``d_inner``: the
columns the rank keeps read only their own weights, and the others carry
no gradient. The decode cache holds the rank's heads: ``state`` (b, h/M,
p, n), ``conv_x`` (b, w-1, d_inner/M), ``conv_B`` and ``conv_C`` whole.
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


def _split(tp) -> bool:
    return tp is not None and tp.ssm


def _enter(p: Dict, x, tp):
    """The input and the parameters as the rank's heads read them: under a
    split, ``x`` and the whole ``ssm_state`` leaves through one
    ``copy_to_split`` each (the four leaves' gradients summed in one
    all-reduce). Both are the identity forward: without autograd, nothing."""
    if not _split(tp) or not torch.is_grad_enabled():
        return p, x
    whole = ("wB", "wC", "conv_B", "conv_C")
    flat = tp.copy(torch.cat([p[k].reshape(-1) for k in whole]))
    p = dict(p)
    for k, piece in zip(whole, flat.split([p[k].numel() for k in whole])):
        p[k] = piece.view(p[k].shape)
    return p, tp.into(x)


def _gated_out(p: Dict, y, z, x, cfg: ModelConfig, tp=None):
    """y * silu(z), RMSNorm (cast to x's dtype, f32 weight), out-projection;
    under a split, the norm on the gathered rows and the projection's
    partial sums added over the ranks."""
    y = (y * F.silu(z.to(torch.float32))).to(x.dtype)
    if not _split(tp):
        return rms_norm(y, p["norm"], cfg.division, cfg.norm_eps) @ p["wout"]
    n = y.shape[-1]
    lo = tp.rank * n
    w = F.pad(p["norm"], (lo, (tp.size - 1) * n - lo))
    y = rms_norm(tp.gather(y), w, cfg.division, cfg.norm_eps)[..., lo:lo + n]
    return tp.out(y @ p["wout"])


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
                return_state: bool = False, lengths=None, tp=None):
    """x: (b, l, d_model) -> (b, l, d_model), chunked over ``cfg.ssm_chunk``.

    ``lengths`` (the real lengths of a right-padded batch) zeroes dt at pad
    positions, so there the decay is exp(0) = 1 and the input dt*B*x is 0:
    the returned state is the state after each row's real tokens, and the
    conv tails are its last real positions. With ``return_state`` also
    returns the decode cache ``{"state", "conv_x", "conv_B", "conv_C"}``.
    ``tp``: the rank's plan (module docstring); ``p`` then holds its blocks.
    """
    b, l, _ = x.shape
    p, x = _enter(p, x, tp)
    h, pdim, n = p["A_log"].shape[0], cfg.ssm_head_dim, cfg.ssm_state
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
    out = _gated_out(p, y.reshape(b, l, h * pdim), z, x, cfg, tp)
    if not return_state:
        return out
    wm1 = cfg.conv_width - 1
    return out, {"state": S, "conv_x": _tail(xs_raw, wm1, lengths),
                 "conv_B": _tail(B_raw, wm1, lengths),
                 "conv_C": _tail(C_raw, wm1, lengths)}


def _cache_leaves(cfg: ModelConfig, batch: int, dtype, tp=None):
    """{name: (shape, dtype)} of the decode cache: the f32 state and the
    conv windows in ``dtype``; under a split, of the rank's heads."""
    m = tp.size if _split(tp) else 1
    h, pdim, n = cfg.ssm_heads // m, cfg.ssm_head_dim, cfg.ssm_state
    wm1 = cfg.conv_width - 1
    return {"state": ((batch, h, pdim, n), torch.float32),
            "conv_x": ((batch, wm1, cfg.d_inner // m), dtype),
            "conv_B": ((batch, wm1, n), dtype),
            "conv_C": ((batch, wm1, n), dtype)}


def init_cache_mamba(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None,
                     tp=None):
    """A zero decode cache: the f32 state and the conv windows in ``dtype``
    (the rank's heads under ``tp``)."""
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in _cache_leaves(cfg, batch, dtype, tp).items()}


def abstract_cache_mamba(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None,
                         fake_mode=None, tp=None):
    """:func:`init_cache_mamba`'s tree as stand-ins that allocate nothing
    (``repro_torch.tree.abstract``)."""
    return {k: tree.abstract(shape, dt, device, fake_mode)
            for k, (shape, dt) in _cache_leaves(cfg, batch, dtype, tp).items()}


def _conv_step(u_new, conv_state, w):
    """One token of the causal conv. u_new: (b, 1, c); conv_state: (b,
    width-1, c). The window's products are exact in f32 and summed there,
    rounded once (the reference's contraction with f32 accumulation)."""
    window = torch.cat([conv_state, u_new], dim=1)                    # (b, width, c)
    out = (window.to(torch.float32) * w.to(torch.float32)).sum(1).to(u_new.dtype)
    return out[:, None, :], window[:, 1:]


def decode_mamba(p: Dict, x, cache, cfg: ModelConfig, tp=None):
    """One recurrent step. x: (b, 1, d_model). Returns (out, a new cache).
    ``tp``: as :func:`mamba_mixer`'s; the cache holds the rank's heads."""
    b = x.shape[0]
    p, x = _enter(p, x, tp)
    h, pdim = p["A_log"].shape[0], cfg.ssm_head_dim
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
    out = _gated_out(p, y.reshape(b, 1, h * pdim), z, x, cfg, tp)
    return out, {"state": S, "conv_x": cx, "conv_B": cB, "conv_C": cC}
