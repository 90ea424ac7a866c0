"""Plain reference of an attention-free Mamba-2 stack (arXiv:2405.21060)
as the configuration runs it: pre-norm blocks of the Mamba-2 mixer, a
final RMSNorm and an LM head tied to the embedding.

The mixer, per token: z, x, B, C and dt from separate input projections;
x, B and C each through a causal depthwise convolution of width
``conv_width`` and SiLU; dt = softplus(dt + dt_bias), A = -exp(A_log);
per head the state S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T and the
output y_t = S_t C_t + D x_t (one group: B and C shared by the heads),
computed by the paper's chunked SSD (listing 1); then y * silu(z), an
RMSNorm over ``d_inner`` and the output projection.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import layers, leaf, rms_norm


def segsum(a):
    """(..., q) -> (..., q, q): sum of a[j+1 .. i] where i >= j, else -inf."""
    q = a.shape[-1]
    c = torch.cumsum(a, dim=-1)
    d = c[..., :, None] - c[..., None, :]
    return d.masked_fill(~torch.ones(q, q, dtype=torch.bool, device=a.device).tril(),
                         float("-inf"))


def ssd(X, A, B, C, q: int):
    """Listing 1 of the paper, one sequence, one group. X (T, h, p) is
    x * dt, A (T, h) is dt * A, B and C (T, n); T a multiple of q."""
    T, h, p = X.shape
    c = T // q
    X, A = X.view(c, q, h, p), A.view(c, q, h).permute(2, 0, 1)     # A: (h, c, q)
    B, C = B.view(c, q, -1), C.view(c, q, -1)
    Acum = torch.cumsum(A, dim=-1)
    L = torch.exp(segsum(A))                                         # (h, c, q, q)
    CB = C @ B.transpose(1, 2)                                       # (c, q, q)
    y_diag = torch.einsum("hcls,cshp->clhp", L * CB[None], X)
    decay = torch.exp(Acum[..., -1:] - Acum)                         # (h, c, q)
    states = torch.einsum("csn,hcs,cshp->chpn", B, decay, X)
    states = torch.cat([torch.zeros_like(states[:1]), states], dim=0)
    chunk_decay = torch.exp(segsum(F.pad(Acum[..., -1], (1, 0))))   # (h, c+1, c+1)
    states = torch.einsum("hzc,chpn->zhpn", chunk_decay, states)[:-1]
    y_off = torch.einsum("cln,chpn,hcl->clhp", C, states, torch.exp(Acum))
    return (y_diag + y_off).reshape(T, h, p)


def conv(u, w):
    """Causal depthwise convolution of (T, c) by (width, c)."""
    width = w.shape[0]
    out = u * w[-1]
    for k in range(1, width):
        out = out + F.pad(u, (0, 0, k, 0))[: u.shape[0]] * w[-1 - k]
    return out


def mixer(x, p, s, quant=None):
    T = x.shape[0]
    h, hp, q = s["ssm_heads"], s["ssm_head_dim"], s["ssm_chunk"]
    f = lambda n: leaf(p[n], quant)
    z = x @ f("wz")
    xs = F.silu(conv(x @ f("wx"), f("conv_x")))
    B = F.silu(conv(x @ f("wB"), f("conv_B")))
    C = F.silu(conv(x @ f("wC"), f("conv_C")))
    dt = F.softplus(x @ f("wdt") + p["dt_bias"].float())            # (T, h)
    A = -torch.exp(p["A_log"].float())
    xh = xs.view(T, h, hp)
    pad = -T % q                      # zeros after the end change nothing before it
    Xp = F.pad(xh * dt[..., None], (0, 0, 0, 0, 0, pad))
    y = ssd(Xp, F.pad(dt * A, (0, 0, 0, pad)), F.pad(B, (0, 0, 0, pad)),
            F.pad(C, (0, 0, 0, pad)), q)[:T]
    y = y + p["D"].float()[None, :, None] * xh
    y = y.reshape(T, h * hp) * F.silu(z)
    return rms_norm(y, p["norm"].float(), s["norm_eps"]) @ f("wout")


def served_logits(w, s, tokens, n_prompt: int, quant=None):
    """As :func:`portbench.reference.deepseek_moe.served_logits`."""
    dev = w["embed"].device
    ids = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    emb = leaf(w["embed"], quant)
    x = emb[ids]
    eps = s["norm_eps"]
    for lp in layers(w):
        x = x + mixer(rms_norm(x, lp["mixer_norm"].float(), eps), lp["mamba"], s, quant)
    x = rms_norm(x[n_prompt - 1:], w["final_norm"].float(), eps)
    return x @ emb.T
