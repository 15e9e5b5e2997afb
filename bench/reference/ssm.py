"""Plain reference of the Mamba2 language model (mamba2).

``n_layers`` Mamba2 blocks, pre-norm (RMSNorm with a ``1 + w`` gain), a
final RMSNorm and the tied embedding as the head.  A block: one input
projection to ``z``, ``x``, ``B``, ``C`` and ``dt`` (one group: ``B``
and ``C`` shared by every head), a depthwise causal convolution of width
``ssm_conv`` over ``[x, B, C]`` with a bias and SiLU, the selective scan

    s_t = exp(dt_t A) s_{t-1} + B_t (x_t dt_t),   y_t = C_t s_t + D x_t

with ``dt = softplus(dt_raw + dt_bias)`` and ``A = -exp(A_log)``, then
RMSNorm of ``y * silu(z)`` and the output projection (Dao and Gu,
arXiv:2405.21060).  The scan is the SSD form of the same recurrence (its
minimal listing): within a chunk the quadratic form, across chunks the
carried state.  Everything is float32 from the bfloat16 weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Precision, rms_norm, silu

CHUNK = 256


def dims(arch: dict):
    d_inner = arch["ssm_expand"] * arch["d_model"]
    P = arch["ssm_head_dim"]
    return d_inner, d_inner // P, P, arch["ssm_state"]


def ssd(x, dt, A, Bm, Cm, chunk: int = CHUNK):
    """The scan of one sequence: ``x (S, H, P)``, ``dt (S, H)``, ``A (H,)``,
    ``Bm``, ``Cm (S, N)``; returns ``y (S, H, P)`` without the ``D`` skip
    and the final state ``(H, P, N)``."""
    S, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-S) % chunk          # dt = 0 rows: no decay, nothing added
    if pad:
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
    nc = (S + pad) // chunk
    xd = (x * dt[..., None]).view(nc, chunk, H, P)
    cum = torch.cumsum((dt * A).view(nc, chunk, H), dim=1)
    Br, Cr = Bm.view(nc, chunk, N), Cm.view(nc, chunk, N)
    tri = torch.ones(chunk, chunk, dtype=torch.bool,
                     device=x.device).tril()[None, :, :, None]
    seg = cum[:, :, None, :] - cum[:, None, :, :]          # (c, i, j, H)
    decay = torch.exp(seg.masked_fill(~tri, float("-inf")))
    scores = torch.einsum("cin,cjn->cij", Cr, Br)[..., None] * decay
    y = torch.einsum("cijh,cjhp->cihp", scores, xd)
    to_end = torch.exp(cum[:, -1:, :] - cum)                # (c, j, H)
    states = torch.einsum("cjn,cjh,cjhp->chpn", Br, to_end, xd)
    s = torch.zeros((H, P, N), dtype=torch.float32, device=x.device)
    for c in range(nc):
        y[c] += torch.einsum("in,ih,hpn->ihp", Cr[c], torch.exp(cum[c]), s)
        s = s * torch.exp(cum[c, -1])[:, None, None] + states[c]
    return y.reshape(nc * chunk, H, P)[:S], s


def mamba_block(prec: Precision, arch: dict, lp: dict, x: torch.Tensor):
    """One block over ``x (B, S, D)``: ``(x + block, conv tail (B, W-1,
    C), final state (B, H, P, N))``; the tail is the last ``W - 1``
    inputs of the convolution, the state that after position ``S``."""
    B, S, _ = x.shape
    d_inner, H, P, N = dims(arch)
    eps = arch["norm_eps"]
    proj = prec.mm(rms_norm(x, lp["ln"], eps), lp["in_proj"])
    z, xin, bc, dt_raw = torch.split(proj, [d_inner, d_inner, 2 * N, H], -1)
    conv_in = torch.cat([xin, bc], dim=-1)
    W = lp["conv_w"].shape[0]
    xp = F.pad(conv_in, (0, 0, W - 1, 0))
    w = lp["conv_w"].float()
    conv = silu(sum(xp[:, i:i + S] * w[i] for i in range(W))
                + lp["conv_b"].float())
    xs, Bm, Cm = torch.split(conv, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt_raw + lp["dt_bias"].float())
    A = -torch.exp(lp["A_log"].float())
    xs = xs.reshape(B, S, H, P)
    ys, states = zip(*(ssd(xs[b], dt[b], A, Bm[b], Cm[b]) for b in range(B)))
    y = torch.stack(ys) + lp["D_skip"].float()[:, None] * xs
    g = rms_norm(y.reshape(B, S, d_inner) * silu(z), lp["gate_ln"], eps)
    return (x + prec.mm(g, lp["out_proj"]), xp[:, -(W - 1):],
            torch.stack(states))


def hidden(arch: dict, params: dict, tokens: torch.Tensor,
           prec: Precision, *, layout=None, on_kv=None,
           on_ssm=None) -> torch.Tensor:
    """The final normed hidden states ``(B, S, D)`` of ``tokens (B, S)``;
    ``on_ssm(i, tail, state)`` sees each block's states.  (No attention:
    ``on_kv`` is never called; nothing is routed: ``layout`` is unused.)"""
    eps = arch["norm_eps"]
    x = params["embed"].float()[tokens.long()]
    for i in range(arch["n_layers"]):
        lp = {name: w[i] for name, w in params["layers"].items()}
        x, tail, state = mamba_block(prec, arch, lp, x)
        if on_ssm is not None:
            on_ssm(i, tail, state)
    return rms_norm(x, params["ln_f"], eps)


def head(params: dict) -> torch.Tensor:
    return params["embed"]
