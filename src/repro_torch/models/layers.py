"""Shared model layers: norms, RoPE, attention, MLPs.

Attention over a whole prompt -- the self attention of a prefill or a
forward pass, whisper's encoder and its cross attention -- goes to the
flash attention kernel through ``kernels.ops.mha`` (called by the models,
not from here).  What stays here is the attention of a decode step against
a cache (a query offset and a valid-prefix ``kv_len``): ``chunked_attention``
is a Python loop over KV blocks with online softmax that never materializes
the (S, S) score matrix, with causal + sliding-window masks computed from
positions per block, and ``decode_attention`` one grouped einsum for a few
query rows.  Every function keeps the JAX package's dtypes op by op --
norms, RoPE, attention scores, softmax and ``p @ v`` compute in float32 and
cast back; the projections are products in the parameters' dtype; the gelu
is written out op by op in the working dtype, as XLA computes it on the
CPU -- so the two packages agree within the rounding of that dtype.  Matrix
products go to ``torch.matmul`` / ``torch.einsum``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------


def rms_norm(x: Tensor, w: Tensor, eps: float = 1e-6) -> Tensor:
    """RMSNorm with a ``1 + w`` gain (``w`` is stored zero-centred)."""
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + w.float())).to(dt)


def swiglu(x: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor) -> Tensor:
    g = torch.matmul(x, w_gate)
    u = torch.matmul(x, w_up)
    # silu as x * sigmoid(x), each op rounded in the working dtype
    return torch.matmul((g * torch.sigmoid(g)) * u, w_down)


def gelu_tanh(x: Tensor) -> Tensor:
    """``jax.nn.gelu``'s default (tanh) form, ``x * 0.5 (1 + tanh(c (x +
    0.044715 x^3)))``, written out op by op in ``x``'s dtype with its two
    constants cast to that dtype: in bfloat16, XLA on the CPU rounds every
    step so, and ``F.gelu(approximate="tanh")``, which rounds once, differs
    from it by one ulp in four of ten elements."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
    k = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def gelu_mlp(x: Tensor, w_up: Tensor, b_up: Tensor, w_down: Tensor,
             b_down: Tensor) -> Tensor:
    h = gelu_tanh(torch.matmul(x, w_up) + b_up)
    return torch.matmul(h, w_down) + b_down


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (B, S, H, Dh); positions: (B, S) or (S,).  Split-halves layout:
    the first half of the head pairs with the second half."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (Dh/2,)
    ang = positions[..., None].to(torch.float32) * freqs  # (B, S, Dh/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Chunked attention (online softmax over KV blocks)
# ---------------------------------------------------------------------------


NEG_INF = -1e30


def _block_mask(q_pos: Tensor, k_pos: Tensor, causal: bool, window: int
                ) -> Tensor:
    """(Sq, Bk) mask from absolute positions; window <= 0 means unlimited."""
    dq = q_pos[:, None]
    dk = k_pos[None, :]
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= dk <= dq
    if int(window) > 0:
        ok &= dq - dk < int(window)
    return ok


def decode_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                     kv_len=None, scale=None) -> Tensor:
    """Sq<=4 fast path: one grouped einsum over the WHOLE KV buffer; the
    score tensor is only (B, Sq, H, Sk) for a handful of q rows."""
    B, Sq, H, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    q5 = (q.float() * scale).reshape(B, Sq, Hkv, rep, Dh)
    s = torch.einsum("bqhrd,bkhd->bqhrk", q5, k.float())
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    k_pos = torch.arange(Sk, device=q.device)
    mask = _block_mask(q_pos, k_pos, causal, window)
    if kv_len is not None:
        mask &= (k_pos < kv_len)[None, :]
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    m = s.max(dim=-1, keepdim=True).values
    p = torch.exp(s - m)
    out = torch.einsum("bqhrk,bkhd->bqhrd", p, v.float())
    out = out / torch.clamp(p.sum(-1)[..., None], min=1e-30)
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def chunked_attention(
    q: Tensor,                # (B, Sq, H, Dh)
    k: Tensor,                # (B, Sk, Hkv, Dh)
    v: Tensor,                # (B, Sk, Hkv, Dh)
    *,
    causal: bool = True,
    window: int = 0,                 # sliding window (tokens); 0 = full
    q_offset: int = 0,               # absolute position of q[0] (decode)
    kv_len: Optional[int] = None,    # valid KV prefix length (decode cache)
    block_k: int = 1024,
    block_q: int = 512,
    scale: Optional[float] = None,
) -> Tensor:
    B, Sq, H, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    if Sq <= 4 and Sk > block_k:
        return decode_attention(q, k, v, causal=causal, window=window,
                                q_offset=q_offset, kv_len=kv_len, scale=scale)
    if Sq > block_q and Sq % block_q == 0:
        # outer q-blocking bounds the score working set to
        # (B, block_q, H, block_k) per step regardless of sequence length
        outs = [
            chunked_attention(
                q[:, i * block_q:(i + 1) * block_q], k, v, causal=causal,
                window=window, q_offset=q_offset + i * block_q,
                kv_len=kv_len, block_k=block_k, block_q=block_q, scale=scale)
            for i in range(Sq // block_q)]
        return torch.cat(outs, dim=1)

    nblk = -(-Sk // block_k)
    pad = nblk * block_k - Sk
    if pad:   # zero rows; masked below by their positions >= valid_k
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))

    # grouped-query layout: (B, Sq, Hkv, rep, Dh) so KV is never re-folded
    q5 = (q.float() * scale).reshape(B, Sq, Hkv, rep, Dh)
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    valid_k = Sk if kv_len is None else kv_len

    m = torch.full((B, Sq, Hkv, rep), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Sq, Hkv, rep), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, Hkv, rep, Dh), dtype=torch.float32,
                      device=q.device)
    for bidx in range(nblk):
        kblk = k[:, bidx * block_k:(bidx + 1) * block_k].float()
        vblk = v[:, bidx * block_k:(bidx + 1) * block_k].float()
        k_pos = bidx * block_k + torch.arange(block_k, device=q.device)
        s = torch.einsum("bqhrd,bkhd->bqhrk", q5, kblk)
        mask = _block_mask(q_pos, k_pos, causal, window)
        mask &= (k_pos < valid_k)[None, :]
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.max(dim=-1).values)
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqhrk,bkhd->bqhrd",
                                                   p, vblk)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def naive_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    kv_len=None, scale=None) -> Tensor:
    """Reference implementation (materializes scores) -- small shapes only."""
    B, Sq, H, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    kr = torch.repeat_interleave(k, rep, dim=2)
    vr = torch.repeat_interleave(v, rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kr.float())
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    k_pos = torch.arange(Sk, device=q.device)
    mask = _block_mask(q_pos, k_pos, causal, window)
    if kv_len is not None:
        mask &= (k_pos < kv_len)[None, :]
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vr.float())
    return out.to(q.dtype)


ATTN_IMPLS = {"chunked": chunked_attention, "naive": naive_attention}


# ---------------------------------------------------------------------------
# Parameter init helpers
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, shape, scale=None,
               dtype=torch.float32, device=None) -> Tensor:
    """Normal(0, scale) weights drawn in float32 from ``generator`` (on the
    generator's device unless ``device`` says otherwise), then cast."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    device = device if device is not None else generator.device
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * scale).to(device=device, dtype=dtype)
