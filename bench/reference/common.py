"""Plain float32 building blocks of the reference models.

Everything here is the layers' mathematics written out in torch ops, in
float32, with TF32 off: no kernel, no cache, no batching trick of the
program.  A matrix product goes through a ``Precision``: float32 for the
reference, or the same product with both operands rounded to float8 e4m3
(a scale per row of the activations and per column of the weights) for the
control, the precision below the configurations' bfloat16.
"""

from __future__ import annotations

import math

import torch

FP8_MAX = 448.0                       # largest finite float8 e4m3fn


def exact_float32() -> None:
    """Float32 products as float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    scale = t.abs().amax(dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return ((t / scale).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
            .float() * scale)


class Precision:
    """The matrix product of the reference (``fp8=False``) or of its
    float8 control (``fp8=True``)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x (..., K) @ w (K, N)`` in float32."""
        x, w = x.float(), w.float()
        if self.fp8:
            x, w = _fp8(x, -1), _fp8(w, 0)
        return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with the gain ``1 + w`` (the gain stored centred on 0)."""
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (
        1.0 + w.float())


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding of ``x (..., S, H, Dh)`` at ``positions (S,)``, the
    first half of each head rotated with the second."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) * 2 / x.shape[-1])
    ang = positions.float()[:, None] * inv                  # (S, Dh/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     block: int = 512) -> torch.Tensor:
    """Softmax attention of ``q (S, H, Dh)`` over ``k``, ``v (S, Hkv,
    Dh)`` of one sequence, each position over itself and those before it;
    query heads share their kv head in groups of ``H / Hkv``.  Blocks of
    ``block`` query rows bound the score tensor."""
    S, H, Dh = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)      # (H, S, Dh)
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for lo in range(0, S, block):
        hi = min(S, lo + block)
        s = torch.einsum("qhd,hkd->hqk", q[lo:hi], k[:, :hi]) / math.sqrt(Dh)
        rows = torch.arange(lo, hi, device=q.device)[:, None]
        cols = torch.arange(hi, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
        out[lo:hi] = torch.einsum("hqk,hkd->qhd", torch.softmax(s, -1),
                                  v[:, :hi])
    return out


def attention_block(prec: Precision, lp: dict, x: torch.Tensor, *,
                    n_heads: int, n_kv: int, head_dim: int, theta: float,
                    eps: float):
    """The attention half of a pre-norm block over ``x (B, S, D)``:
    returns ``(x + attention, k, v)`` with ``k``, ``v (B, S, Hkv, Dh)`` as
    a cache holds them (``k`` after RoPE)."""
    B, S, _ = x.shape
    h = rms_norm(x, lp["ln1"], eps)
    pos = torch.arange(S, device=x.device)
    q = rope(prec.mm(h, lp["wq"]).view(B, S, n_heads, head_dim), pos, theta)
    k = rope(prec.mm(h, lp["wk"]).view(B, S, n_kv, head_dim), pos, theta)
    v = prec.mm(h, lp["wv"]).view(B, S, n_kv, head_dim)
    o = torch.stack([causal_attention(q[b], k[b], v[b]) for b in range(B)])
    return x + prec.mm(o.reshape(B, S, -1), lp["wo"]), k, v


def swiglu(prec: Precision, x: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    return prec.mm(silu(prec.mm(x, wg)) * prec.mm(x, wu), wd)
