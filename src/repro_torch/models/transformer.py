"""Decoder-only transformer LM (dense + GQA): the decode path.

Covers gemma3 (5:1 local:global sliding window), deepseek/qwen2/internlm2
(plain GQA; qwen2 adds QKV bias), and chameleon (early-fusion VLM: the VQ
image tokens share the text vocabulary, frontend stubbed to token ids).

Layer parameters are stacked on a leading L axis, as in the JAX package, so
weights map one to one; the layers are consumed by a Python loop over that
axis.  This module holds parameter init, the layer, the KV cache and
``decode_step`` -- what the server runs (it prefills through ``decode``
too); ``models/moe.py`` runs the same step with its expert layer as the
feed-forward.  The training forward, ``prefill``, the loss and the
grouped / int8 cache variants are not here yet.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from .layers import apply_rope, chunked_attention, dense_init, rms_norm, swiglu

Tensor = torch.Tensor
Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def layer_windows(cfg: ArchConfig) -> np.ndarray:
    """Per-layer attention window (0 = global) for local:global patterns."""
    if cfg.sliding_window and cfg.local_global_ratio:
        period = cfg.local_global_ratio + 1
        return np.array(
            [0 if (i + 1) % period == 0 else cfg.sliding_window
             for i in range(cfg.n_layers)], dtype=np.int32)
    if cfg.sliding_window:
        return np.full(cfg.n_layers, cfg.sliding_window, dtype=np.int32)
    return np.zeros(cfg.n_layers, dtype=np.int32)


def init_dense_params(cfg: ArchConfig, generator: torch.Generator,
                      dtype=torch.bfloat16, device="cuda") -> Params:
    """Random parameters from ``generator`` (which must live on ``device``,
    so a card fills its own weights), same tree and shapes as the JAX
    package's; the numbers differ, since the two frameworks draw
    differently from a seed."""
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator lives on {generator.device}, "
                         f"parameters are asked for on {device}")
    L, D, F, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def init(shape, scale=None):
        return dense_init(generator, shape, scale=scale, dtype=dtype,
                          device=device)

    def stack(shape):
        out = torch.empty((L,) + shape, dtype=dtype, device=device)
        for i in range(L):      # one layer's float32 draw at a time
            out[i] = init(shape)
        return out

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    p: Params = {
        "embed": init((V, D), scale=0.02),
        "ln_f": zeros(D),
        "layers": {
            "ln1": zeros(L, D),
            "ln2": zeros(L, D),
            "wq": stack((D, H * Dh)),
            "wk": stack((D, Hkv * Dh)),
            "wv": stack((D, Hkv * Dh)),
            "wo": stack((H * Dh, D)),
            "w_gate": stack((D, F)),
            "w_up": stack((D, F)),
            "w_down": stack((F, D)),
        },
    }
    if cfg.qkv_bias:
        p["layers"]["bq"] = zeros(L, H * Dh)
        p["layers"]["bk"] = zeros(L, Hkv * Dh)
        p["layers"]["bv"] = zeros(L, Hkv * Dh)
    if not cfg.tie_embeddings:
        p["lm_head"] = init((V, D), scale=0.02)
    return p


# ---------------------------------------------------------------------------
# Attention block
# ---------------------------------------------------------------------------


def _positions(S: int, offset: int, device) -> Tensor:
    return torch.arange(S, device=device) + offset


def _attn(cfg: ArchConfig, lp, x, *, k_full, v_full, window, q_offset,
          kv_len, block_k=1024):
    B, S, D = x.shape
    H, Dh = cfg.n_heads, cfg.hd
    q = torch.matmul(x, lp["wq"])
    if "bq" in lp:
        q = q + lp["bq"]
    q = q.reshape(B, S, H, Dh)
    q = apply_rope(q, _positions(S, q_offset, x.device), cfg.rope_theta)
    out = chunked_attention(
        q, k_full, v_full, causal=True, window=window,
        q_offset=q_offset, kv_len=kv_len, block_k=block_k)
    return torch.matmul(out.reshape(B, S, H * Dh), lp["wo"])


def _project_kv(cfg, lp, x, q_offset):
    B, S, _ = x.shape
    Hkv, Dh = cfg.n_kv_heads, cfg.hd
    k = torch.matmul(x, lp["wk"])
    v = torch.matmul(x, lp["wv"])
    if "bk" in lp:
        k, v = k + lp["bk"], v + lp["bv"]
    k = k.reshape(B, S, Hkv, Dh)
    v = v.reshape(B, S, Hkv, Dh)
    k = apply_rope(k, _positions(S, q_offset, x.device), cfg.rope_theta)
    return k, v


def dense_layer(cfg: ArchConfig, lp, x, window, *, cache_kv=None, pos=0,
                block_k=1024, ffn=None):
    """One transformer block.  cache_kv=(k,v) full-length buffers for decode,
    **written in place** at ``pos``; otherwise self-attention over the
    current sequence.  ``ffn(lp, h)`` overrides the feed-forward.

    A write that would run past the end of the buffer is clamped so that it
    fits (for one token: the last row is overwritten) while RoPE and the
    masks go on with the unclamped ``pos`` -- what the JAX package's
    ``dynamic_update_slice`` does."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cache_kv is None:
        k, v = _project_kv(cfg, lp, h, pos)
        attn = _attn(cfg, lp, h, k_full=k, v_full=v, window=window,
                     q_offset=pos, kv_len=None, block_k=block_k)
        new_kv = (k, v)
    else:
        k_new, v_new = _project_kv(cfg, lp, h, pos)
        k_buf, v_buf = cache_kv
        S = x.shape[1]
        at = min(max(int(pos), 0), k_buf.shape[1] - S)
        k_buf[:, at:at + S] = k_new.to(k_buf.dtype)
        v_buf[:, at:at + S] = v_new.to(v_buf.dtype)
        attn = _attn(cfg, lp, h, k_full=k_buf, v_full=v_buf, window=window,
                     q_offset=pos, kv_len=pos + S, block_k=block_k)
        new_kv = (k_buf, v_buf)
    x = x + attn
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if ffn is None:
        delta = swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])
    else:
        delta = ffn(lp, h)
    x = x + delta
    return x, new_kv


def logits_fn(cfg: ArchConfig, params: Params, h: Tensor) -> Tensor:
    w = params.get("lm_head", params["embed"])
    return torch.matmul(h, w.to(h.dtype).T)


# ---------------------------------------------------------------------------
# Serving: single-token decode with a fixed-capacity KV cache
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: Tensor   # (L, B, Smax, Hkv, Dh)
    v: Tensor
    pos: int    # number of decode calls so far, ONE count for all slots


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> KVCache:
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Params, cache: KVCache,
                tokens: Tensor, block_k: int = 1024, ffn=None
                ) -> Tuple[Tensor, KVCache]:
    """One decode step: tokens (B, 1) -> logits (B, V), updated cache.

    The cache's ``k``/``v`` buffers are **updated in place** (the returned
    cache shares them and carries ``pos + 1``); the caller must not go on
    using the cache it passed in as if it were the old one.  The residual
    stream is bfloat16 whatever the parameters' dtype, as in the JAX
    package, whose decode step therefore runs with bfloat16 parameters
    only; so does this one (torch does not promote a bf16 @ fp32 product).
    ``ffn(lp, h)`` overrides every layer's feed-forward (the MoE family).
    """
    x = params["embed"].to(torch.bfloat16)[tokens]
    windows = layer_windows(cfg)
    lp = params["layers"]
    pos = int(cache.pos)
    for i in range(cfg.n_layers):
        lp_i = {name: w[i] for name, w in lp.items()}
        x, _ = dense_layer(cfg, lp_i, x, int(windows[i]),
                           cache_kv=(cache.k[i], cache.v[i]), pos=pos,
                           block_k=block_k, ffn=ffn)
    h = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = logits_fn(cfg, params, h)[:, 0]
    return logits, KVCache(cache.k, cache.v, pos + 1)
