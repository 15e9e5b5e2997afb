"""Decoder-only transformer LM (dense + GQA): forward, prefill and decode.

Covers gemma3 (5:1 local:global sliding window), deepseek/qwen2/internlm2
(plain GQA; qwen2 adds QKV bias), and chameleon (early-fusion VLM: the VQ
image tokens share the text vocabulary, frontend stubbed to token ids).

Layer parameters are stacked on a leading L axis, as in the JAX package, so
weights map one to one; the layers are consumed by a Python loop over that
axis.  This module holds parameter init, the layer, the KV cache,
``forward`` (final hidden states), ``prefill`` (a whole prompt into a cache)
and ``decode_step`` -- what the server runs (it prefills through ``decode``);
``models/moe.py`` runs the same passes with its expert layer as the
feed-forward.  The route of attention is fixed by the call: a layer without
a cache (forward, prefill, the hybrid's shared block) attends over the
prompt through the flash attention kernel (``kernels.ops.mha``), a layer
with one (decode) through the eager ``chunked_attention``.  Beside
``decode_step`` stand its two variants: ``grouped_decode_step``, whose
local-attention layers keep a ring of ``window`` rows (the slot ``pos mod
W`` is a bank address of the paper's Eq. 1 with N = W, B = 1), and
``decode_step_quant``, over an int8 cache with a scale per token and head.
As in the JAX package, neither the server nor ``get_model`` uses them.
The loss is not here yet.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..kernels import ops
from .layers import (NEG_INF, apply_rope, chunked_attention, dense_init,
                     rms_norm, swiglu)

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


def _project_q(cfg, lp, x, q_offset):
    B, S, _ = x.shape
    q = torch.matmul(x, lp["wq"])
    if "bq" in lp:
        q = q + lp["bq"]
    q = q.reshape(B, S, cfg.n_heads, cfg.hd)
    return apply_rope(q, _positions(S, q_offset, x.device), cfg.rope_theta)


def _attn(cfg: ArchConfig, lp, x, *, k_full, v_full, window, q_offset,
          kv_len, block_k=1024):
    """Attention of one layer's queries at ``q_offset`` against a cache
    whose first ``kv_len`` rows are valid: the eager ``chunked_attention``."""
    B, S, _ = x.shape
    out = chunked_attention(
        _project_q(cfg, lp, x, q_offset), k_full, v_full, causal=True,
        window=window, q_offset=q_offset, kv_len=kv_len, block_k=block_k)
    return torch.matmul(out.reshape(B, S, -1), lp["wo"])


def _attn_prompt(cfg: ArchConfig, lp, x, k, v, window):
    """Attention of one layer over the prompt itself, positions from 0: the
    flash attention kernel."""
    B, S, _ = x.shape
    out = ops.mha(_project_q(cfg, lp, x, 0), k, v, causal=True,
                  window=int(window))
    return torch.matmul(out.reshape(B, S, -1), lp["wo"])


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
    current sequence through the flash attention kernel, which counts
    positions from 0, so ``pos`` must be 0 then (it is in every caller of
    the JAX package: forward, prefill, the hybrid's shared block).
    ``ffn(lp, h)`` overrides the feed-forward.

    A write that would run past the end of the buffer is clamped so that it
    fits (for one token: the last row is overwritten) while RoPE and the
    masks go on with the unclamped ``pos`` -- what the JAX package's
    ``dynamic_update_slice`` does."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cache_kv is None:
        if int(pos) != 0:
            raise ValueError(f"a layer without a cache attends over the "
                             f"sequence from position 0, got pos={pos}")
        k, v = _project_kv(cfg, lp, h, 0)
        attn = _attn_prompt(cfg, lp, h, k, v, window)
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
# Whole-sequence passes: forward and prefill
# ---------------------------------------------------------------------------


def _layer_params(params: Params, i: int) -> Params:
    return {name: w[i] for name, w in params["layers"].items()}


@torch.no_grad()
def forward(cfg: ArchConfig, params: Params, tokens: Tensor, ffn=None
            ) -> Tensor:
    """tokens (B, S) -> final hidden states (B, S, D), bfloat16 residual
    stream; every layer attends over the sequence through the flash
    attention kernel.  ``ffn(lp, h)`` overrides every layer's feed-forward
    (the MoE family).  No gradients: the kernel has no backward yet."""
    x = params["embed"].to(torch.bfloat16)[tokens]
    windows = layer_windows(cfg)
    for i in range(cfg.n_layers):
        x, _ = dense_layer(cfg, _layer_params(params, i), x, int(windows[i]),
                           ffn=ffn)
    return rms_norm(x, params["ln_f"], cfg.norm_eps)


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
def prefill(cfg: ArchConfig, params: Params, tokens: Tensor, max_len: int,
            ffn=None) -> Tuple[Tensor, KVCache]:
    """tokens (B, S) -> logits of the last position (B, V) and the cache
    that decoding goes on from: ``max_len`` long, the prompt's K/V in its
    first ``S`` rows, zeros past them, ``pos = S``.  Each layer attends over
    the prompt through the flash attention kernel (one launch a layer);
    ``ffn`` as in :func:`forward`."""
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"a prompt of {S} tokens does not fit a cache of "
                         f"max_len {max_len}")
    x = params["embed"].to(torch.bfloat16)[tokens]
    windows = layer_windows(cfg)
    cache = init_cache(cfg, B, max_len, device=x.device)
    for i in range(cfg.n_layers):
        x, (k, v) = dense_layer(cfg, _layer_params(params, i), x,
                                int(windows[i]), ffn=ffn)
        cache.k[i, :, :S] = k
        cache.v[i, :, :S] = v
    h = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = logits_fn(cfg, params, h[:, -1:])[:, 0]
    return logits, KVCache(cache.k, cache.v, S)


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
    pos = int(cache.pos)
    for i in range(cfg.n_layers):
        x, _ = dense_layer(cfg, _layer_params(params, i), x, int(windows[i]),
                           cache_kv=(cache.k[i], cache.v[i]), pos=pos,
                           block_k=block_k, ffn=ffn)
    h = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = logits_fn(cfg, params, h)[:, 0]
    return logits, KVCache(cache.k, cache.v, pos + 1)


# ---------------------------------------------------------------------------
# Grouped decode for local:global architectures (gemma3)
#
# Local-attention layers keep only a ``window``-sized RING cache.  The ring
# slot index is ``pos mod window`` -- a hyperplane bank address (Eq. 1) with
# N = window, B = 1; with window a power of two the Sec-3.4 transform reduces
# the bank resolution to a single AND mask.  Capacity and memory traffic of
# the 5-of-6 local layers drop from O(S_ctx) to O(window).
# ---------------------------------------------------------------------------


class GroupedKVCache(NamedTuple):
    k_local: Tensor   # (G, R, B, W, Hkv, Dh) ring buffers (R local layers/group)
    v_local: Tensor
    k_global: Tensor  # (G, B, Smax, Hkv, Dh)
    v_global: Tensor
    pos: int          # number of decode calls so far


def grouped_layout(cfg: ArchConfig) -> Tuple[int, int]:
    """(groups, locals_per_group); requires the 5:1-style layer pattern."""
    if not (cfg.sliding_window and cfg.local_global_ratio):
        raise ValueError(f"{cfg.name} has no local:global layer pattern")
    period = cfg.local_global_ratio + 1
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.n_layers} layers are not whole groups of "
                         f"{period}")
    return cfg.n_layers // period, cfg.local_global_ratio


def init_grouped_cache(cfg: ArchConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16, device="cuda") -> GroupedKVCache:
    device = resolve_device(device)
    G, R = grouped_layout(cfg)
    W = cfg.sliding_window
    Hkv, Dh = cfg.n_kv_heads, cfg.hd

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return GroupedKVCache(zeros(G, R, batch, W, Hkv, Dh),
                          zeros(G, R, batch, W, Hkv, Dh),
                          zeros(G, batch, max_len, Hkv, Dh),
                          zeros(G, batch, max_len, Hkv, Dh), 0)


def _grouped_params(cfg: ArchConfig, params: Params):
    """Restack (L, ...) layer params into local (G, R, ...) + global (G, ...)
    views (no copy)."""
    G, R = grouped_layout(cfg)
    period = R + 1
    local, glob = {}, {}
    for k, v in params["layers"].items():
        vg = v.reshape((G, period) + tuple(v.shape[1:]))
        local[k], glob[k] = vg[:, :R], vg[:, R]
    return local, glob


def ring_slot(pos: int, window: int) -> int:
    """The ring row of position ``pos``: ``pos mod window``, one AND when
    ``window`` is a power of two."""
    if window & (window - 1) == 0:
        return pos & (window - 1)
    return pos % window


def _ring_layer(cfg: ArchConfig, lp, x, kc, vc, pos: int, slot: int):
    """One local layer against its ring (``kc``/``vc`` (B, W, Hkv, Dh),
    written in place at ``slot``): attention over the W rows, each masked
    by the position the bank equation gives it back."""
    B, S, _ = x.shape
    W = cfg.sliding_window
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    k_new, v_new = _project_kv(cfg, lp, h, pos)
    at = min(slot, W - S)          # a write past the ring's end is clamped
    kc[:, at:at + S] = k_new.to(kc.dtype)
    vc[:, at:at + S] = v_new.to(vc.dtype)
    q = _project_q(cfg, lp, h, pos)
    # rows (slot-W, slot] hold positions (pos-W, pos]: 0 = newest
    row = torch.arange(W, device=x.device)
    age = torch.remainder(slot - row + W, W)
    k_pos = pos - age
    valid = (k_pos >= 0) & (k_pos > pos - W)
    q5 = (q.float() / (Dh ** 0.5)).reshape(B, S, Hkv, H // Hkv, Dh)
    s = torch.einsum("bqhrd,bkhd->bqhrk", q5, kc.float())
    s = torch.where(valid[None, None, None, None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bqhrk,bkhd->bqhrd", p, vc.float())
    o = (o / torch.clamp(p.sum(-1)[..., None], min=1e-30)).reshape(
        B, S, H * Dh)
    x = x + torch.matmul(o.to(x.dtype), lp["wo"])
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + swiglu(h2, lp["w_gate"], lp["w_up"], lp["w_down"])


@torch.no_grad()
def grouped_decode_step(cfg: ArchConfig, params: Params,
                        cache: GroupedKVCache, tokens: Tensor,
                        block_k: int = 1024) -> Tuple[Tensor, GroupedKVCache]:
    """One decode step with ring-buffered local layers: tokens (B, 1) ->
    logits (B, V), the cache's buffers **updated in place** (the returned
    cache shares them and carries ``pos + 1``).  The global layer of each
    group is ``dense_layer`` against its full-length buffers."""
    G, R = grouped_layout(cfg)
    x = params["embed"].to(torch.bfloat16)[tokens]
    pos = int(cache.pos)
    slot = ring_slot(pos, cfg.sliding_window)
    local_p, global_p = _grouped_params(cfg, params)
    for g in range(G):
        for r in range(R):
            x = _ring_layer(cfg, {k: v[g, r] for k, v in local_p.items()}, x,
                            cache.k_local[g, r], cache.v_local[g, r], pos,
                            slot)
        x, _ = dense_layer(cfg, {k: v[g] for k, v in global_p.items()}, x, 0,
                           cache_kv=(cache.k_global[g], cache.v_global[g]),
                           pos=pos, block_k=block_k)
    h = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = logits_fn(cfg, params, h)[:, 0]
    return logits, cache._replace(pos=pos + 1)


# ---------------------------------------------------------------------------
# int8-quantized KV cache
#
# Banking view: the cache word width is the solver's ``word_bits`` -- halving
# it halves both bank capacity and the bytes every decode step must stream.
# Per-(token, head) max-abs scales keep the attention error ~0.5%.
# ---------------------------------------------------------------------------


class QuantKVCache(NamedTuple):
    k_q: Tensor    # (L, B, Smax, Hkv, Dh) int8
    v_q: Tensor
    k_s: Tensor    # (L, B, Smax, Hkv) float32 scales
    v_s: Tensor
    pos: int


def init_quant_cache(cfg: ArchConfig, batch: int, max_len: int,
                     device="cuda") -> QuantKVCache:
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return QuantKVCache(
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        torch.zeros(shape[:-1], dtype=torch.float32, device=device), 0)


def _quant_rows(x: Tensor):
    """x (B, S, Hkv, Dh) -> int8 rows + per-(token, head) scales."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


@torch.no_grad()
def decode_step_quant(cfg: ArchConfig, params: Params, cache: QuantKVCache,
                      tokens: Tensor, block_k: int = 1024
                      ) -> Tuple[Tensor, QuantKVCache]:
    """``decode_step`` against an int8 cache: new rows quantized on write
    (in place, at ``pos``, clamped as ``dense_layer`` clamps), the layer's
    whole buffer dequantized to bfloat16 on read."""
    x = params["embed"].to(torch.bfloat16)[tokens]
    windows = layer_windows(cfg)
    pos = int(cache.pos)
    S = x.shape[1]
    at = min(max(pos, 0), cache.k_q.shape[2] - S)
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        k_new, v_new = _project_kv(cfg, lp, h, pos)
        for buf, scale, new in ((cache.k_q[i], cache.k_s[i], k_new),
                                (cache.v_q[i], cache.v_s[i], v_new)):
            q, s = _quant_rows(new)
            buf[:, at:at + S] = q
            scale[:, at:at + S] = s
        k_deq = cache.k_q[i].to(torch.bfloat16) \
            * cache.k_s[i][..., None].to(torch.bfloat16)
        v_deq = cache.v_q[i].to(torch.bfloat16) \
            * cache.v_s[i][..., None].to(torch.bfloat16)
        x = x + _attn(cfg, lp, h, k_full=k_deq, v_full=v_deq,
                      window=int(windows[i]), q_offset=pos, kv_len=pos + S,
                      block_k=block_k)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])
    h = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = logits_fn(cfg, params, h)[:, 0]
    return logits, cache._replace(pos=pos + 1)
