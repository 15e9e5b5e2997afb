"""Whisper-style encoder-decoder (audio family): prefill and decode.

The conv/mel frontend is a stub, as in the JAX package: the caller hands
precomputed frame embeddings ``(B, S_enc, D)`` (in real Whisper they come
from two strided Conv1d layers over an 80-bin mel spectrogram).  The
backbone is the JAX package's: a bidirectional encoder, a causal decoder
with cross attention, RMS norms, a tanh-gelu MLP with biases, and RoPE for
positions on both sides.  Layer parameters are stacked on a leading axis
(``enc``, ``dec``), nested as ``attn`` / ``self`` / ``cross`` / ``mlp``, so
weights map one to one; the layers are consumed by Python loops.

Attention over a whole sequence -- the encoder's, the prefill's causal self
attention and its cross attention (``S`` query rows over ``S_enc`` frames)
-- goes through the flash attention kernel (``kernels.ops.mha``); a decode
step's single query row attends against the caches through the eager
``chunked_attention``, as in the JAX package.  ``lm_loss`` (the encoder,
``decode_train`` over the whole target and the chunked cross-entropy)
carries gradients; ``prefill`` runs the same encoder body without them.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..configs.base import ArchConfig
from ..kernels import ops
from ..parallel.hints import hint, split_sequence
from . import transformer as tfm
from .layers import (apply_rope, chunked_attention, dense_init, gelu_mlp,
                     param_device, remat, rms_norm, unstack)

Tensor = torch.Tensor
Params = Dict[str, Any]


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cuda") -> Params:
    """Random parameters from ``generator`` (which must live on ``device``),
    the JAX package's tree: ``embed``, ``ln_enc``, ``ln_f``, and ``enc`` /
    ``dec`` stacked over their layers.  One layer's float32 draw at a
    time."""
    device = param_device(generator, device)
    D, H, Hkv, Dh, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                        cfg.d_ff)
    Lenc = cfg.n_encoder_layers or cfg.n_layers
    Ldec = cfg.n_layers

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def stack(L, shape):
        out = torch.empty((L,) + shape, dtype=dtype, device=device)
        for i in range(L):
            out[i] = dense_init(generator, shape, dtype=dtype, device=device)
        return out

    def attn(L):
        return {"wq": stack(L, (D, H * Dh)), "wk": stack(L, (D, Hkv * Dh)),
                "wv": stack(L, (D, Hkv * Dh)), "wo": stack(L, (H * Dh, D))}

    def mlp(L):
        return {"w_up": stack(L, (D, F)), "b_up": zeros(L, F),
                "w_down": stack(L, (F, D)), "b_down": zeros(L, D)}

    enc = {"ln1": zeros(Lenc, D), "ln2": zeros(Lenc, D), "attn": attn(Lenc),
           "mlp": mlp(Lenc)}
    dec = {"ln1": zeros(Ldec, D), "ln2": zeros(Ldec, D),
           "ln3": zeros(Ldec, D), "self": attn(Ldec), "cross": attn(Ldec),
           "mlp": mlp(Ldec)}
    return {
        "embed": dense_init(generator, (cfg.vocab, D), scale=0.02,
                            dtype=dtype, device=device),
        "ln_enc": zeros(D),
        "ln_f": zeros(D),
        "enc": enc,
        "dec": dec,
    }


def _layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of a stacked (nested) parameter tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _mha(cfg: ArchConfig, ap, xq, xkv, *, causal):
    """Attention of ``xq`` (B, Sq, D) over ``xkv`` (B, Sk, D), both from
    position 0, through the flash attention kernel; returns the projected
    output and the (roped) k, v that a cache keeps."""
    B, Sq, _ = xq.shape
    Sk = xkv.shape[1]
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = torch.matmul(xq, ap["wq"]).reshape(B, Sq, H, Dh)
    k = torch.matmul(xkv, ap["wk"]).reshape(B, Sk, Hkv, Dh)
    v = torch.matmul(xkv, ap["wv"]).reshape(B, Sk, Hkv, Dh)
    q = apply_rope(q, tfm._positions(Sq, 0, xq.device), cfg.rope_theta)
    k = apply_rope(k, tfm._positions(Sk, 0, xq.device), cfg.rope_theta)
    out = ops.mha(q, k, v, causal=causal)
    return torch.matmul(out.reshape(B, Sq, H * Dh), ap["wo"]), (k, v)


def _mlp(cfg: ArchConfig, lp, x):
    m = lp["mlp"]
    return gelu_mlp(x, m["w_up"], m["b_up"], m["w_down"], m["b_down"])


def _encode(cfg: ArchConfig, params: Params, frames: Tensor) -> Tensor:
    """The encoder over ``frames (B, S_enc, D)``, gradients allowed: every
    layer's bidirectional self attention through the flash attention
    kernel, each layer recomputed in the backward when gradients are being
    recorded."""
    def block(lp, x):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _ = _mha(cfg, lp["attn"], h, h, causal=False)
        x = x + a
        return x + _mlp(cfg, lp, rms_norm(x, lp["ln2"], cfg.norm_eps))

    x = frames
    for lp in unstack(params["enc"], cfg.n_encoder_layers or cfg.n_layers):
        x = hint(remat(block, lp, x), "residual")
    return rms_norm(x, params["ln_enc"], cfg.norm_eps)


@torch.no_grad()
def encode(cfg: ArchConfig, params: Params, frames: Tensor) -> Tensor:
    """frames: precomputed embeddings (B, S_enc, D) -- the frontend stub.
    Bidirectional self attention in every layer; no gradients (the
    prefill's encoder)."""
    return _encode(cfg, params, frames)


def decode_train(cfg: ArchConfig, params: Params, enc_out: Tensor,
                 tokens: Tensor) -> Tensor:
    """The decoder over the whole of ``tokens (B, S)`` against ``enc_out``,
    gradients allowed: causal self attention and cross attention through
    the flash attention kernel, each layer recomputed in the backward.
    Returns the final hidden states (B, S, D)."""
    def block(lp, x):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _ = _mha(cfg, lp["self"], h, h, causal=True)
        x = x + a
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        a, _ = _mha(cfg, lp["cross"], h, enc_out, causal=False)
        x = x + a
        return x + _mlp(cfg, lp, rms_norm(x, lp["ln3"], cfg.norm_eps))

    x = tfm.embed_tokens(params, tokens)
    for lp in unstack(params["dec"], cfg.n_layers):
        x = hint(remat(block, lp, x), "residual")
    return rms_norm(x, params["ln_f"], cfg.norm_eps)


def lm_loss(cfg: ArchConfig, params: Params, batch: Dict[str, Tensor]
            ) -> Tensor:
    """Encode ``batch["frames"]`` (cast to bfloat16), decode
    ``batch["tokens"]`` over them, and the chunked cross-entropy against
    ``batch["labels"]``."""
    # no sequence cut here yet: under a mesh the tokens are spread over
    # 'data' alone (transformer.lm_loss)
    with split_sequence(batch["tokens"].shape[1], cut=False) as split:
        params = tfm.spread_grads(params, split)
        enc_out = _encode(cfg, params, batch["frames"].to(torch.bfloat16))
        h = decode_train(cfg, params, enc_out, batch["tokens"])
        return tfm.chunked_xent(cfg, params, h, batch["labels"])


class EncDecCache(NamedTuple):
    k_self: Tensor   # (L, B, Smax, Hkv, Dh)
    v_self: Tensor
    k_cross: Tensor  # (L, B, S_enc, Hkv, Dh) -- computed once at prefill
    v_cross: Tensor
    pos: int         # tokens seen so far, ONE count for all rows


@torch.no_grad()
def prefill(cfg: ArchConfig, params: Params, frames: Tensor, tokens: Tensor,
            max_len: int) -> Tuple[Tensor, EncDecCache]:
    """Encode the frames (cast to bfloat16, as the JAX package does) and run
    the decoder over the prompt ``tokens (B, S)``: last-position logits
    (B, V) and the cache, its self K/V ``max_len`` long (zeros past ``S``)
    and its cross K/V over the frames.  One flash attention launch per
    encoder layer and two per decoder layer (the causal self attention and
    the cross attention)."""
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"a prompt of {S} tokens does not fit a cache of "
                         f"max_len {max_len}")
    enc_out = encode(cfg, params, frames.to(torch.bfloat16))
    x = tfm.embed_tokens(params, tokens)
    L, S_enc = cfg.n_layers, enc_out.shape[1]
    kv = (L, B, max_len, cfg.n_kv_heads, cfg.hd)
    cross = (L, B, S_enc, cfg.n_kv_heads, cfg.hd)
    k_self = torch.zeros(kv, dtype=x.dtype, device=x.device)
    v_self = torch.zeros(kv, dtype=x.dtype, device=x.device)
    k_cross = torch.empty(cross, dtype=x.dtype, device=x.device)
    v_cross = torch.empty(cross, dtype=x.dtype, device=x.device)
    for i in range(L):
        lp = _layer(params["dec"], i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, (k, v) = _mha(cfg, lp["self"], h, h, causal=True)
        k_self[i, :, :S], v_self[i, :, :S] = k, v
        x = x + a
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        a, (k, v) = _mha(cfg, lp["cross"], h, enc_out, causal=False)
        k_cross[i], v_cross[i] = k, v
        x = x + a
        x = x + _mlp(cfg, lp, rms_norm(x, lp["ln3"], cfg.norm_eps))
    h = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = tfm.logits_fn(cfg, params, h[:, -1:])[:, 0]
    return logits, EncDecCache(k_self, v_self, k_cross, v_cross, S)


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Params, cache: EncDecCache,
                tokens: Tensor) -> Tuple[Tensor, EncDecCache]:
    """One decode step: tokens (B, 1) -> logits (B, V), the cache with
    ``pos + 1``.  The self K/V buffers are **updated in place** (a write
    past ``max_len`` is clamped to the last row, as the JAX package's
    ``dynamic_update_slice`` clamps it); the cross K/V are read only."""
    x = tfm.embed_tokens(params, tokens)
    pos = int(cache.pos)
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    for i in range(cfg.n_layers):
        lp = _layer(params["dec"], i)
        k_s, v_s = cache.k_self[i], cache.v_self[i]
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        k_new = torch.matmul(h, lp["self"]["wk"]).reshape(B, S, Hkv, Dh)
        v_new = torch.matmul(h, lp["self"]["wv"]).reshape(B, S, Hkv, Dh)
        k_new = apply_rope(k_new, tfm._positions(S, pos, x.device),
                           cfg.rope_theta)
        at = min(max(pos, 0), k_s.shape[1] - S)
        k_s[:, at:at + S] = k_new.to(k_s.dtype)
        v_s[:, at:at + S] = v_new.to(v_s.dtype)
        q = torch.matmul(h, lp["self"]["wq"]).reshape(B, S, H, Dh)
        q = apply_rope(q, tfm._positions(S, pos, x.device), cfg.rope_theta)
        a = chunked_attention(q, k_s, v_s, causal=True, q_offset=pos,
                              kv_len=pos + 1)
        x = x + torch.matmul(a.reshape(B, S, H * Dh), lp["self"]["wo"])
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        q = torch.matmul(h, lp["cross"]["wq"]).reshape(B, S, H, Dh)
        q = apply_rope(q, tfm._positions(S, pos, x.device), cfg.rope_theta)
        a = chunked_attention(q, cache.k_cross[i], cache.v_cross[i],
                              causal=False)
        x = x + torch.matmul(a.reshape(B, S, H * Dh), lp["cross"]["wo"])
        x = x + _mlp(cfg, lp, rms_norm(x, lp["ln3"], cfg.norm_eps))
    h = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = tfm.logits_fn(cfg, params, h)[:, 0]
    return logits, EncDecCache(cache.k_self, cache.v_self, cache.k_cross,
                               cache.v_cross, pos + 1)
