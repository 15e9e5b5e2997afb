"""Zamba2-style hybrid: a Mamba2 backbone and one shared attention block.

Zamba2 interleaves Mamba2 blocks with a *single shared* transformer block
re-applied at several depths (arXiv:2411.15242).  The SSM layers are stacked
``(G, per, ...)``: ``G = n_layers // hybrid_period`` groups (sites) of
``per`` layers; after each group the shared block (one parameter set,
``transformer.dense_layer`` with a global window) runs with a KV cache of
its own per site.  In a prefill the shared block attends over the prompt
through the flash attention kernel (one launch a site); in a decode step
through the eager attention against its cache.  Where the JAX package scans
over groups and layers, two plain loops run here.  The training forward and
the loss are not here yet.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from . import ssm as ssm_mod
from . import transformer as tfm
from .layers import dense_init, rms_norm

Tensor = torch.Tensor
Params = Dict[str, Any]


def n_sites(cfg: ArchConfig) -> int:
    return max(1, cfg.n_layers // max(1, cfg.hybrid_period))


def _groups(cfg: ArchConfig) -> Tuple[int, int]:
    G = n_sites(cfg)
    return G, cfg.n_layers // G


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cuda") -> Params:
    """Random parameters from ``generator`` (which must live on ``device``),
    the JAX package's tree: ``ssm`` stacked ``(G, per, ...)``, one
    ``shared_attn`` parameter set, ``embed`` and ``ln_f``."""
    G, per = _groups(cfg)
    layers = ssm_mod.init_ssm_layers(cfg, generator, (G, per), dtype, device)
    device = resolve_device(device)
    D, H, Hkv, Dh, Fd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                         cfg.d_ff)

    def init(shape, scale=None):
        return dense_init(generator, shape, scale=scale, dtype=dtype,
                          device=device)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    shared = {
        "ln1": zeros(D), "ln2": zeros(D),
        "wq": init((D, H * Dh)), "wk": init((D, Hkv * Dh)),
        "wv": init((D, Hkv * Dh)), "wo": init((H * Dh, D)),
        "w_gate": init((D, Fd)), "w_up": init((D, Fd)),
        "w_down": init((Fd, D)),
    }
    return {
        "embed": init((cfg.vocab, D), scale=0.02),
        "ln_f": zeros(D),
        "ssm": layers,           # stacked (G, per, ...)
        "shared_attn": shared,   # one parameter set, reused at G sites
    }


class HybridCache(NamedTuple):
    conv: Tensor    # (G, per, B, W-1, conv_dim)
    state: Tensor   # (G, per, B, H, P, N) float32
    k: Tensor       # (G, B, Smax, Hkv, Dh): per-site KV of the shared block
    v: Tensor
    pos: int        # tokens seen so far, ONE count for all slots


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> HybridCache:
    device = resolve_device(device)
    d_inner, H, P, N = ssm_mod.dims(cfg)
    G, per = _groups(cfg)
    kv = (G, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return HybridCache(
        torch.zeros((G, per, batch, cfg.ssm_conv - 1, d_inner + 2 * N),
                    dtype=dtype, device=device),
        torch.zeros((G, per, batch, H, P, N), dtype=torch.float32,
                    device=device),
        torch.zeros(kv, dtype=dtype, device=device),
        torch.zeros(kv, dtype=dtype, device=device),
        0)


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Params, cache: HybridCache,
                tokens: Tensor) -> Tuple[Tensor, HybridCache]:
    """One decode step: tokens (B, 1) -> logits (B, V), updated cache.  All
    of the cache's buffers are **updated in place**; the returned cache
    shares them and carries ``pos + 1``."""
    x = params["embed"].to(torch.bfloat16)[tokens]
    G, per = _groups(cfg)
    pos = int(cache.pos)
    for g in range(G):
        for i in range(per):
            x, (conv, state) = ssm_mod.ssm_block(
                cfg, ssm_mod.layer(params["ssm"], (g, i)), x,
                conv_state=cache.conv[g, i], ssm_state=cache.state[g, i],
                streaming=True)
            cache.conv[g, i] = conv
            cache.state[g, i] = state
        x, _ = tfm.dense_layer(cfg, params["shared_attn"], x, 0,
                               cache_kv=(cache.k[g], cache.v[g]), pos=pos)
    h = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = tfm.logits_fn(cfg, params, h)[:, 0]
    return logits, HybridCache(cache.conv, cache.state, cache.k, cache.v,
                               pos + 1)


@torch.no_grad()
def prefill(cfg: ArchConfig, params: Params, tokens: Tensor, max_len: int
            ) -> Tuple[Tensor, HybridCache]:
    """tokens (B, S) -> logits of the last position (B, V) and the cache
    that decoding goes on from, its KV buffers ``max_len`` long (zeros past
    ``S``).  Every SSM block runs the chunked scan (the ``ssd_chunk``
    kernel ``ceil(S / ssm_chunk)`` times per layer); the shared block
    attends over the prompt without a cache, through the flash attention
    kernel, once per site."""
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"a prompt of {S} tokens does not fit a cache of "
                         f"max_len {max_len}")
    x = params["embed"].to(torch.bfloat16)[tokens]
    G, per = _groups(cfg)
    cache = init_cache(cfg, B, max_len, device=x.device)
    for g in range(G):
        for i in range(per):
            x, (conv, state) = ssm_mod.ssm_block(
                cfg, ssm_mod.layer(params["ssm"], (g, i)), x)
            cache.conv[g, i] = conv
            cache.state[g, i] = state
        x, (k, v) = tfm.dense_layer(cfg, params["shared_attn"], x, 0)
        cache.k[g, :, :S] = k
        cache.v[g, :, :S] = v
    h = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = tfm.logits_fn(cfg, params, h[:, -1:])[:, 0]
    return logits, HybridCache(cache.conv, cache.state, cache.k, cache.v, S)
