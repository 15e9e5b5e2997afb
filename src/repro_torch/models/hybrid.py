"""Zamba2-style hybrid: a Mamba2 backbone and one shared attention block.

Zamba2 interleaves Mamba2 blocks with a *single shared* transformer block
re-applied at several depths (arXiv:2411.15242).  The SSM layers are stacked
``(G, per, ...)``: ``G = n_layers // hybrid_period`` groups (sites) of
``per`` layers; after each group the shared block (one parameter set,
``transformer.dense_layer`` with a global window) runs with a KV cache of
its own per site.  In a prefill the shared block attends over the prompt
through the flash attention kernel (one launch a site); in a decode step
through the eager attention against its cache.  Where the JAX package scans
over groups and layers, two plain loops run here.  ``forward`` and
``lm_loss`` carry gradients (through the kernels' autograd functions);
prefill and decode do not.

Tensor parallelism: a rank holds the blocks ``param_specs`` gives it.
The SSM groups run as ``models/ssm.py`` runs them on a rank's heads, and
the shared block as ``transformer.dense_layer`` runs on a rank's query
and kv heads and columns of F; under the train and prefill policies the
residual is cut on its channels between every block, each block's input
gathered on them and its row-parallel ends reduce-scattered on them.  The
cache holds the rank's conv channels, SSM heads and kv heads
(``cache_specs``) -- or, where the policy's ``"__cache__"`` cuts the
shared block's KV on its positions, every kv head of the rank's block of
positions, attended as ``transformer.dense_layer`` attends a cache cut
so.  Where the policy's ``"__params__"`` declares the weights cut over
the data axes too (ZeRO-3), each SSM block's leaves are gathered inside
its group's recomputed body, as ``models/ssm.py`` gathers them; the
shared block's are gathered once a pass, before its first site, so that
in the backward the sites' gradients are summed before the gather's
reduce-scatter, as they are summed before the data sum where the weights
are whole over ``data`` (the two layouts give the same bits).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..parallel.hints import (hint, layer_blocks, model_block,
                              residual_block, split_sequence, whole_channels,
                              whole_layers)
from . import ssm as ssm_mod
from . import transformer as tfm
from .layers import dense_init, remat, rms_norm, unstack

Tensor = torch.Tensor
Params = Dict[str, Any]


def n_sites(cfg: ArchConfig) -> int:
    return max(1, cfg.n_layers // max(1, cfg.hybrid_period))


def _groups(cfg: ArchConfig) -> Tuple[int, int]:
    G = n_sites(cfg)
    return G, cfg.n_layers // G


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cuda", keep=None) -> Params:
    """Random parameters from ``generator`` (which must live on ``device``),
    the JAX package's tree: ``ssm`` stacked ``(G, per, ...)``, one
    ``shared_attn`` parameter set, ``embed`` and ``ln_f``.  ``keep(path,
    leaf)``, where given, replaces each leaf as soon as it is drawn
    (``convert.block_init``), the draws unchanged."""
    G, per = _groups(cfg)
    layers = ssm_mod.init_ssm_layers(cfg, generator, (G, per), dtype, device,
                                     keep=keep, prefix="ssm")
    device = resolve_device(device)
    D, H, Hkv, Dh, Fd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                         cfg.d_ff)

    def init(shape, scale=None):
        return dense_init(generator, shape, scale=scale, dtype=dtype,
                          device=device)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    def leaf(path, t):
        return t if keep is None else keep(path, t)

    shared = {name: leaf("shared_attn/" + name, t) for name, t in (
        ("ln1", zeros(D)), ("ln2", zeros(D)),
        ("wq", init((D, H * Dh))), ("wk", init((D, Hkv * Dh))),
        ("wv", init((D, Hkv * Dh))), ("wo", init((H * Dh, D))),
        ("w_gate", init((D, Fd))), ("w_up", init((D, Fd))),
        ("w_down", init((Fd, D))))}
    return {
        "embed": leaf("embed", init((cfg.vocab, D), scale=0.02)),
        "ln_f": leaf("ln_f", zeros(D)),
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
               dtype=torch.bfloat16, device="cuda", heads=None,
               conv_channels=None, kv_heads=None) -> HybridCache:
    """Zeros; ``heads``, ``conv_channels`` and ``kv_heads`` of them a
    layer (default: every one; a tensor-parallel rank holds its own,
    ``cache_specs``' cut); the KV buffers are the rank's block that the
    policy's ``"__cache__"`` declares (``transformer.cache_block``)."""
    device = resolve_device(device)
    d_inner, H, P, N = ssm_mod.dims(cfg)
    G, per = _groups(cfg)
    rows, kv_heads = tfm.cache_block(cfg, max_len, kv_heads)
    kv = (G, batch, rows, kv_heads, cfg.hd)
    return HybridCache(
        torch.zeros((G, per, batch, cfg.ssm_conv - 1,
                     conv_channels or d_inner + 2 * N),
                    dtype=dtype, device=device),
        torch.zeros((G, per, batch, heads or H, P, N), dtype=torch.float32,
                    device=device),
        torch.zeros(kv, dtype=dtype, device=device),
        torch.zeros(kv, dtype=dtype, device=device),
        0)


def forward(cfg: ArchConfig, params: Params, tokens: Tensor) -> Tensor:
    """tokens (B, S) -> final hidden states (B, S, D): each group's SSM
    blocks, then the shared block attending over the sequence through the
    flash attention kernel; each group recomputed in the backward when
    gradients are being recorded, as the JAX package checkpoints its group
    body.  The shared block's weights gather the gradients of every site.
    Under a policy whose ``"residual"`` cuts the channels the residual
    between blocks is this rank's channels, gathered whole for the final
    norm."""
    with split_sequence(tokens.shape[1], channels=cfg.d_model):
        x = residual_block(tfm.embed_tokens(params, tokens, cfg.vocab))
        G, per = _groups(cfg)
        shared = layer_blocks(params["shared_attn"], "shared_attn", lead=0)

        def group(lps, x, shared):
            for lp in lps:
                x, _ = ssm_mod.ssm_block(cfg, layer_blocks(lp, "ssm", 2), x)
            return tfm.dense_layer(cfg, shared, x, 0)[0]

        for stacked in unstack(whole_layers(params["ssm"], "ssm", 2), G):
            x = hint(remat(group, unstack(stacked, per), x, shared),
                     "residual")
        return rms_norm(whole_channels(x), model_block(params["ln_f"], "ln_f"),
                        cfg.norm_eps)


def lm_loss(cfg: ArchConfig, params: Params, batch: Dict[str, Tensor]
            ) -> Tensor:
    """``forward``, then the chunked cross-entropy; under a policy with a
    ``"__mesh__"`` the gradients come back summed where ranks share a
    leaf (``transformer.spread_grads``)."""
    with split_sequence(batch["tokens"].shape[1],
                        channels=cfg.d_model) as split:
        with tfm.loss_params(params, split) as params:
            h = forward(cfg, params, batch["tokens"])
            return tfm.chunked_xent(cfg, params, h, batch["labels"])


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Params, cache: HybridCache,
                tokens: Tensor) -> Tuple[Tensor, HybridCache]:
    """One decode step: tokens (B, 1) -> logits (B, V), updated cache.  All
    of the cache's buffers are **updated in place**; the returned cache
    shares them and carries ``pos + 1``.  With leaves cut over ``model``
    the cache holds this rank's share of every state."""
    G, per = _groups(cfg)
    pos = int(cache.pos)
    with split_sequence(tokens.shape[1], cut=False):
        x = tfm.embed_tokens(params, tokens, cfg.vocab)
        seq = tfm.kv_layout(cfg, params["shared_attn"]["wk"],
                            path="shared_attn/wk")[1]
        layers = whole_layers(params["ssm"], "ssm", 2)
        shared = layer_blocks(params["shared_attn"], "shared_attn", lead=0)
        for g in range(G):
            for i in range(per):
                x, (conv, state) = ssm_mod.ssm_block(
                    cfg, layer_blocks(ssm_mod.layer(layers, (g, i)), "ssm",
                                      2), x,
                    conv_state=cache.conv[g, i],
                    ssm_state=cache.state[g, i], streaming=True)
                cache.conv[g, i] = conv
                cache.state[g, i] = state
            x, _ = tfm.dense_layer(cfg, shared, x, 0,
                                   cache_kv=(cache.k[g], cache.v[g]),
                                   pos=pos, seq=seq)
        h = rms_norm(x, model_block(params["ln_f"], "ln_f"), cfg.norm_eps)
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
    kernel, once per site.  Under a policy that cuts the residual's
    channels it is this rank's channels between blocks; with leaves cut
    over ``model`` the cache holds this rank's share of every state."""
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"a prompt of {S} tokens does not fit a cache of "
                         f"max_len {max_len}")
    G, per = _groups(cfg)
    with split_sequence(S, channels=cfg.d_model):
        x = residual_block(tfm.embed_tokens(params, tokens, cfg.vocab))
        kv_heads, seq = tfm.kv_layout(cfg, params["shared_attn"]["wk"],
                                      path="shared_attn/wk")
        cache = init_cache(cfg, B, max_len, device=x.device,
                           kv_heads=kv_heads,
                           **ssm_mod.rank_cache_dims(params["ssm"], "ssm"))
        layers = whole_layers(params["ssm"], "ssm", 2)
        shared = layer_blocks(params["shared_attn"], "shared_attn", lead=0)
        for g in range(G):
            for i in range(per):
                x, (conv, state) = ssm_mod.ssm_block(
                    cfg, layer_blocks(ssm_mod.layer(layers, (g, i)), "ssm",
                                      2), x)
                cache.conv[g, i] = conv
                cache.state[g, i] = state
            x, (k, v) = tfm.dense_layer(cfg, shared, x, 0, seq=seq)
            tfm.store_prompt(cache.k[g], k, seq)
            tfm.store_prompt(cache.v[g], v, seq)
        h = rms_norm(whole_channels(x), model_block(params["ln_f"], "ln_f"),
                     cfg.norm_eps)
        logits = tfm.logits_fn(cfg, params, h[:, -1:])[:, 0]
    return logits, HybridCache(cache.conv, cache.state, cache.k, cache.v, S)
