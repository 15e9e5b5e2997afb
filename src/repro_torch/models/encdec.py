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

Under a policy whose ``"residual"`` cuts the sequence over ``model``
(the attention families' layout, ``parallel/hints.py``) the encoder's
pass over the frames and the decoder's over the tokens each declare
their sequence (both are cut, or neither): the residual is this rank's
block, each block input is gathered whole, and the encoder's output is
gathered once for every decoder layer's cross K/V (its gradient
reduce-scattered).  With weights cut by ``param_specs`` over ``model``
(tensor parallelism) the self and cross attention run on this rank's
query and kv heads, ``wo`` and the MLP end with the row-parallel sum
(the MLP's whole ``b_down`` added once, after it), the caches hold this
rank's kv heads, and the embedding and logits are vocabulary-parallel
where the vocabulary is cut (an odd one, 51,865 at full width, is not).
Where the cut splits a head (whisper-base's 8 heads over 16 ranks) each
attention runs on whole heads as ``transformer.dense_layer`` runs it
(q, k and v gathered, this rank's channels times its ``wo`` rows); where
the policy's ``"__cache__"`` cuts the caches on their positions, the
self cache holds the rank's block of ``max_len / n`` positions and the
cross cache its block of the frames, every kv head, and each decode
step's attention is a partial softmax merged over the cut's ranks.
Where the policy's ``"__params__"`` declares the weights cut over the
data axes too (ZeRO-3), every pass gathers each encoder and decoder
layer's leaves, the cross attention's included, into their ``model``
blocks inside the layer's recomputed body, and ``embed``, ``ln_enc`` and
``ln_f`` where they are used (``parallel.hints.layer_blocks``,
``whole_layers``, ``model_block``), as ``models/transformer.py`` does.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..configs.base import ArchConfig
from ..kernels import ops
from ..parallel.hints import (column_in, current_split, hint, layer_blocks,
                              model_block, model_shape, residual_block,
                              row_parallel_end, split_sequence, whole_layers)
from . import transformer as tfm
from .layers import (apply_rope, chunked_attention, dense_init,
                     parallel_gelu_mlp, param_device, remat, rms_norm,
                     unstack)

Tensor = torch.Tensor
Params = Dict[str, Any]


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cuda", keep=None) -> Params:
    """Random parameters from ``generator`` (which must live on ``device``),
    the JAX package's tree: ``embed``, ``ln_enc``, ``ln_f``, and ``enc`` /
    ``dec`` stacked over their layers.  One layer's float32 draw at a
    time.  ``keep(path, leaf)``, where given, replaces each leaf as soon
    as it is drawn (``convert.block_init``), the draws unchanged."""
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

    def leaf(path, t):
        return t if keep is None else keep(path, t)

    def attn(path, L):
        return {k: leaf(f"{path}/{k}", stack(L, shape)) for k, shape in (
            ("wq", (D, H * Dh)), ("wk", (D, Hkv * Dh)),
            ("wv", (D, Hkv * Dh)), ("wo", (H * Dh, D)))}

    def mlp(path, L):
        return {"w_up": leaf(path + "/w_up", stack(L, (D, F))),
                "b_up": leaf(path + "/b_up", zeros(L, F)),
                "w_down": leaf(path + "/w_down", stack(L, (F, D))),
                "b_down": leaf(path + "/b_down", zeros(L, D))}

    enc = {"ln1": leaf("enc/ln1", zeros(Lenc, D)),
           "ln2": leaf("enc/ln2", zeros(Lenc, D)),
           "attn": attn("enc/attn", Lenc), "mlp": mlp("enc/mlp", Lenc)}
    dec = {"ln1": leaf("dec/ln1", zeros(Ldec, D)),
           "ln2": leaf("dec/ln2", zeros(Ldec, D)),
           "ln3": leaf("dec/ln3", zeros(Ldec, D)),
           "self": attn("dec/self", Ldec), "cross": attn("dec/cross", Ldec),
           "mlp": mlp("dec/mlp", Ldec)}
    return {
        "embed": leaf("embed", dense_init(generator, (cfg.vocab, D),
                                          scale=0.02, dtype=dtype,
                                          device=device)),
        "ln_enc": leaf("ln_enc", zeros(D)),
        "ln_f": leaf("ln_f", zeros(D)),
        "enc": enc,
        "dec": dec,
    }


def _layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of a stacked (nested) parameter tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def heads_cut(cfg: ArchConfig, ap) -> bool:
    """Whether an attention's weights are cut over ``model``: its ``wq``
    holds fewer than every head (tensor parallelism)."""
    return ap["wq"].shape[-1] < cfg.n_heads * cfg.hd


def _whole_sequence(h, tp: bool):
    """A block input over the whole sequence of its rows: with weights
    cut over ``model``, ``hints.column_in`` (the sequence gathered under a
    cut, else the gradient summed over ``model``); with whole weights the
    sequence gathered where the pass cuts it; else ``h``."""
    if tp:
        return column_in(h)
    split = current_split()
    return h if split is None else split.gather(h)


def _end(t, tp: bool):
    """What the residual add takes of an attention's projected output
    over the whole sequence: with weights cut over ``model`` the
    row-parallel sum (reduce-scattered into this rank's block under a
    cut), else this rank's block of it."""
    return row_parallel_end(t) if tp else residual_block(t)


def _mha(cfg: ArchConfig, ap, xq, xkv, *, causal, seq=None):
    """Attention of ``xq`` (B, Sq, D) over ``xkv`` (B, Sk, D), both from
    position 0, through the flash attention kernel; returns the projected
    output and the (roped) k, v that a cache keeps.  With weights cut over
    ``model``: this rank's heads, and the output its partial sums; on
    whole heads (``transformer.on_whole_heads``) the k, v of every kv
    head and float32 partial sums."""
    if tfm.on_whole_heads(cfg, ap, seq):
        return tfm.whole_heads_attention(cfg, ap, xq, xkv, causal=causal)
    B, Sq, _ = xq.shape
    Sk = xkv.shape[1]
    Dh = cfg.hd
    q = torch.matmul(xq, ap["wq"]).reshape(B, Sq, -1, Dh)
    k = torch.matmul(xkv, ap["wk"]).reshape(B, Sk, -1, Dh)
    v = torch.matmul(xkv, ap["wv"]).reshape(B, Sk, -1, Dh)
    q = apply_rope(q, tfm._positions(Sq, 0, xq.device), cfg.rope_theta)
    k = apply_rope(k, tfm._positions(Sk, 0, xq.device), cfg.rope_theta)
    out = ops.mha(q, k, v, causal=causal)
    return torch.matmul(out.reshape(B, Sq, -1), ap["wo"]), (k, v)


def _mlp(cfg: ArchConfig, lp, x):
    m = lp["mlp"]
    return parallel_gelu_mlp(x, m["w_up"], m["b_up"], m["w_down"],
                             m["b_down"], cfg.d_ff)


def _enc_layer(cfg: ArchConfig, lp, x):
    """One encoder layer: bidirectional self attention, then the MLP."""
    tp = heads_cut(cfg, lp["attn"])
    h = _whole_sequence(rms_norm(x, lp["ln1"], cfg.norm_eps), tp)
    a, _ = _mha(cfg, lp["attn"], h, h, causal=False)
    x = x + _end(a, tp).to(x.dtype)
    return x + _mlp(cfg, lp, rms_norm(x, lp["ln2"], cfg.norm_eps))


def _dec_layer(cfg: ArchConfig, lp, x, enc_out, seq=None, seq_cross=None):
    """One decoder layer over the prompt: causal self attention, cross
    attention over ``enc_out`` (the whole sequence of frames), the MLP.
    Returns ``x`` and the self and cross ``(k, v)`` a cache keeps
    (``seq``, ``seq_cross``: the caches' cuts on their positions, whose
    K/V are every kv head's)."""
    tp = heads_cut(cfg, lp["self"])
    h = _whole_sequence(rms_norm(x, lp["ln1"], cfg.norm_eps), tp)
    a, kv_self = _mha(cfg, lp["self"], h, h, causal=True, seq=seq)
    x = x + _end(a, tp).to(x.dtype)
    h = _whole_sequence(rms_norm(x, lp["ln2"], cfg.norm_eps), tp)
    a, kv_cross = _mha(cfg, lp["cross"], h, enc_out, causal=False,
                       seq=seq_cross)
    x = x + _end(a, tp).to(x.dtype)
    x = x + _mlp(cfg, lp, rms_norm(x, lp["ln3"], cfg.norm_eps))
    return x, kv_self, kv_cross


def both_cut(S_enc: int, S_dec: int) -> bool:
    """Whether the policy in force cuts both the encoder's sequence of
    ``S_enc`` frames and the decoder's of ``S_dec`` tokens: the passes
    are cut together or not at all, so that every whole leaf's gradient
    is summed over the same groups."""
    cut = []
    for S in (S_enc, S_dec):
        with split_sequence(S) as split:
            cut.append(split is not None and split.cut)
    return all(cut)


def _encode(cfg: ArchConfig, params: Params, frames: Tensor,
            cut: bool = True) -> Tensor:
    """The encoder over ``frames (B, S_enc, D)``, gradients allowed: every
    layer's bidirectional self attention through the flash attention
    kernel, each layer recomputed in the backward when gradients are being
    recorded.  Under a sequence cut (``cut`` and the policy's) the
    residual is this rank's block of the frames; the output is the whole
    sequence, gathered once (its gradient reduce-scattered) for every
    decoder layer's cross K/V."""
    with split_sequence(frames.shape[1], cut):
        def block(lp, x):
            return _enc_layer(cfg, layer_blocks(lp, "enc"), x)

        x = residual_block(frames)
        for lp in unstack(whole_layers(params["enc"], "enc"),
                          cfg.n_encoder_layers or cfg.n_layers):
            x = hint(remat(block, lp, x), "residual")
        cross = model_shape(params["dec"]["cross"]["wq"], "dec/cross/wq")
        return _whole_sequence(
            rms_norm(x, model_block(params["ln_enc"], "ln_enc"),
                     cfg.norm_eps),
            cross[-1] < cfg.n_heads * cfg.hd)


@torch.no_grad()
def encode(cfg: ArchConfig, params: Params, frames: Tensor,
           cut: bool = True) -> Tensor:
    """frames: precomputed embeddings (B, S_enc, D) -- the frontend stub.
    Bidirectional self attention in every layer; no gradients (the
    prefill's encoder)."""
    return _encode(cfg, params, frames, cut)


def decode_train(cfg: ArchConfig, params: Params, enc_out: Tensor,
                 tokens: Tensor, cut: bool = True) -> Tensor:
    """The decoder over the whole of ``tokens (B, S)`` against ``enc_out``
    (the whole sequence of frames), gradients allowed: causal self
    attention and cross attention through the flash attention kernel,
    each layer recomputed in the backward.  Returns the final hidden
    states (B, S, D): this rank's block of the sequence under a cut."""
    with split_sequence(tokens.shape[1], cut):
        def block(lp, x):
            return _dec_layer(cfg, layer_blocks(lp, "dec"), x, enc_out)[0]

        x = residual_block(tfm.embed_tokens(params, tokens, cfg.vocab))
        for lp in unstack(whole_layers(params["dec"], "dec"), cfg.n_layers):
            x = hint(remat(block, lp, x), "residual")
        return rms_norm(x, model_block(params["ln_f"], "ln_f"), cfg.norm_eps)


def lm_loss(cfg: ArchConfig, params: Params, batch: Dict[str, Tensor]
            ) -> Tensor:
    """Encode ``batch["frames"]`` (cast to bfloat16), decode
    ``batch["tokens"]`` over them, and the chunked cross-entropy against
    ``batch["labels"]``.  Under a policy with a ``"__mesh__"`` the
    gradients come back summed where ranks share a leaf
    (``transformer.spread_grads``)."""
    frames, tokens = batch["frames"], batch["tokens"]
    cut = both_cut(frames.shape[1], tokens.shape[1])
    with split_sequence(tokens.shape[1], cut) as split:
        with tfm.loss_params(params, split) as params:
            enc_out = _encode(cfg, params, frames.to(torch.bfloat16), cut)
            h = decode_train(cfg, params, enc_out, tokens, cut)
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
    the cross attention).  Under a sequence cut the logits are the last
    block's rank's, in every rank (``transformer.last_logits``); with
    weights cut over ``model`` the caches hold this rank's kv heads
    (``transformer.kv_layout``), or, where the policy's ``"__cache__"``
    cuts them on their positions, every kv head of this rank's block of
    positions and of frames."""
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"a prompt of {S} tokens does not fit a cache of "
                         f"max_len {max_len}")
    cut = both_cut(frames.shape[1], S)
    enc_out = encode(cfg, params, frames.to(torch.bfloat16), cut)
    with split_sequence(S, cut) as split:
        x = residual_block(tfm.embed_tokens(params, tokens, cfg.vocab))
        L, S_enc = cfg.n_layers, enc_out.shape[1]
        dec = whole_layers(params["dec"], "dec")
        Hkv, seq = tfm.kv_layout(cfg, dec["self"]["wk"], "k_self",
                                 "dec/self/wk")
        Hkv_x, seq_x = tfm.kv_layout(cfg, dec["cross"]["wk"], "k_cross",
                                     "dec/cross/wk")
        kv = (L, B, tfm.cache_block(cfg, max_len, Hkv, "k_self")[0], Hkv,
              cfg.hd)
        cross = (L, B, tfm.cache_block(cfg, S_enc, Hkv_x, "k_cross")[0],
                 Hkv_x, cfg.hd)
        k_self = torch.zeros(kv, dtype=x.dtype, device=x.device)
        v_self = torch.zeros(kv, dtype=x.dtype, device=x.device)
        k_cross = torch.empty(cross, dtype=x.dtype, device=x.device)
        v_cross = torch.empty(cross, dtype=x.dtype, device=x.device)
        for i in range(L):
            x, (k, v), (kc, vc) = _dec_layer(
                cfg, layer_blocks(_layer(dec, i), "dec"), x, enc_out, seq,
                seq_x)
            for buf, t, cut in ((k_self[i], k, seq), (v_self[i], v, seq),
                                (k_cross[i], kc, seq_x),
                                (v_cross[i], vc, seq_x)):
                tfm.store_prompt(buf, t, cut)
        h = rms_norm(x, model_block(params["ln_f"], "ln_f"), cfg.norm_eps)
        logits = tfm.last_logits(cfg, params, h, split)
    return logits, EncDecCache(k_self, v_self, k_cross, v_cross, S)


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Params, cache: EncDecCache,
                tokens: Tensor) -> Tuple[Tensor, EncDecCache]:
    """One decode step: tokens (B, 1) -> logits (B, V), the cache with
    ``pos + 1``.  The self K/V buffers are **updated in place** (a write
    past ``max_len`` is clamped to the last row, as the JAX package's
    ``dynamic_update_slice`` clamps it); the cross K/V are read only.
    With weights cut over ``model`` each attention runs on this rank's
    heads against this rank's kv heads of the caches, and ``wo`` and the
    MLP end with the all-reduce; on whole heads
    (``transformer.on_whole_heads``) every query head attends, over a
    cache cut on its positions as a partial softmax merged over the cut's
    ranks, the new token written by the rank whose block holds ``pos``."""
    pos = int(cache.pos)
    Dh = cfg.hd
    with split_sequence(tokens.shape[1], cut=False):
        x = tfm.embed_tokens(params, tokens, cfg.vocab)
        B, S, _ = x.shape
        seq = tfm.kv_layout(cfg, params["dec"]["self"]["wk"], "k_self",
                            "dec/self/wk")[1]
        seq_x = tfm.kv_layout(cfg, params["dec"]["cross"]["wk"],
                              "k_cross", "dec/cross/wk")[1]
        dec = whole_layers(params["dec"], "dec")
        for i in range(cfg.n_layers):
            lp = layer_blocks(_layer(dec, i), "dec")
            tp = heads_cut(cfg, lp["self"])
            k_s, v_s = cache.k_self[i], cache.v_self[i]
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            if tp:
                h = column_in(h)
            if tfm.on_whole_heads(cfg, lp["self"], seq):
                o, _ = tfm.whole_heads_attention(
                    cfg, lp["self"], h, h, cache_kv=(k_s, v_s), pos=pos,
                    seq=seq)
            else:
                k_new = torch.matmul(h, lp["self"]["wk"]).reshape(
                    B, S, -1, Dh)
                v_new = torch.matmul(h, lp["self"]["wv"]).reshape(
                    B, S, -1, Dh)
                if k_s.shape[2] != k_new.shape[2]:
                    raise ValueError(
                        f"a cache of {k_s.shape[2]} kv heads for a layer of "
                        f"{k_new.shape[2]}: a tensor-parallel layer's cache "
                        f"holds its rank's kv heads")
                k_new = apply_rope(k_new, tfm._positions(S, pos, x.device),
                                   cfg.rope_theta)
                at = min(max(pos, 0), k_s.shape[1] - S)
                k_s[:, at:at + S] = k_new.to(k_s.dtype)
                v_s[:, at:at + S] = v_new.to(v_s.dtype)
                q = torch.matmul(h, lp["self"]["wq"]).reshape(B, S, -1, Dh)
                q = apply_rope(q, tfm._positions(S, pos, x.device),
                               cfg.rope_theta)
                a = chunked_attention(q, k_s, v_s, causal=True, q_offset=pos,
                                      kv_len=pos + 1)
                o = torch.matmul(a.reshape(B, S, -1), lp["self"]["wo"])
            x = x + (row_parallel_end(o) if tp else o).to(x.dtype)
            h = rms_norm(x, lp["ln2"], cfg.norm_eps)
            if tp:
                h = column_in(h)
            if tfm.on_whole_heads(cfg, lp["cross"], seq_x):
                o, _ = tfm.whole_heads_attention(
                    cfg, lp["cross"], h, None, causal=False,
                    cache_kv=(cache.k_cross[i], cache.v_cross[i]), pos=pos,
                    seq=seq_x)
            else:
                q = torch.matmul(h, lp["cross"]["wq"]).reshape(B, S, -1, Dh)
                q = apply_rope(q, tfm._positions(S, pos, x.device),
                               cfg.rope_theta)
                a = chunked_attention(q, cache.k_cross[i], cache.v_cross[i],
                                      causal=False)
                o = torch.matmul(a.reshape(B, S, -1), lp["cross"]["wo"])
            x = x + (row_parallel_end(o) if tp else o).to(x.dtype)
            x = x + _mlp(cfg, lp, rms_norm(x, lp["ln3"], cfg.norm_eps))
        h = rms_norm(x, model_block(params["ln_f"], "ln_f"), cfg.norm_eps)
        logits = tfm.logits_fn(cfg, params, h)[:, 0]
    return logits, EncDecCache(cache.k_self, cache.v_self, cache.k_cross,
                               cache.v_cross, pos + 1)
