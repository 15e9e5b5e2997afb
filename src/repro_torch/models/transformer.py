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
with one (decode) through ``chunked_attention``, whose decode branch is the
decode-attention kernel on the card (``kernels/decode_attention.py``).  Beside
``decode_step`` stand its two variants: ``grouped_decode_step``, whose
local-attention layers keep a ring of ``window`` rows (the slot ``pos mod
W`` is a bank address of the paper's Eq. 1 with N = W, B = 1), and
``decode_step_quant``, over an int8 cache with a scale per token and head.
As in the JAX package, neither the server nor ``get_model`` uses them.
``lm_loss`` is the training objective: ``forward``, then the chunked
cross-entropy; gradients flow through ``forward`` (and through the
flash attention kernel's autograd function), while ``prefill`` and every
decode step run without them.  Under a sharding policy with a live mesh
whose ``"residual"`` cuts the sequence, ``forward``, ``lm_loss`` and
``prefill`` carry this rank's block of the sequence between layers
(``parallel/hints.py``; Megatron sequence parallelism).  With weights cut
over ``model`` a layer runs on this rank's heads; where the cut splits a
head, or the policy's ``"__cache__"`` cuts the KV cache on its positions,
on whole heads gathered over ``model`` (:func:`whole_heads`), a decode
step's attention over the cache then a partial softmax merged over the
ranks that hold its blocks.  Where the policy's ``"__params__"`` declares
the weights cut over the data axes too (ZeRO-3), every pass gathers each
layer's leaves into their ``model`` blocks inside the layer's body, and
the whole-model leaves where they are used (``parallel.hints.
layer_blocks``, ``model_block``).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.tracing import MODEL_SPANS
from ..device import resolve_device
from ..kernels import ops
from ..parallel.hints import (cache_cut, column_in, current_split,
                              cut_axes, gathered_once, hint, layer_blocks,
                              model_axis,
                              model_block, model_shape, policy_value,
                              residual_block, row_parallel_end,
                              split_sequence, whole_channels, whole_layers)
from ..parallel.sharding import head_span
from .layers import (NEG_INF, apply_rope, attention_partials,
                     chunked_attention, dense_init, merge_partials,
                     param_device, parallel_swiglu, remat, rms_norm, swiglu,
                     unstack)

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
                      dtype=torch.bfloat16, device="cuda", keep=None
                      ) -> Params:
    """Random parameters from ``generator`` (which must live on ``device``,
    so a card fills its own weights), same tree and shapes as the JAX
    package's; the numbers differ, since the two frameworks draw
    differently from a seed.  ``keep(path, leaf)``, where given, replaces
    each leaf as soon as it is drawn (``convert.block_init``: a rank's
    block of it), the draws unchanged."""
    device = param_device(generator, device)
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

    def leaf(path, t):
        return t if keep is None else keep(path, t)

    p: Params = {
        "embed": leaf("embed", init((V, D), scale=0.02)),
        "ln_f": leaf("ln_f", zeros(D)),
        "layers": {
            "ln1": leaf("layers/ln1", zeros(L, D)),
            "ln2": leaf("layers/ln2", zeros(L, D)),
            "wq": leaf("layers/wq", stack((D, H * Dh))),
            "wk": leaf("layers/wk", stack((D, Hkv * Dh))),
            "wv": leaf("layers/wv", stack((D, Hkv * Dh))),
            "wo": leaf("layers/wo", stack((H * Dh, D))),
            "w_gate": leaf("layers/w_gate", stack((D, F))),
            "w_up": leaf("layers/w_up", stack((D, F))),
            "w_down": leaf("layers/w_down", stack((F, D))),
        },
    }
    if cfg.qkv_bias:
        p["layers"]["bq"] = leaf("layers/bq", zeros(L, H * Dh))
        p["layers"]["bk"] = leaf("layers/bk", zeros(L, Hkv * Dh))
        p["layers"]["bv"] = leaf("layers/bv", zeros(L, Hkv * Dh))
    if not cfg.tie_embeddings:
        p["lm_head"] = leaf("lm_head", init((V, D), scale=0.02))
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
    q = q.reshape(B, S, -1, cfg.hd)       # this rank's heads
    return apply_rope(q, _positions(S, q_offset, x.device), cfg.rope_theta)


def _attn(cfg: ArchConfig, lp, x, *, k_full, v_full, window, q_offset,
          kv_len, block_k=1024):
    """Attention of one layer's queries at ``q_offset`` against a cache
    whose first ``kv_len`` rows are valid: ``chunked_attention`` (a few
    rows over a buffer past ``block_k``: the decode-attention kernel on the
    card)."""
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


def heads_cut(cfg: ArchConfig, lp) -> bool:
    """Whether a layer's attention weights are cut over ``model``: its
    ``wq`` holds fewer than every head (tensor parallelism)."""
    return lp["wq"].shape[-1] < cfg.n_heads * cfg.hd


def heads_split(cfg: ArchConfig, lp) -> bool:
    """Whether a layer's attention weights are cut over ``model`` off head
    boundaries: its block of ``wq``'s or ``wk``'s columns is not whole
    heads (``parallel.sharding.head_span``)."""
    return bool(lp["wq"].shape[-1] % cfg.hd or lp["wk"].shape[-1] % cfg.hd)


def on_whole_heads(cfg: ArchConfig, lp, seq=None) -> bool:
    """Whether an attention runs on whole heads (the section below): its
    weights cut off head boundaries, or its cache cut on its positions
    (``seq``)."""
    return seq is not None or (heads_cut(cfg, lp) and heads_split(cfg, lp))


# ---------------------------------------------------------------------------
# Attention on whole heads: weights cut off head boundaries, or a cache cut
# on its positions.  Each rank projects its block of columns (bias
# included) and gathers q, k and v whole on the channels over ``model``
# (RoPE pairs channel i with i + hd/2 of a head); over a prompt it attends
# on the whole heads its ``wo`` rows touch (``head_span``), over a cache on
# every head; then it multiplies its own channels by its ``wo`` rows, the
# partial sums kept in float32 for the row-parallel end.
# ---------------------------------------------------------------------------


def whole_heads(cfg: ArchConfig, lp, h, name: str, offset=None):
    """``h (B, S, D)`` projected by ``lp[name]`` (``wq``, ``wk`` or
    ``wv``; plus its bias ``bq``/``bk``/``bv`` where the layer has one) on
    every head: ``(B, S, heads, hd)``.  A block of columns cut over
    ``model`` is all-gathered in rank order, the gather's gradient
    reduce-scattered and summed in float32 (a head two ranks touch takes
    both ranks' cotangents).  RoPE at positions from ``offset`` where
    given."""
    B, S, _ = h.shape
    heads = cfg.n_heads if name == "wq" else cfg.n_kv_heads
    t = torch.matmul(h, lp[name])
    bias = "b" + name[1:]
    if bias in lp:
        t = t + lp[bias]
    if t.shape[-1] != heads * cfg.hd:
        from ..parallel.collectives import all_gather_dim
        t = all_gather_dim(t, 2, model_axis()[0], torch.float32)
    t = t.reshape(B, S, heads, cfg.hd)
    if offset is None:
        return t
    return apply_rope(t, _positions(S, offset, h.device), cfg.rope_theta)


def out_span(cfg: ArchConfig, lp):
    """This rank's channels ``(lo, hi)`` of the attention output (its
    rows of ``wo``) and the whole heads ``(h0, h1)`` they touch: the cut's
    :func:`parallel.sharding.head_span`, or every channel and head."""
    width = cfg.n_heads * cfg.hd
    if lp["wo"].shape[-2] == width:
        return (0, width), (0, cfg.n_heads)
    _, n, m = model_axis()
    return head_span(width, n, m, cfg.hd)


def attend_prompt(cfg: ArchConfig, lp, q, k, v, *, causal=True, window=0):
    """Attention over a prompt from position 0 on the whole heads this
    rank's channels touch (:func:`out_span`), through the flash attention
    kernel, its kv heads repeated per query head of the range (a touched
    range need not be whole GQA groups); returns this rank's channels of
    the output, ``(B, Sq, hi - lo)``."""
    B, Sq = q.shape[:2]
    (lo, hi), (h0, h1) = out_span(cfg, lp)
    kv_of = torch.arange(h0, h1, device=q.device) // (
        cfg.n_heads // cfg.n_kv_heads)
    out = ops.mha(q[:, :, h0:h1], k[:, :, kv_of], v[:, :, kv_of],
                  causal=causal, window=int(window))
    return out.reshape(B, Sq, -1)[..., lo - h0 * cfg.hd:hi - h0 * cfg.hd]


def attend_cache(cfg: ArchConfig, lp, q, k_buf, v_buf, seq, *,
                 causal=True, window=0, q_offset=0, kv_len=None):
    """Attention of every query head ``q (B, Sq, H, hd)`` against every
    kv head of this rank's block of positions of a cache cut on them
    (``seq``, ``hints.SequenceCut``): each rank's partial softmax
    (``layers.attention_partials``, absolute positions for the causal and
    window masks) merged over the cut's ranks.  Returns this rank's
    channels of the output (:func:`out_span`) in ``q``'s dtype."""
    B, Sq = q.shape[:2]
    (lo, hi), _ = out_span(cfg, lp)
    rows = k_buf.shape[1]
    out = merge_partials(*attention_partials(
        q, k_buf, v_buf, causal=causal, window=window, q_offset=q_offset,
        k_offset=seq.index * rows, kv_len=kv_len), seq.amax, seq.total)
    return out.to(q.dtype).reshape(B, Sq, -1)[..., lo:hi]


def out_proj(lp, o, width: int):
    """``o``, this rank's channels of the attention output, times its
    rows of ``wo``: float32 partial sums where ``wo`` is cut over
    ``model`` (``hints.row_parallel_end`` sums them), else the whole
    product in ``o``'s dtype (``width``: the whole ``wo``'s rows)."""
    if lp["wo"].shape[-2] == width:
        return torch.matmul(o, lp["wo"])
    return torch.matmul(o.float(), lp["wo"].float())


def put_rows(pairs, pos, seq=None):
    """Each ``(buf (B, rows, ...), t (B, S, ...))`` of ``pairs``: the new
    rows ``t`` at row ``pos`` of the whole buffer, **in place**: a write
    past the whole buffer's end (this block's rows times ``seq.n``) is
    clamped to fit, as the JAX package's ``dynamic_update_slice`` clamps
    it; a rank holding a block of the rows (``seq``) writes only the rows
    its block holds."""
    S, rows = pairs[0][1].shape[1], pairs[0][0].shape[1]
    at = min(max(int(pos), 0), rows * (seq.n if seq else 1) - S)
    base = seq.index * rows if seq else 0
    a, b = max(at, base), min(at + S, base + rows)
    if a < b:
        for buf, t in pairs:
            buf[:, a - base:b - base] = t[:, a - at:b - at].to(buf.dtype)



def store_prompt(buf, t, seq=None):
    """A prompt's rows ``t (B, S, ...)`` from position 0 into ``buf (B,
    rows, ...)``: its first ``S`` rows, or, for a rank's block of
    positions (``seq``), the prompt's rows that the block holds."""
    rows = buf.shape[1]
    base = seq.index * rows if seq else 0
    end = min(base + rows, t.shape[1])
    if end > base:
        buf[:, :end - base] = t[:, base:end]


def whole_heads_attention(cfg: ArchConfig, lp, h, kv_in, *, causal=True,
                          window=0, cache_kv=None, pos=0, seq=None):
    """An attention on whole heads (the section above) of ``h (B, S, D)``
    over keys and values projected from ``kv_in`` at position ``pos``:
    over them alone (a prompt from position 0), or written into this
    rank's block of a cache cut on its positions, ``cache_kv`` (``seq``),
    and attended over its first ``pos + S`` rows.  ``kv_in`` None attends
    a cache that already holds every key and value (a decode step's cross
    attention).  Returns ``(wo's product, (k, v))``: the product this
    rank's float32 partial sums where the weights are cut, ``k``/``v``
    every kv head of the new rows (None without ``kv_in``)."""
    q = whole_heads(cfg, lp, h, "wq", pos)
    k = v = None
    if kv_in is not None:
        k = whole_heads(cfg, lp, kv_in, "wk", pos)
        v = whole_heads(cfg, lp, kv_in, "wv")
    if cache_kv is None:
        o = attend_prompt(cfg, lp, q, k, v, causal=causal, window=window)
    else:
        k_buf, v_buf = cache_kv
        if seq is None or k_buf.shape[2] != cfg.n_kv_heads:
            raise ValueError(
                f"a cache of {k_buf.shape[2]} kv heads, "
                f"{'uncut' if seq is None else 'cut'} on its positions, for "
                f"a layer on whole heads: it holds every kv head "
                f"({cfg.n_kv_heads}) of a block of positions")
        if k is not None:
            put_rows(((k_buf, k), (v_buf, v)), pos, seq)
        o = attend_cache(cfg, lp, q, k_buf, v_buf, seq, causal=causal,
                         window=window, q_offset=pos,
                         kv_len=None if k is None else pos + h.shape[1])
    return out_proj(lp, o, cfg.n_heads * cfg.hd), (k, v)


def _project_kv(cfg, lp, x, q_offset):
    B, S, _ = x.shape
    Dh = cfg.hd
    k = torch.matmul(x, lp["wk"])
    v = torch.matmul(x, lp["wv"])
    if "bk" in lp:
        k, v = k + lp["bk"], v + lp["bv"]
    k = k.reshape(B, S, -1, Dh)           # this rank's kv heads
    v = v.reshape(B, S, -1, Dh)
    k = apply_rope(k, _positions(S, q_offset, x.device), cfg.rope_theta)
    return k, v


def dense_layer(cfg: ArchConfig, lp, x, window, *, cache_kv=None, pos=0,
                block_k=1024, ffn=None, seq=None):
    """One transformer block.  cache_kv=(k,v) full-length buffers for decode,
    **written in place** at ``pos``; otherwise self-attention over the
    current sequence through the flash attention kernel, which counts
    positions from 0, so ``pos`` must be 0 then (it is in every caller of
    the JAX package: forward, prefill, the hybrid's shared block).
    ``ffn(lp, h)`` overrides the feed-forward.

    In a pass that cuts the sequence over ``model``
    (``parallel.hints.split_sequence``) ``x`` is this rank's block: the
    ``"block_in"`` hints gather each block input whole, so attention runs
    over the whole sequence of its rows (positions and masks unchanged,
    the K/V whole), and each residual add takes this rank's block of what
    was computed whole.  ``ffn`` may return the block itself (the
    expert-parallel MoE layer's reduce-scatter lands there).

    With weights cut over ``model`` (:func:`heads_cut`: this rank's
    ``H/n`` query and ``Hkv/n`` kv heads, ``wo``'s rows of them, the FFN
    cut on F) the layer attends over its own heads -- the GQA group is
    the same in every rank -- and ends ``wo`` and the FFN with
    ``hints.row_parallel_end``: the sum over ``model``, reduce-scattered
    into this rank's block under a sequence cut, all-reduced otherwise.
    A cache then holds this rank's kv heads (``cache_specs``' head cut).

    With weights cut off head boundaries (:func:`heads_split`: 3.5 heads
    a rank), or a cache cut on its positions (``seq``, the pass's
    ``hints.SequenceCut``), the attention runs on whole heads (the
    section above :func:`whole_heads`): q, k and v gathered whole, the
    prompt attended on the heads this rank's channels touch, a cache on
    every head -- with ``seq`` a partial softmax over this rank's
    positions merged over the cut's ranks, the new rows written by the
    rank whose block holds them -- and this rank's channels times its
    ``wo`` rows, summed over ``model`` in float32.  Without ``seq`` the
    returned and cached K/V are every kv head's (whole weights: as
    before).

    In a pass that cuts the residual's channels (the hybrid's shared
    block; ``hints.whole_channels``) ``x`` is this rank's channels: each
    norm's input is gathered whole on them, and each residual add takes
    this rank's channels (the row-parallel ends reduce-scatter on them).

    A write that would run past the end of the buffer is clamped so that it
    fits (for one token: the last row is overwritten) while RoPE and the
    masks go on with the unclamped ``pos`` -- what the JAX package's
    ``dynamic_update_slice`` does."""
    if cache_kv is None and int(pos) != 0:
        raise ValueError(f"a layer without a cache attends over the "
                         f"sequence from position 0, got pos={pos}")
    with MODEL_SPANS.span("attention"):
        x, new_kv = _attention(cfg, lp, x, window, cache_kv, pos, block_k,
                               seq)
    with MODEL_SPANS.span("ffn"):
        h = hint(rms_norm(whole_channels(x), lp["ln2"], cfg.norm_eps),
                 "block_in")
        if ffn is None:
            delta = parallel_swiglu(h, lp["w_gate"], lp["w_up"],
                                    lp["w_down"], cfg.d_ff)
        else:
            delta = residual_block(ffn(lp, h))
        x = x + delta
    return x, new_kv


def _attention(cfg: ArchConfig, lp, x, window, cache_kv, pos, block_k, seq):
    """:func:`dense_layer`'s attention, from its norm through the residual
    add: ``(x, the layer's K/V)``."""
    h = hint(rms_norm(whole_channels(x), lp["ln1"], cfg.norm_eps),
             "block_in")
    tp = heads_cut(cfg, lp)
    ha = column_in(h) if tp else h
    if on_whole_heads(cfg, lp, seq):
        with MODEL_SPANS.span("attention.core"):
            attn, new_kv = whole_heads_attention(
                cfg, lp, ha, ha, window=window, cache_kv=cache_kv, pos=pos,
                seq=seq)
    elif cache_kv is None:
        k, v = _project_kv(cfg, lp, ha, 0)
        with MODEL_SPANS.span("attention.core"):
            attn = _attn_prompt(cfg, lp, ha, k, v, window)
        new_kv = (k, v)
    else:
        k_new, v_new = _project_kv(cfg, lp, ha, pos)
        k_buf, v_buf = cache_kv
        if k_buf.shape[2] != k_new.shape[2]:
            raise ValueError(
                f"a cache of {k_buf.shape[2]} kv heads for a layer of "
                f"{k_new.shape[2]}: a tensor-parallel layer's cache holds "
                f"its rank's kv heads, or every kv head of its block of "
                f"positions where the policy's '__cache__' cuts them")
        S = x.shape[1]
        at = min(max(int(pos), 0), k_buf.shape[1] - S)
        k_buf[:, at:at + S] = k_new.to(k_buf.dtype)
        v_buf[:, at:at + S] = v_new.to(v_buf.dtype)
        with MODEL_SPANS.span("attention.core"):
            attn = _attn(cfg, lp, ha, k_full=k_buf, v_full=v_buf,
                         window=window, q_offset=pos, kv_len=pos + S,
                         block_k=block_k)
        new_kv = (k_buf, v_buf)
    # a float32 sum of the whole-heads path's partials is rounded once
    x = x + (row_parallel_end(attn) if tp else residual_block(attn)).to(
        x.dtype)
    return x, new_kv


def _head(params: Params) -> Tensor:
    """The ``lm_head`` (or the tied embedding) as this rank's ``model``
    block of it (``hints.model_block``)."""
    name = "lm_head" if "lm_head" in params else "embed"
    return model_block(params[name], name)


def logits_fn(cfg: ArchConfig, params: Params, h: Tensor) -> Tensor:
    """The whole vocabulary's logits of ``h``: with an ``lm_head`` (or a
    tied embedding) cut on the vocabulary over ``model``, this rank's
    ``V/n`` columns all-gathered in rank order (``h`` the same in every
    rank of the group)."""
    w = _head(params)
    logits = torch.matmul(h, w.to(h.dtype).T)
    if w.shape[0] == cfg.vocab:
        return logits
    from ..parallel.collectives import all_gather_dim
    return all_gather_dim(logits, logits.dim() - 1, model_axis()[0])


# ---------------------------------------------------------------------------
# Whole-sequence passes: forward and prefill
# ---------------------------------------------------------------------------


def _layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s leaves as this rank's ``model`` blocks
    (``hints.layer_blocks``); a stack whose layer dim is cut over the
    data axes must have been gathered whole (``hints.whole_layers``)."""
    return layer_blocks({name: w[i] for name, w in params["layers"].items()})


class _Embed(torch.autograd.Function):
    """The bfloat16 rows of ``table`` at ``tokens``; the gradient of the
    table sums each row's contributions in float32, in a fixed order
    (``index_put_`` with ``accumulate``), and is cast to the table's dtype
    once: a bfloat16 sum, add by add, over a token that repeats hundreds
    of times in a batch loses several per cent of that row, in an order
    that changes with the layout of the batch over ranks."""

    @staticmethod
    def forward(ctx, table, tokens, lo):
        ctx.table = (table.shape, table.dtype)
        if lo is None:
            ctx.save_for_backward(tokens)
            return table.to(torch.bfloat16)[tokens]
        # a block of the vocabulary from row ``lo``: its rows, zeros for
        # the tokens outside it
        local = tokens.long() - lo
        valid = (local >= 0) & (local < table.shape[0])
        local = torch.where(valid, local, 0)
        ctx.save_for_backward(local, valid)
        return table.to(torch.bfloat16)[local].masked_fill(
            ~valid[..., None], 0)

    @staticmethod
    def backward(ctx, ct):
        shape, dtype = ctx.table
        if len(ctx.saved_tensors) == 2:
            tokens, valid = ctx.saved_tensors
            ct = ct.masked_fill(~valid[..., None], 0)
        else:
            (tokens,) = ctx.saved_tensors
        grad = torch.zeros(shape, dtype=torch.float32, device=ct.device)
        grad.index_put_((tokens.reshape(-1).long(),),
                        ct.reshape(-1, shape[-1]).float(), accumulate=True)
        return grad.to(dtype), None, None


def embed_tokens(params: Params, tokens: Tensor, vocab=None) -> Tensor:
    """The bfloat16 residual stream's first value: the embedding rows of
    ``tokens``, whatever the parameters' dtype (see :class:`_Embed` for
    its gradient).  With a table of fewer than ``vocab`` rows -- cut on
    the vocabulary over ``model`` -- each rank gives the rows of its
    range and zeros elsewhere, summed over ``model`` by
    ``hints.row_parallel_end``: under a sequence cut this rank's block of
    the sequence, otherwise the whole."""
    table = model_block(params["embed"], "embed")
    if vocab is None or table.shape[0] == vocab:
        return _Embed.apply(table, tokens, None)
    return row_parallel_end(_Embed.apply(
        table, tokens, model_axis()[2] * table.shape[0]))


def forward(cfg: ArchConfig, params: Params, tokens: Tensor, ffn=None
            ) -> Tensor:
    """tokens (B, S) -> final hidden states (B, S, D), bfloat16 residual
    stream; every layer attends over the sequence through the flash
    attention kernel.  ``ffn(lp, h)`` overrides every layer's feed-forward.

    Gradients flow when they are being recorded: through ``ops.mha``'s
    autograd function, each layer recomputed in the backward (``remat``,
    the JAX package's ``jax.checkpoint``), the stacked weights split once
    (``unstack``) outside the recomputed bodies.

    Under a policy whose ``"residual"`` cuts the sequence over ``model``
    (``parallel/hints.py``) the residual stream is this rank's block
    ``(B, S/n, D)`` from the embedding on, and so are the hidden states
    returned."""
    with split_sequence(tokens.shape[1]):
        x = hint(embed_tokens(params, tokens, cfg.vocab), "residual")
        windows = layer_windows(cfg)

        def block(lp, x, window):
            return dense_layer(cfg, layer_blocks(lp), x, window, ffn=ffn)[0]

        layers = whole_layers(params["layers"])
        for i, lp in enumerate(unstack(layers, cfg.n_layers)):
            x = hint(remat(block, lp, x, int(windows[i])), "residual")
        return rms_norm(x, model_block(params["ln_f"], "ln_f"), cfg.norm_eps)


def _xent(hc: Tensor, lc: Tensor, w: Tensor, lo=None, group=None
          ) -> Tensor:
    """Per-token cross-entropy of one chunk: ``logsumexp - gold logit`` in
    float32; the gold logit by a gather (exact, as the JAX package's
    one-hot sum is).  With ``group``, ``w`` is this rank's block of the
    vocabulary from row ``lo`` (vocabulary-parallel): the max and the sum
    of exponentials are taken over the group, and the gold logit comes
    from the rank that holds it."""
    logits = hint(torch.matmul(hc.float(), w.T), "logits")
    if group is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
        return lse - gold
    from ..parallel.collectives import all_reduce_max, all_reduce_sum
    m = all_reduce_max(logits.amax(-1), group)
    lse = m + torch.log(all_reduce_sum(
        torch.exp(logits - m[..., None]).sum(-1), group))
    local = lc.long() - lo
    valid = (local >= 0) & (local < w.shape[0])
    gold = torch.gather(logits, -1, torch.where(valid, local, 0)[..., None])
    gold = all_reduce_sum(gold[..., 0].masked_fill(~valid, 0.0), group)
    return lse - gold


def chunked_xent(cfg: ArchConfig, params: Params, h: Tensor, labels: Tensor,
                 chunk: int = 512) -> Tensor:
    """Mean cross-entropy of ``h (B, S, D)`` against ``labels (B, S)``
    without the ``(B, S, V)`` logits at once: ``max(1, S // chunk)``
    chunks along S against the float32 ``lm_head`` (or the tied
    embedding), each chunk's logits recomputed in the backward.

    In a pass that spreads the tokens over the mesh (``lm_loss`` under a
    policy with a ``"__mesh__"``), ``h`` is this rank's share: the labels'
    block is taken to match, and the loss is the mean over every rank.
    With an ``lm_head`` cut on the vocabulary over ``model`` the loss is
    vocabulary-parallel: ``h`` is gathered whole (``hints.column_in``),
    each rank takes its ``V/n`` logits of every token of its data row,
    the ``(B, S, V)`` logits are never gathered, and the loss, the same
    in every rank of a ``model`` group, is the mean over ``data``."""
    split = current_split()
    w = _head(params).float()
    cut = () if w.shape[0] == cfg.vocab else None
    if cut is None:
        group, _, m = model_axis()
        cut = (m * w.shape[0], group)
        h = column_in(h)
    elif split is not None:
        labels = split.block(labels, 1)
    B, S, D = h.shape
    nchunks = max(1, S // chunk)
    hs = h.reshape(B, nchunks, S // nchunks, D)
    ls = labels.reshape(B, nchunks, S // nchunks)
    losses = [remat(_xent, hs[:, c], ls[:, c], w, *cut)
              for c in range(nchunks)]
    loss = torch.stack(losses).mean()
    if split is None:
        return loss
    return split.row_mean(loss) if cut else split.mean(loss)


def spread_grads(params: Params, split) -> Params:
    """``params`` whose gradients are summed, in the backward, over the
    ranks that share each leaf: over each group the pass's tokens are
    spread over (each rank saw only its share of them; under a channel
    cut, its share of the channels: the norm gains that read a gathered
    input take a partial gradient in each rank) whose axis does not cut
    the leaf (``hints.cut_axes``: the policy's declared ``"__params__"``;
    every leaf whole where nothing is declared).  A leaf cut over
    ``model`` -- tensor parallelism, or the expert-parallel MoE layer's
    experts -- saw every token of its data row and is summed over
    ``data`` alone; a leaf cut over the data axes (ZeRO-3) is summed by
    its gather's backward (``hints.layer_blocks``), over ``model`` too
    where it is whole there.  Without a split: ``params`` itself."""
    if split is None:
        return params
    from ..parallel.collectives import summed_grads

    token = [(a, g) for a, g, k in (("model", split.model, split.n),
                                    ("data", split.data, split.n_data))
             if k > 1]

    def wrap(tree, prefix):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                out[k] = wrap(v, path)
                continue
            cut = cut_axes(path)
            groups = () if cut - {"model"} else tuple(
                g for a, g in token if a not in cut)
            out[k] = summed_grads(v, groups)
        return out

    return wrap(params, "")


@contextmanager
def loss_params(params: Params, split):
    """The parameters a loss pass reads: :func:`spread_grads`, and a tied
    embedding (no ``lm_head``: the embedding and the head) that the
    declared ``"__params__"`` cuts over the data axes gathered once for
    the pass (``hints.gathered_once``)."""
    params = spread_grads(params, split)
    with gathered_once(params, () if "lm_head" in params else ("embed",)
                       ) as params:
        yield params


def grad_norm(grads: Params) -> Tensor:
    """The global norm of the gradients over every rank: the squares of
    each leaf's block summed over every axis that cuts it
    (``hints.cut_axes``: the policy's declared ``"__params__"``), every
    whole leaf counted once.  Where the policy declares the optimizer
    state's cut (``"__opt__"``) the blocks are the state's
    (``hints.state_layout``), whatever the weights' cut: the same sums in
    the same groups whether the weights are cut over the data axes
    (ZeRO-3) or whole there (ZeRO-1), so the two give the same bits.
    Without a mesh, or with every leaf whole:
    ``optim.adamw.global_norm``."""
    import torch.distributed as dist

    from ..optim.adamw import global_norm
    from ..parallel.hints import state_layout

    entry = "__params__" if policy_value("__opt__") is None else "__opt__"
    state = state_layout(grads)

    def pairs(tree, cuts, prefix):
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            cut = None if cuts is None else cuts[k]
            if isinstance(v, dict):
                yield from pairs(v, cut, path)
            else:
                yield (v if cut is None else cut.take(v)), cut_axes(path,
                                                                   entry)

    leaves, cuts = zip(*pairs(grads, state, ""))
    mesh = policy_value("__mesh__")
    if mesh is None or not any(cuts):
        return global_norm(grads)
    total = sum(torch.sum(torch.square(g.float()))
                for g, c in zip(leaves, cuts) if not c)
    names = tuple(mesh.mesh_dim_names)
    for key in sorted({c for c in cuts if c},
                      key=lambda c: sorted(names.index(a) for a in c)):
        sq = sum(torch.sum(torch.square(g.float()))
                 for g, c in zip(leaves, cuts) if c == key)
        for a in sorted(key, key=names.index, reverse=True):
            dist.all_reduce(sq, group=mesh.get_group(a))
        total = total + sq
    return torch.sqrt(total)


def lm_loss(cfg: ArchConfig, params: Params, batch: Dict[str, Tensor]
            ) -> Tensor:
    """``forward``, then :func:`chunked_xent`.  Under a policy with a
    ``"__mesh__"`` the batch is this rank's rows, the loss is the mean
    over every rank, and the gradients come back summed where ranks share
    a leaf (:func:`spread_grads`): what ``jax.grad`` gives under the JAX
    package's mesh."""
    with split_sequence(batch["tokens"].shape[1]) as split:
        with loss_params(params, split) as params:
            h = forward(cfg, params, batch["tokens"])
            return chunked_xent(cfg, params, h, batch["labels"])


# ---------------------------------------------------------------------------
# Serving: single-token decode with a fixed-capacity KV cache
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: Tensor   # (L, B, Smax, Hkv, Dh)
    v: Tensor
    pos: int    # number of decode calls so far, ONE count for all slots


def kv_layout(cfg: ArchConfig, wk, field: str = "k", path: str = "layers/wk"):
    """How a rank holds the KV cache of layers whose ``wk`` (the leaf
    ``path``) is its block:
    ``(kv heads, hints.SequenceCut or None)``.  The policy's
    ``"__cache__"`` declares it (``hints.cache_cut``): every kv head of a
    block of positions, or this rank's kv heads.  Without it, the kv
    heads of a ``wk`` cut on a head boundary (every kv head of a whole
    one); a cut that splits a kv head needs the cache cut on its
    positions, declared."""
    declared = cache_cut(field)
    blk = model_shape(wk, path)[-1]
    if blk % cfg.hd and (declared is None or declared[0] is None):
        raise ValueError(
            f"a wk of {blk} columns splits a kv head of {cfg.hd}: its cache "
            f"is cut on its positions, which the policy's '__cache__' "
            f"declares (cache_specs)")
    if declared is None:
        return blk // cfg.hd, None
    seq, head_blocks = declared
    return cfg.n_kv_heads // head_blocks, seq


def cache_block(cfg: ArchConfig, max_len: int, kv_heads=None,
                field: str = "k", rows: int = 2):
    """``(positions, kv heads)`` of a rank's block of a KV cache
    ``max_len`` long (or of a ring of ``max_len`` slots, whose field's
    slots are dim ``rows``): what the policy's ``"__cache__"`` declares
    (its block of positions, or its kv heads), ``kv_heads`` where given,
    and otherwise the whole cache."""
    declared = cache_cut(field, rows)
    if declared is None:
        return max_len, kv_heads or cfg.n_kv_heads
    seq, head_blocks = declared
    lo, hi = (0, max_len) if seq is None else seq.span(max_len)
    return hi - lo, kv_heads or cfg.n_kv_heads // head_blocks


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda", kv_heads=None) -> KVCache:
    """Zeros: this rank's block of the cache (:func:`cache_block`): under
    a policy whose ``"__cache__"`` cuts its positions ``max_len / n`` rows
    of every kv head, or its kv heads; ``kv_heads`` of them a layer where
    given; otherwise the whole cache."""
    device = resolve_device(device)
    rows, heads = cache_block(cfg, max_len, kv_heads)
    shape = (cfg.n_layers, batch, rows, heads, cfg.hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


@torch.no_grad()
def prefill(cfg: ArchConfig, params: Params, tokens: Tensor, max_len: int,
            ffn=None, residual_hint: bool = True) -> Tuple[Tensor, KVCache]:
    """tokens (B, S) -> logits of the last position (B, V) and the cache
    that decoding goes on from: ``max_len`` long, the prompt's K/V in its
    first ``S`` rows, zeros past them, ``pos = S``.  Each layer attends over
    the prompt through the flash attention kernel (one launch a layer);
    ``ffn`` as in :func:`forward`; ``residual_hint`` hints each layer's
    output ``"residual"``, as the JAX package's dense prefill does (its
    MoE prefill does not).

    Under a policy whose ``"residual"`` cuts the sequence the residual
    stream is this rank's block from the embedding on; the cache is the
    whole sequence's (its K/V come from the gathered block inputs), and
    the logits, computed by the rank of the last block, are broadcast to
    every rank of the ``model`` group.  With weights cut over ``model``
    the cache holds this rank's kv heads (:func:`kv_layout`; a cut that
    splits a kv head needs the declared cut on the positions below), and
    the last position's hidden state is broadcast instead, for every
    rank's block of the vocabulary (the logits gathered whole,
    :func:`logits_fn`).  Where the policy's
    ``"__cache__"`` cuts the positions, the cache is this rank's block of
    ``max_len / n`` positions of every kv head, which holds the prompt's
    rows that fall in it."""
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"a prompt of {S} tokens does not fit a cache of "
                         f"max_len {max_len}")
    with split_sequence(S) as split:
        with MODEL_SPANS.span("embed"):
            x = residual_block(embed_tokens(params, tokens, cfg.vocab))
        windows = layer_windows(cfg)
        kv_heads, seq = kv_layout(cfg, params["layers"]["wk"])
        params = {**params, "layers": whole_layers(params["layers"])}
        cache = init_cache(cfg, B, max_len, device=x.device,
                           kv_heads=kv_heads)
        for i in range(cfg.n_layers):
            x, (k, v) = dense_layer(cfg, _layer_params(params, i), x,
                                    int(windows[i]), ffn=ffn, seq=seq)
            if residual_hint:
                x = hint(x, "residual")
            with MODEL_SPANS.span("cache.store"):
                store_prompt(cache.k[i], k, seq)
                store_prompt(cache.v[i], v, seq)
        with MODEL_SPANS.span("head"):
            h = rms_norm(x, model_block(params["ln_f"], "ln_f"),
                         cfg.norm_eps)
            logits = last_logits(cfg, params, h, split)
    return logits, KVCache(cache.k, cache.v, S)


def last_logits(cfg: ArchConfig, params: Params, h: Tensor, split
                ) -> Tensor:
    """The last position's logits (B, V) of a prefill's final hidden
    states ``h``, in every rank of a ``model`` group: under a sequence
    cut ``h`` is this rank's block, and the rank of the last block
    broadcasts its logits -- or, with a head cut on the vocabulary, its
    last hidden state, for every rank's block of the vocabulary (the
    logits gathered whole, :func:`logits_fn`)."""
    name = "lm_head" if "lm_head" in params else "embed"
    if model_shape(params[name], name)[0] == cfg.vocab:
        logits = logits_fn(cfg, params, h[:, -1:])[:, 0]
        return logits if split is None else split.last_block(logits)
    last = h[:, -1:]
    return logits_fn(cfg, params, last if split is None
                     else split.last_block(last))[:, 0]


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
    Under a policy with a ``"__mesh__"`` the step declares its one token a
    row (uncut), so that a layer reads the mesh's ``data`` group; with
    weights cut over ``model`` the cache holds this rank's kv heads (as
    :func:`prefill` laid it, :func:`kv_layout`) and the logits are the
    whole vocabulary's.  Where the policy's ``"__cache__"`` cuts the
    cache's positions, each layer's attention is a partial softmax over
    this rank's block merged over the cut's ranks, and the new token's
    K/V are written by the rank whose block holds ``pos``.
    """
    with split_sequence(tokens.shape[1], cut=False):
        with MODEL_SPANS.span("embed"):
            x = embed_tokens(params, tokens, cfg.vocab)
        windows = layer_windows(cfg)
        pos = int(cache.pos)
        seq = kv_layout(cfg, params["layers"]["wk"])[1]
        params = {**params, "layers": whole_layers(params["layers"])}
        for i in range(cfg.n_layers):
            x, _ = dense_layer(cfg, _layer_params(params, i), x,
                               int(windows[i]),
                               cache_kv=(cache.k[i], cache.v[i]), pos=pos,
                               block_k=block_k, ffn=ffn, seq=seq)
        with MODEL_SPANS.span("head"):
            h = rms_norm(x, model_block(params["ln_f"], "ln_f"),
                         cfg.norm_eps)
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
    """Zeros: this rank's block of the rings and of the global layers'
    buffers where the policy's ``"__cache__"`` declares their cut
    (``parallel.sharding.ring_cache_specs``: a ring's slots, a buffer's
    positions), otherwise the whole cache."""
    device = resolve_device(device)
    G, R = grouped_layout(cfg)
    Dh = cfg.hd
    slots, ring_heads = cache_block(cfg, cfg.sliding_window,
                                    field="k_local", rows=3)
    rows, heads = cache_block(cfg, max_len, field="k_global")

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return GroupedKVCache(zeros(G, R, batch, slots, ring_heads, Dh),
                          zeros(G, R, batch, slots, ring_heads, Dh),
                          zeros(G, batch, rows, heads, Dh),
                          zeros(G, batch, rows, heads, Dh), 0)


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


def ring_positions(pos: int, slot: int, window: int, rows: int, base: int,
                   device) -> Tensor:
    """The absolute positions that ring rows ``base + [0, rows)`` hold
    once position ``pos`` is written at ``slot``: rows (slot-W, slot]
    hold positions (pos-W, pos] (the bank equation read backwards; a
    negative position was never written)."""
    row = torch.arange(rows, device=device) + base
    return pos - torch.remainder(slot - row + window, window)


def _ring_layer(cfg: ArchConfig, lp, x, kc, vc, pos: int, slot: int,
                ring=None):
    """One local layer against its ring (``kc``/``vc`` (B, W, Hkv, Dh),
    written in place at ``slot``): attention over the W rows, each masked
    by the position the bank equation gives it back.

    With weights cut over ``model``, or a ring cut on its slots (``ring``,
    a ``hints.SequenceCut``: the long layout), the layer runs on whole
    heads (the section above :func:`whole_heads`): q, k and v gathered
    over ``model``, the new row written by the rank whose block of slots
    holds ``slot``.  A whole ring (the decode layout) holds every kv
    head in every rank and is attended on the heads this rank's ``wo``
    rows touch; a cut one on every head, each rank's partial softmax over
    its slots merged over the cut's ranks.  ``wo`` and the FFN end with
    the row-parallel sum, as in :func:`dense_layer`."""
    B, S, _ = x.shape
    W = cfg.sliding_window
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    tp = heads_cut(cfg, lp)
    if not tp and ring is None:
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        k_new, v_new = _project_kv(cfg, lp, h, pos)
        at = min(slot, W - S)          # a write past the ring's end is clamped
        kc[:, at:at + S] = k_new.to(kc.dtype)
        vc[:, at:at + S] = v_new.to(vc.dtype)
        q = _project_q(cfg, lp, h, pos)
        k_pos = ring_positions(pos, slot, W, W, 0, x.device)
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
    if kc.shape[2] != Hkv:
        raise ValueError(f"a ring of {kc.shape[2]} kv heads for a layer on "
                         f"whole heads: it holds every kv head ({Hkv}), as "
                         f"ring_cache_specs lays it")
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    ha = column_in(h) if tp else h
    q = whole_heads(cfg, lp, ha, "wq", pos)
    put_rows(((kc, whole_heads(cfg, lp, ha, "wk", pos)),
              (vc, whole_heads(cfg, lp, ha, "wv"))), slot, ring)
    rows = kc.shape[1]
    k_pos = ring_positions(pos, slot, W, rows,
                           ring.index * rows if ring else 0, x.device)
    (lo, hi), (h0, h1) = out_span(cfg, lp)
    if ring is None:
        # every kv head in this rank: the query heads its channels touch
        kv_of = torch.arange(h0, h1, device=x.device) // (H // Hkv)
        parts = attention_partials(q[:, :, h0:h1], kc[:, :, kv_of],
                                   vc[:, :, kv_of], window=W, q_offset=pos,
                                   k_pos=k_pos)
        o = merge_partials(*parts, lambda t: t, lambda t: t)
        o = o.to(q.dtype).reshape(B, S, -1)[..., lo - h0 * Dh:hi - h0 * Dh]
    else:
        o = merge_partials(*attention_partials(
            q, kc, vc, window=W, q_offset=pos, k_pos=k_pos), ring.amax,
            ring.total)
        o = o.to(q.dtype).reshape(B, S, -1)[..., lo:hi]
    attn = out_proj(lp, o, H * Dh)
    x = x + (row_parallel_end(attn) if tp else attn).to(x.dtype)
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + parallel_swiglu(h2, lp["w_gate"], lp["w_up"], lp["w_down"],
                               cfg.d_ff)


@torch.no_grad()
def grouped_decode_step(cfg: ArchConfig, params: Params,
                        cache: GroupedKVCache, tokens: Tensor,
                        block_k: int = 1024) -> Tuple[Tensor, GroupedKVCache]:
    """One decode step with ring-buffered local layers: tokens (B, 1) ->
    logits (B, V), the cache's buffers **updated in place** (the returned
    cache shares them and carries ``pos + 1``).  The global layer of each
    group is ``dense_layer`` against its full-length buffers.

    It runs as :func:`decode_step` runs: one uncut token, each layer's
    leaves gathered over the data axes where ``"__params__"`` declares
    them cut (ZeRO-3), the whole vocabulary's logits.  With weights cut
    over ``model`` the policy's ``"__cache__"`` declares the cache's
    layout (``parallel.sharding.ring_cache_specs``): each global layer
    attends its buffers cut on their positions (a partial softmax merged
    over the cut's ranks), each local layer its ring, whole in every rank
    (a batch of several rows) or cut on its slots over ``model`` (one row;
    :func:`_ring_layer`)."""
    G, R = grouped_layout(cfg)
    with split_sequence(tokens.shape[1], cut=False):
        x = embed_tokens(params, tokens, cfg.vocab)
        pos = int(cache.pos)
        slot = ring_slot(pos, cfg.sliding_window)
        ring = cache_cut("k_local", 3)
        ring = None if ring is None else ring[0]
        seq = kv_layout(cfg, params["layers"]["wk"], "k_global")[1]
        local_p, global_p = _grouped_params(
            cfg, {"layers": whole_layers(params["layers"])})
        for g in range(G):
            for r in range(R):
                x = _ring_layer(
                    cfg, layer_blocks({k: v[g, r] for k, v in local_p.items()}),
                    x, cache.k_local[g, r], cache.v_local[g, r], pos, slot,
                    ring)
            x, _ = dense_layer(
                cfg, layer_blocks({k: v[g] for k, v in global_p.items()}), x,
                0, cache_kv=(cache.k_global[g], cache.v_global[g]), pos=pos,
                block_k=block_k, seq=seq)
        h = rms_norm(x, model_block(params["ln_f"], "ln_f"), cfg.norm_eps)
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
    """Zeros: this rank's block where the policy's ``"__cache__"``
    declares the cut (``parallel.sharding.quant_cache_specs``: the
    positions, or the kv heads), otherwise the whole cache."""
    device = resolve_device(device)
    rows, heads = cache_block(cfg, max_len, field="k_q")
    shape = (cfg.n_layers, batch, rows, heads, cfg.hd)
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


def _dequant(q: Tensor, s: Tensor) -> Tensor:
    """bfloat16 rows of int8 ``q`` times their scales ``s``."""
    return q.to(torch.bfloat16) * s[..., None].to(torch.bfloat16)


@torch.no_grad()
def decode_step_quant(cfg: ArchConfig, params: Params, cache: QuantKVCache,
                      tokens: Tensor, block_k: int = 1024
                      ) -> Tuple[Tensor, QuantKVCache]:
    """``decode_step`` against an int8 cache: new rows quantized on write
    (in place, at ``pos``, clamped as ``dense_layer`` clamps), the layer's
    buffer dequantized to bfloat16 on read.

    It runs as :func:`decode_step` runs: one uncut token, each layer's
    leaves gathered over the data axes where ``"__params__"`` declares
    them cut, the whole vocabulary's logits.  With weights cut over
    ``model`` the policy's ``"__cache__"`` declares the cache's layout
    (``parallel.sharding.quant_cache_specs``): this rank's kv heads, each
    rank quantizing its own (a scale is per token and head), or every kv
    head of a block of positions -- the new row quantized and written by
    the rank that holds it, the attention a partial softmax merged over
    the cut's ranks.  A rank dequantizes its block alone."""
    with split_sequence(tokens.shape[1], cut=False):
        x = embed_tokens(params, tokens, cfg.vocab)
        windows = layer_windows(cfg)
        pos = int(cache.pos)
        S = x.shape[1]
        seq = kv_layout(cfg, params["layers"]["wk"], "k_q")[1]
        params = {**params, "layers": whole_layers(params["layers"])}
        for i in range(cfg.n_layers):
            lp = _layer_params(params, i)
            bufs = (cache.k_q[i], cache.k_s[i], cache.v_q[i], cache.v_s[i])
            h = hint(rms_norm(x, lp["ln1"], cfg.norm_eps), "block_in")
            tp = heads_cut(cfg, lp)
            ha = column_in(h) if tp else h
            if on_whole_heads(cfg, lp, seq):
                if seq is None:
                    raise ValueError(
                        "a layer cut off head boundaries attends an int8 "
                        "cache cut on its positions, which the policy's "
                        "'__cache__' declares (quant_cache_specs)")
                k_new = whole_heads(cfg, lp, ha, "wk", pos)
                v_new = whole_heads(cfg, lp, ha, "wv")
            else:
                k_new, v_new = _project_kv(cfg, lp, ha, pos)
                if bufs[0].shape[2] != k_new.shape[2]:
                    raise ValueError(
                        f"an int8 cache of {bufs[0].shape[2]} kv heads for a "
                        f"layer of {k_new.shape[2]}: the policy's '__cache__' "
                        f"declares a cut cache (quant_cache_specs)")
            put_rows(tuple(zip(bufs, _quant_rows(k_new) + _quant_rows(v_new))),
                     pos, seq)
            k_deq, v_deq = _dequant(*bufs[:2]), _dequant(*bufs[2:])
            window = int(windows[i])
            if seq is not None:
                attn = out_proj(lp, attend_cache(
                    cfg, lp, whole_heads(cfg, lp, ha, "wq", pos), k_deq,
                    v_deq, seq, window=window, q_offset=pos, kv_len=pos + S),
                    cfg.n_heads * cfg.hd)
            else:
                attn = _attn(cfg, lp, ha, k_full=k_deq, v_full=v_deq,
                             window=window, q_offset=pos, kv_len=pos + S,
                             block_k=block_k)
            x = x + (row_parallel_end(attn) if tp else attn).to(x.dtype)
            h = hint(rms_norm(x, lp["ln2"], cfg.norm_eps), "block_in")
            x = x + parallel_swiglu(h, lp["w_gate"], lp["w_up"],
                                    lp["w_down"], cfg.d_ff)
        h = rms_norm(x, model_block(params["ln_f"], "ln_f"), cfg.norm_eps)
        logits = logits_fn(cfg, params, h)[:, 0]
    return logits, cache._replace(pos=pos + 1)
