"""Mamba2 (state-space duality / SSD) language model: prefill and decode.

The chunked SSD algorithm (Dao & Gu, arXiv:2405.21060): within a chunk of
length Q the recurrence is computed in matrix form, one launch of the
``ssd_chunk`` kernel (``kernels/ssd_chunk.py``) per chunk on the card and
its plain torch version on the CPU; across chunks a Python loop carries the
``(B, H, P, N)`` state, where the JAX package runs ``lax.scan`` over its
einsum form of the same chunk.  Single-token decode runs the O(1)
recurrence and never reaches the kernel.

Layer parameters are stacked on a leading ``L`` axis, as in the JAX package,
so weights map one to one; ``A_log``, ``D_skip`` and ``dt_bias`` are float32
whatever the model's dtype.  ``forward`` and ``lm_loss`` carry gradients
(through the kernel's autograd function); prefill and decode do not.

Tensor parallelism: a rank holds exactly the blocks that ``param_specs``
gives it (``parallel.sharding.rank_blocks``).  Those of ``in_proj`` (its
``2 d_inner + 2N + H`` output columns), ``conv_w`` and ``conv_b`` (the
``d_inner + 2N`` conv channels) are contiguous and do not fall on heads;
those of ``A_log``, ``D_skip``, ``dt_bias``, ``gate_ln`` and
``out_proj`` are whole heads.  The block bridges the two with two
activation gathers over ``model``: ``h @ in_proj`` is gathered whole, and
the rank takes its heads' ``z``, ``x`` and ``dt`` and the whole ``B`` and
``C`` (shared by every head); the causal conv runs on the rank's block of
the conv channels, with its own conv tail (``cache_specs``' ``conv``
block), and its output is gathered and sliced the same way.  The SSD scan
(B6) runs on the rank's ``H/n`` heads, the gated norm's mean of squares
is summed over ``model`` in float32, and ``out_proj`` ends with the
row-parallel sum of its float32 partial sums, rounded once.  Under the
train and prefill policies the residual is cut on its channels
(``parallel/hints.py``): each block gathers its input's channels before
its norm.  Where the policy's ``"__params__"`` declares the weights cut
over the data axes too (ZeRO-3), every pass gathers each block's leaves
into their ``model`` blocks inside the block's recomputed body, and the
whole-model leaves where they are used (``parallel.hints.layer_blocks``,
``whole_layers``, ``model_block``), as ``models/transformer.py`` does.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..core.tracing import MODEL_SPANS
from ..device import resolve_device
from ..kernels.ssd_chunk import SsdChunkFn, ssd_chunk
from ..parallel.collectives import (all_gather_dim, all_reduce_sum,
                                    summed_grads)
from ..parallel.hints import (column_in, hint, layer_blocks, model_axis,
                              model_block, model_shape, residual_block,
                              row_parallel_end, split_sequence,
                              whole_channels, whole_layers)
from . import transformer as tfm
from .layers import dense_init, param_device, remat, rms_norm, unstack

Tensor = torch.Tensor
Params = Dict[str, Any]


def dims(cfg: ArchConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    H = d_inner // P
    N = cfg.ssm_state
    return d_inner, H, P, N


def init_ssm_layers(cfg: ArchConfig, generator: torch.Generator,
                    lead: Sequence[int], dtype=torch.bfloat16,
                    device="cuda", keep=None, prefix="layers") -> Params:
    """Random Mamba2 block parameters stacked on the leading axes ``lead``
    (``(L,)`` here, ``(G, per)`` in the hybrid), one layer's float32 draw
    at a time from ``generator`` (on ``device``): the JAX package's
    ``init_ssm_layer`` tree and shapes, other numbers.  ``keep(path,
    leaf)``, where given, replaces each leaf (path ``prefix/name``) as
    soon as it is drawn, as in ``transformer.init_dense_params``."""
    device = param_device(generator, device)
    lead = tuple(lead)
    D, W = cfg.d_model, cfg.ssm_conv
    d_inner, H, P, N = dims(cfg)
    conv_dim = d_inner + 2 * N          # the conv runs over [x, B, C]

    def stack(shape, scale=None):
        out = torch.empty(lead + shape, dtype=dtype, device=device)
        flat = out.view((-1,) + shape)
        for i in range(flat.shape[0]):
            flat[i] = dense_init(generator, shape, scale=scale, dtype=dtype,
                                 device=device)
        return out

    def full(shape, value, dt):
        return torch.full(lead + shape, value, dtype=dt, device=device)

    def leaf(name, t):
        return t if keep is None else keep(f"{prefix}/{name}", t)

    a_log = torch.log(torch.linspace(1.0, 16.0, H, device=device))
    return {
        "ln": leaf("ln", full((D,), 0.0, dtype)),
        "in_proj": leaf("in_proj", stack((D, 2 * d_inner + 2 * N + H))),
        "conv_w": leaf("conv_w", stack((W, conv_dim), scale=0.2)),
        "conv_b": leaf("conv_b", full((conv_dim,), 0.0, dtype)),
        "A_log": leaf("A_log", a_log.expand(lead + (H,)).contiguous()),
        "D_skip": leaf("D_skip", full((H,), 1.0, torch.float32)),
        "dt_bias": leaf("dt_bias", full((H,), 0.0, torch.float32)),
        "gate_ln": leaf("gate_ln", full((d_inner,), 0.0, dtype)),
        "out_proj": leaf("out_proj", stack((d_inner, D))),
    }


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cuda", keep=None) -> Params:
    """Random parameters from ``generator`` (which must live on ``device``),
    the JAX package's tree: ``embed``, ``ln_f`` and the blocks stacked on
    ``L``.  ``keep(path, leaf)``, where given, replaces each leaf as soon
    as it is drawn (``convert.block_init``: a rank's block of it), the
    draws unchanged."""
    layers = init_ssm_layers(cfg, generator, (cfg.n_layers,), dtype, device,
                             keep=keep)
    device = resolve_device(device)

    def leaf(path, t):
        return t if keep is None else keep(path, t)

    return {
        "embed": leaf("embed", dense_init(generator, (cfg.vocab, cfg.d_model),
                                          scale=0.02, dtype=dtype,
                                          device=device)),
        "ln_f": leaf("ln_f", torch.zeros((cfg.d_model,), dtype=dtype,
                                         device=device)),
        "layers": layers,
    }


# ---------------------------------------------------------------------------
# Chunked SSD core
# ---------------------------------------------------------------------------


class _Silu(torch.autograd.Function):
    """``jax.nn.silu`` as XLA computes it, forward and backward, each op
    rounded in ``x``'s dtype: the forward ``x * s`` with ``s = 1 / (1 +
    exp(-x))`` written out, the backward JAX's rule for ``x *
    logistic(x)``, ``ct * s + (ct * x) * (s * (1 - s))``.  In bfloat16
    both are bit for bit the JAX package's; autograd through the
    written-out sigmoid rounds elsewhere and differs in about 40 % of the
    elements."""

    @staticmethod
    def forward(ctx, x):
        s = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, ct):
        x, s = ctx.saved_tensors
        return ct * s + (ct * x) * (s * (1 - s))


def _silu(x: Tensor) -> Tensor:
    """``x * sigmoid(x)`` as ``jax.nn.silu`` (see :class:`_Silu`)."""
    return _Silu.apply(x)


def _causal_conv(x: Tensor, w: Tensor, b: Tensor, state: Tensor = None):
    """Depthwise causal conv, window ``W = w.shape[0]``.  x (B, S, C);
    w (W, C).  ``state`` (B, W-1, C) carries the tail for streaming decode;
    the new tail is returned beside the output."""
    W = w.shape[0]
    S = x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + S] * w[i] for i in range(W))
    new_state = xp[:, -(W - 1):] if W > 1 else None
    return _silu(out + b), new_state


def ssd_chunked(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
                chunk: int, init_state: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
    """SSD scan.  x (B,S,H,P), dt (B,S,H) (post-softplus), A (H,) negative,
    Bm/Cm (B,S,N).  Returns (y (B,S,H,P) float32, final state (B,H,P,N)
    float32).  Each chunk is one call of ``ssd_chunk``, on views of the
    chunk as they lie (no copy), writing its y into one buffer for the
    whole scan -- or, when gradients are being recorded for an input, one
    call of its autograd function ``SsdChunkFn``, whose chunks of y are
    joined afterwards."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        # zero-pad the tail: dt=0 rows have decay exp(0)=1 and add nothing
        # to the state; their y rows are dropped before returning.
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = (S + pad) // Q
    x, dt = x.float(), dt.float()
    Bm, Cm = Bm.float(), Cm.float()
    # running log-decay within each chunk, (B, nc, Q, H)
    cum = torch.cumsum(dt.reshape(Bsz, nc, Q, H) * A, dim=2)

    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bm, Cm, init_state)):
        # the kernel's write into a view of one buffer is invisible to
        # autograd: each chunk's y comes out of the autograd function and
        # the chunks are joined
        ys = []
        for c in range(nc):
            sl = slice(c * Q, (c + 1) * Q)
            y_c, state = SsdChunkFn.apply(
                x[:, sl].transpose(1, 2), dt[:, sl].transpose(1, 2),
                Bm[:, sl], Cm[:, sl], cum[:, c].transpose(1, 2), state)
            ys.append(y_c.transpose(1, 2))
        return torch.cat(ys, dim=1)[:, :S], state
    y = torch.empty((Bsz, nc * Q, H, P), dtype=torch.float32,
                    device=x.device)
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        _, state = ssd_chunk(x[:, sl].transpose(1, 2),
                             dt[:, sl].transpose(1, 2), Bm[:, sl], Cm[:, sl],
                             cum[:, c].transpose(1, 2), state,
                             y[:, sl].transpose(1, 2))
    return y[:, :S], state


def _scan(cfg: ArchConfig, lp, xh: Tensor, dt_raw: Tensor, Bm: Tensor,
          Cm: Tensor, ssm_state, streaming: bool):
    """The SSD mixer over the heads of ``xh (B, S, h, P)``: ``dt``, the
    recurrence (one token of a stream) or the chunked scan, and the ``D``
    skip; ``lp``'s per-head leaves hold those ``h`` heads.  Returns
    ``(y (B, S, h, P) float32, new state)``."""
    S = xh.shape[1]
    dt = F.softplus(dt_raw.float() + lp["dt_bias"])
    A = -torch.exp(lp["A_log"])
    if streaming and S == 1:
        # O(1) recurrence for single-token decode
        dA = torch.exp(dt[:, 0] * A)                       # (B, H)
        xdt = xh[:, 0] * dt[:, 0, :, None]
        s_add = torch.einsum("bn,bhp->bhpn", Bm[:, 0].float(), xdt.float())
        state = ssm_state * dA[..., None, None] + s_add
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), state)
        y = y[:, None]                                     # (B, 1, H, P)
        new_state = state
    else:
        y, new_state = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk,
                                   ssm_state)
    return y + lp["D_skip"][:, None] * xh.float(), new_state


def heads_cut(cfg: ArchConfig, lp) -> bool:
    """Whether a Mamba2 block's leaves are cut over ``model``: its
    ``out_proj`` holds the rows of fewer than every head (tensor
    parallelism); then ``in_proj`` and ``conv_w`` must be cut too."""
    d_inner = dims(cfg)[0]
    if lp["out_proj"].shape[-2] == d_inner:
        return False
    C = 2 * d_inner + 2 * cfg.ssm_state + dims(cfg)[1]
    if (lp["in_proj"].shape[-1] == C
            or lp["conv_w"].shape[-1] == d_inner + 2 * cfg.ssm_state):
        raise ValueError("a Mamba2 block cut on its heads with a whole "
                         "in_proj or conv_w: param_specs cuts all three "
                         "over 'model'")
    return True


def _rank_mixer(cfg: ArchConfig, lp, h: Tensor, conv_state, ssm_state,
                streaming: bool):
    """The block between its norm and ``out_proj`` on this rank's heads
    (module docstring): ``h (B, S, D)`` whole; returns this rank's
    ``out_proj`` partial sums (B, S, D) and its ``(conv tail, state)``."""
    Bsz, S, _ = h.shape
    d_inner, H, P, N = dims(cfg)
    group, _, m = model_axis()
    Hr = lp["A_log"].shape[-1]                 # this rank's heads
    dr = Hr * P
    cb = lp["conv_w"].shape[-1]                # its block of conv channels
    # h @ in_proj's block of columns, gathered whole over 'model'
    proj = all_gather_dim(torch.matmul(h, lp["in_proj"]), 2, group,
                          torch.float32)
    z, xin, bc, dt_raw = torch.split(proj, [d_inner, d_inner, 2 * N, H],
                                     dim=-1)
    conv_in = torch.cat([xin, bc], dim=-1)[..., m * cb:(m + 1) * cb]
    conv_out, new_conv = _causal_conv(conv_in, lp["conv_w"], lp["conv_b"],
                                      conv_state)
    conv_out = all_gather_dim(conv_out, 2, group, torch.float32)
    xin, Bm, Cm = torch.split(conv_out, [d_inner, N, N], dim=-1)
    mine = slice(m * dr, (m + 1) * dr)
    xh = xin[..., mine].reshape(Bsz, S, Hr, P)
    y, new_state = _scan(cfg, lp, xh, dt_raw[..., m * Hr:(m + 1) * Hr], Bm,
                         Cm, ssm_state, streaming)
    y = y.reshape(Bsz, S, dr).to(h.dtype)
    # the gated norm over the whole d_inner: this rank's sum of squares
    # summed over 'model' in float32; each rank uses the sum for its own
    # channels, so its gradient is summed over 'model' too
    g = y.float() * _silu(z[..., mine]).float()
    var = all_reduce_sum(summed_grads(torch.sum(g * g, dim=-1, keepdim=True),
                                      (group,)), group) / d_inner
    y = ((g * torch.rsqrt(var + cfg.norm_eps))
         * (1.0 + lp["gate_ln"].float())).to(h.dtype)
    # out_proj's partial sums stay float32 until they are summed over
    # 'model', so the block's output is rounded once, as the whole
    # product's is
    return (torch.matmul(y.float(), lp["out_proj"].float()),
            (new_conv, new_state))


def ssm_block(cfg: ArchConfig, lp, x: Tensor, *, conv_state=None,
              ssm_state=None, streaming=False):
    """One Mamba2 block.  x (B, S, D).  Streaming mode threads conv/ssm
    states (decode); otherwise states start at zero (prefill).  Returns
    ``(x, (conv tail, ssm state))``.

    Under a channel cut ``x`` is this rank's channels, gathered whole for
    the norm; the residual add takes this rank's channels.  With leaves
    cut over ``model`` (:func:`heads_cut`) the block runs on this rank's
    heads (:func:`_rank_mixer`) and its states are this rank's conv
    channels and heads."""
    Bsz, S, _ = x.shape
    d_inner, H, P, N = dims(cfg)
    if heads_cut(cfg, lp):
        h = rms_norm(whole_channels(x), lp["ln"], cfg.norm_eps)
        out, states = _rank_mixer(cfg, lp, column_in(h), conv_state,
                                  ssm_state, streaming)
        return x + row_parallel_end(out).to(x.dtype), states
    with MODEL_SPANS.span("ssm.in_proj"):
        h = rms_norm(whole_channels(x), lp["ln"], cfg.norm_eps)
        proj = torch.matmul(h, lp["in_proj"])  # (B, S, 2*d_inner + 2N + H)
        z, xin, bc, dt_raw = torch.split(proj, [d_inner, d_inner, 2 * N, H],
                                         dim=-1)
    with MODEL_SPANS.span("ssm.conv"):
        conv_in = torch.cat([xin, bc], dim=-1)
        conv_out, new_conv = _causal_conv(conv_in, lp["conv_w"],
                                          lp["conv_b"], conv_state)
        xin, Bm, Cm = torch.split(conv_out, [d_inner, N, N], dim=-1)
    with MODEL_SPANS.span("ssm.scan"):
        xh = xin.reshape(Bsz, S, H, P)
        y, new_state = _scan(cfg, lp, xh, dt_raw, Bm, Cm, ssm_state,
                             streaming)
        y = y.reshape(Bsz, S, d_inner).to(x.dtype)
    with MODEL_SPANS.span("ssm.gate_norm"):
        # the gated product goes into the norm unrounded, as XLA fuses it
        # in the JAX package; the norm's output is rounded to the working
        # dtype once
        y = rms_norm(y.float() * _silu(z).float(), lp["gate_ln"],
                     cfg.norm_eps).to(x.dtype)
    with MODEL_SPANS.span("ssm.out_proj"):
        out = torch.matmul(y, lp["out_proj"])
        x = x + residual_block(out)
    return x, (new_conv, new_state)


# ---------------------------------------------------------------------------
# LM wrappers
# ---------------------------------------------------------------------------


class SSMCache(NamedTuple):
    conv: Tensor   # (L, B, W-1, conv_dim), the model's dtype
    state: Tensor  # (L, B, H, P, N) float32
    pos: int       # tokens seen so far, ONE count for all slots


def init_cache(cfg: ArchConfig, batch: int, dtype=torch.bfloat16,
               device="cuda", heads=None, conv_channels=None) -> SSMCache:
    """Zeros; ``heads`` and ``conv_channels`` of them a layer (default:
    every head and conv channel; a tensor-parallel rank holds its own,
    ``cache_specs``' cut, :func:`rank_cache_dims`)."""
    device = resolve_device(device)
    d_inner, H, P, N = dims(cfg)
    L = cfg.n_layers
    return SSMCache(
        torch.zeros((L, batch, cfg.ssm_conv - 1,
                     conv_channels or d_inner + 2 * N),
                    dtype=dtype, device=device),
        torch.zeros((L, batch, heads or H, P, N), dtype=torch.float32,
                    device=device),
        0)


def rank_cache_dims(layers: Params, prefix: str = "layers"
                    ) -> Dict[str, int]:
    """The heads and conv channels of the states of the blocks whose
    stacked leaves are ``layers`` (the leaves ``prefix/...``): this rank's
    where they are cut over ``model`` (``hints.model_shape``: a cut over
    the data axes is gathered before a block runs)."""
    return {"heads": model_shape(layers["A_log"], prefix + "/A_log")[-1],
            "conv_channels": model_shape(layers["conv_w"],
                                         prefix + "/conv_w")[-1]}


def layer(stacked: Params, i) -> Params:
    """One block's parameters out of a stack: ``i`` indexes the leading
    axes (an int for ``(L, ...)``, a pair for the hybrid's ``(G, per,
    ...)``)."""
    return {name: w[i] for name, w in stacked.items()}


def forward(cfg: ArchConfig, params: Params, tokens: Tensor) -> Tensor:
    """tokens (B, S) -> final hidden states (B, S, D): every block runs the
    chunked scan, each recomputed in the backward when gradients are being
    recorded (so the ``ssd_chunk`` kernel runs ``ceil(S / ssm_chunk)``
    times a layer in the forward and as many again in the recompute).
    Under a policy whose ``"residual"`` cuts the channels the residual
    between blocks is this rank's channels, gathered whole for the final
    norm."""
    with split_sequence(tokens.shape[1], channels=cfg.d_model):
        x = residual_block(tfm.embed_tokens(params, tokens, cfg.vocab))

        def block(lp, x):
            return ssm_block(cfg, layer_blocks(lp), x)[0]

        layers = whole_layers(params["layers"])
        for lp in unstack(layers, cfg.n_layers):
            x = hint(remat(block, lp, x), "residual")
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
def decode_step(cfg: ArchConfig, params: Params, cache: SSMCache,
                tokens: Tensor) -> Tuple[Tensor, SSMCache]:
    """One decode step: tokens (B, 1) -> logits (B, V), updated cache.

    The cache's ``conv``/``state`` buffers are **updated in place** (the
    returned cache shares them and carries ``pos + 1``), as the dense
    family's KV cache is.  With leaves cut over ``model`` the cache holds
    this rank's conv channels and heads, and the logits are the whole
    vocabulary's; with leaves cut over the data axes too each block's are
    gathered before it runs."""
    with split_sequence(tokens.shape[1], cut=False):
        with MODEL_SPANS.span("embed"):
            x = tfm.embed_tokens(params, tokens, cfg.vocab)
        layers = whole_layers(params["layers"])
        for i in range(cfg.n_layers):
            x, (conv, state) = ssm_block(
                cfg, layer_blocks(layer(layers, i)), x,
                conv_state=cache.conv[i], ssm_state=cache.state[i],
                streaming=True)
            with MODEL_SPANS.span("cache.store"):
                cache.conv[i] = conv
                cache.state[i] = state
        with MODEL_SPANS.span("head"):
            h = rms_norm(x, model_block(params["ln_f"], "ln_f"),
                         cfg.norm_eps)
            logits = tfm.logits_fn(cfg, params, h)[:, 0]
    return logits, SSMCache(cache.conv, cache.state, int(cache.pos) + 1)


@torch.no_grad()
def prefill(cfg: ArchConfig, params: Params, tokens: Tensor
            ) -> Tuple[Tensor, SSMCache]:
    """tokens (B, S) -> logits of the last position (B, V) and the cache
    that decoding goes on from.  Every block runs the chunked scan: the
    ``ssd_chunk`` kernel ``ceil(S / ssm_chunk)`` times per layer.  Under a
    policy that cuts the residual's channels it is this rank's channels
    between blocks; with leaves cut over ``model`` the cache holds this
    rank's conv channels and heads."""
    B, S = tokens.shape
    with split_sequence(S, channels=cfg.d_model):
        with MODEL_SPANS.span("embed"):
            x = residual_block(tfm.embed_tokens(params, tokens, cfg.vocab))
        cache = init_cache(cfg, B, device=x.device,
                           **rank_cache_dims(params["layers"]))
        layers = whole_layers(params["layers"])
        for i in range(cfg.n_layers):
            x, (conv, state) = ssm_block(cfg, layer_blocks(layer(layers, i)),
                                         x)
            with MODEL_SPANS.span("cache.store"):
                cache.conv[i] = conv
                cache.state[i] = state
        with MODEL_SPANS.span("head"):
            h = rms_norm(whole_channels(x),
                         model_block(params["ln_f"], "ln_f"), cfg.norm_eps)
            logits = tfm.logits_fn(cfg, params, h[:, -1:])[:, 0]
    return logits, SSMCache(cache.conv, cache.state, S)
