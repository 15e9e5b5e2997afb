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
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..kernels.ssd_chunk import SsdChunkFn, ssd_chunk
from ..parallel.hints import hint, split_sequence
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
                    device="cuda") -> Params:
    """Random Mamba2 block parameters stacked on the leading axes ``lead``
    (``(L,)`` here, ``(G, per)`` in the hybrid), one layer's float32 draw
    at a time from ``generator`` (on ``device``): the JAX package's
    ``init_ssm_layer`` tree and shapes, other numbers."""
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

    a_log = torch.log(torch.linspace(1.0, 16.0, H, device=device))
    return {
        "ln": full((D,), 0.0, dtype),
        "in_proj": stack((D, 2 * d_inner + 2 * N + H)),
        "conv_w": stack((W, conv_dim), scale=0.2),
        "conv_b": full((conv_dim,), 0.0, dtype),
        "A_log": a_log.expand(lead + (H,)).contiguous(),
        "D_skip": full((H,), 1.0, torch.float32),
        "dt_bias": full((H,), 0.0, torch.float32),
        "gate_ln": full((d_inner,), 0.0, dtype),
        "out_proj": stack((d_inner, D)),
    }


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cuda") -> Params:
    """Random parameters from ``generator`` (which must live on ``device``),
    the JAX package's tree: ``embed``, ``ln_f`` and the blocks stacked on
    ``L``."""
    layers = init_ssm_layers(cfg, generator, (cfg.n_layers,), dtype, device)
    device = resolve_device(device)
    return {
        "embed": dense_init(generator, (cfg.vocab, cfg.d_model), scale=0.02,
                            dtype=dtype, device=device),
        "ln_f": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
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


def ssm_block(cfg: ArchConfig, lp, x: Tensor, *, conv_state=None,
              ssm_state=None, streaming=False):
    """One Mamba2 block.  x (B, S, D).  Streaming mode threads conv/ssm
    states (decode); otherwise states start at zero (prefill).  Returns
    ``(x, (conv tail, ssm state))``."""
    Bsz, S, D = x.shape
    d_inner, H, P, N = dims(cfg)
    h = rms_norm(x, lp["ln"], cfg.norm_eps)
    proj = torch.matmul(h, lp["in_proj"])   # (B, S, 2*d_inner + 2N + H)
    z, xin, bc, dt_raw = torch.split(proj, [d_inner, d_inner, 2 * N, H],
                                     dim=-1)
    conv_in = torch.cat([xin, bc], dim=-1)
    conv_out, new_conv = _causal_conv(conv_in, lp["conv_w"], lp["conv_b"],
                                      conv_state)
    xin, Bm, Cm = torch.split(conv_out, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + lp["dt_bias"])
    A = -torch.exp(lp["A_log"])
    xh = xin.reshape(Bsz, S, H, P)
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
    y = y + lp["D_skip"][:, None] * xh.float()
    y = y.reshape(Bsz, S, d_inner).to(x.dtype)
    # the gated product goes into the norm unrounded, as XLA fuses it in the
    # JAX package; the norm's output is rounded to the working dtype once
    y = rms_norm(y.float() * _silu(z).float(), lp["gate_ln"],
                 cfg.norm_eps).to(x.dtype)
    out = torch.matmul(y, lp["out_proj"])
    return x + out, (new_conv, new_state)


# ---------------------------------------------------------------------------
# LM wrappers
# ---------------------------------------------------------------------------


class SSMCache(NamedTuple):
    conv: Tensor   # (L, B, W-1, conv_dim), the model's dtype
    state: Tensor  # (L, B, H, P, N) float32
    pos: int       # tokens seen so far, ONE count for all slots


def init_cache(cfg: ArchConfig, batch: int, dtype=torch.bfloat16,
               device="cuda") -> SSMCache:
    device = resolve_device(device)
    d_inner, H, P, N = dims(cfg)
    L = cfg.n_layers
    return SSMCache(
        torch.zeros((L, batch, cfg.ssm_conv - 1, d_inner + 2 * N),
                    dtype=dtype, device=device),
        torch.zeros((L, batch, H, P, N), dtype=torch.float32, device=device),
        0)


def layer(stacked: Params, i) -> Params:
    """One block's parameters out of a stack: ``i`` indexes the leading
    axes (an int for ``(L, ...)``, a pair for the hybrid's ``(G, per,
    ...)``)."""
    return {name: w[i] for name, w in stacked.items()}


def forward(cfg: ArchConfig, params: Params, tokens: Tensor) -> Tensor:
    """tokens (B, S) -> final hidden states (B, S, D): every block runs the
    chunked scan, each recomputed in the backward when gradients are being
    recorded (so the ``ssd_chunk`` kernel runs ``ceil(S / ssm_chunk)``
    times a layer in the forward and as many again in the recompute)."""
    x = tfm.embed_tokens(params, tokens)

    def block(lp, x):
        return ssm_block(cfg, lp, x)[0]

    for lp in unstack(params["layers"], cfg.n_layers):
        x = hint(remat(block, lp, x), "residual")
    return rms_norm(x, params["ln_f"], cfg.norm_eps)


def lm_loss(cfg: ArchConfig, params: Params, batch: Dict[str, Tensor]
            ) -> Tensor:
    # the residual's channel cut has no process-local form: under a mesh
    # the tokens are spread over 'data' alone (transformer.lm_loss)
    with split_sequence(batch["tokens"].shape[1], cut=False) as split:
        params = tfm.spread_grads(params, split)
        h = forward(cfg, params, batch["tokens"])
        return tfm.chunked_xent(cfg, params, h, batch["labels"])


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Params, cache: SSMCache,
                tokens: Tensor) -> Tuple[Tensor, SSMCache]:
    """One decode step: tokens (B, 1) -> logits (B, V), updated cache.

    The cache's ``conv``/``state`` buffers are **updated in place** (the
    returned cache shares them and carries ``pos + 1``), as the dense
    family's KV cache is."""
    x = tfm.embed_tokens(params, tokens)
    for i in range(cfg.n_layers):
        x, (conv, state) = ssm_block(
            cfg, layer(params["layers"], i), x, conv_state=cache.conv[i],
            ssm_state=cache.state[i], streaming=True)
        cache.conv[i] = conv
        cache.state[i] = state
    h = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = tfm.logits_fn(cfg, params, h)[:, 0]
    return logits, SSMCache(cache.conv, cache.state, int(cache.pos) + 1)


@torch.no_grad()
def prefill(cfg: ArchConfig, params: Params, tokens: Tensor
            ) -> Tuple[Tensor, SSMCache]:
    """tokens (B, S) -> logits of the last position (B, V) and the cache
    that decoding goes on from.  Every block runs the chunked scan: the
    ``ssd_chunk`` kernel ``ceil(S / ssm_chunk)`` times per layer."""
    B, S = tokens.shape
    x = tfm.embed_tokens(params, tokens)
    cache = init_cache(cfg, B, device=x.device)
    for i in range(cfg.n_layers):
        x, (conv, state) = ssm_block(cfg, layer(params["layers"], i), x)
        cache.conv[i] = conv
        cache.state[i] = state
    h = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = tfm.logits_fn(cfg, params, h[:, -1:])[:, 0]
    return logits, SSMCache(cache.conv, cache.state, S)
