"""Mixture-of-Experts transformer (olmoe, llama4-maverick): forward, prefill
and decode.

Expert dispatch is a banking problem: experts are banks, the router emits
the access pattern, capacity is the port count, and the token -> expert
crossbar is the fan-out the paper's metrics size.

Two implementations, as in the JAX package:

* ``dense``  -- every expert runs on every token, outputs mixed by routing
  probability.  Exact (no capacity drops); O(T*E*F) -- the oracle.
* ``sorted`` -- the serving path: top-k routing, a stable sort of the
  (token, choice) pairs by expert, capacity-bounded slots, the ``(E, C, D)``
  expert buffer filled by the ``moe_dispatch`` kernel
  (``kernels/moe_dispatch.py``), the SwiGLU of ``layers.py`` batched over
  the experts, and a weighted sum back to the tokens.  Tokens past
  capacity are dropped, exactly like Switch/GShard.

The routing and the combine are written without a host synchronization:
no boolean-mask indexing, no ``nonzero``, no ``.item()``.  Layer
parameters are stacked on a leading ``L`` axis as in the JAX package, so
weights map one to one.  ``forward``, ``prefill`` and ``decode_step`` are
the dense transformer's passes with the expert layer as every layer's
feed-forward; in a prefill the ``sorted`` path fills its expert buffer at
``T = B * S`` tokens.  The loss is not here yet; neither is the
expert-parallel ``a2a`` dispatch, which needs a device mesh.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..kernels import ops
from . import transformer as tfm
from .layers import dense_init, swiglu

Tensor = torch.Tensor
Params = Dict[str, Any]


def init_moe_params(cfg: ArchConfig, generator: torch.Generator,
                    dtype=torch.bfloat16, device="cuda") -> Params:
    """Random parameters from ``generator`` (on ``device``), the JAX
    package's tree: the dense transformer's, with a float32 ``router``
    ``(L, D, E)`` and expert weights ``we_gate``/``we_up`` ``(L, E, D, F)``
    and ``we_down`` ``(L, E, F, D)``; the dense FFN is dropped unless the
    config has a shared expert.  One layer's float32 draw at a time."""
    p = tfm.init_dense_params(cfg, generator, dtype, device)
    device = resolve_device(device)
    L, D, E = cfg.n_layers, cfg.d_model, cfg.n_experts
    Fm = cfg.moe_d_ff or cfg.d_ff
    lyr = p["layers"]
    if not cfg.shared_expert:
        # routed experts replace the dense FFN entirely
        for k in ("w_gate", "w_up", "w_down"):
            del lyr[k]

    def stack(shape, scale, dt):
        out = torch.empty((L,) + shape, dtype=dt, device=device)
        for i in range(L):
            out[i] = dense_init(generator, shape, scale=scale, dtype=dt,
                                device=device)
        return out

    lyr["router"] = stack((D, E), 0.02, torch.float32)
    lyr["we_gate"] = stack((E, D, Fm), 1 / math.sqrt(D), dtype)
    lyr["we_up"] = stack((E, D, Fm), 1 / math.sqrt(D), dtype)
    lyr["we_down"] = stack((E, Fm, D), 1 / math.sqrt(Fm), dtype)
    return p


# ---------------------------------------------------------------------------
# Routing + dispatch
# ---------------------------------------------------------------------------


def _route(cfg: ArchConfig, router_w: Tensor, xt: Tensor):
    """xt (T, D) -> (probs (T, K), idx (T, K), aux load-balance loss)."""
    logits = xt.float() @ router_w.float()                 # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balancing aux loss: E * sum_e f_e * p_e
    E = probs.shape[-1]
    me = probs.mean(0)
    fe = torch.nn.functional.one_hot(top_i[:, 0], E).float().mean(0)
    aux = E * torch.sum(fe * me)
    return top_p, top_i, aux


def moe_ffn_dense(cfg: ArchConfig, lp, h: Tensor) -> Tuple[Tensor, Tensor]:
    """Oracle path: run all experts on all tokens (small shapes only)."""
    B, S, D = h.shape
    xt = h.reshape(-1, D)
    top_p, top_i, aux = _route(cfg, lp["router"], xt)
    gates = torch.zeros((xt.shape[0], cfg.n_experts), dtype=torch.float32,
                        device=h.device).scatter_(1, top_i, top_p)
    # every expert on every token: (1, T, D) against (E, D, F) batches
    y = swiglu(xt[None], lp["we_gate"], lp["we_up"], lp["we_down"])
    out = torch.einsum("etd,te->td", y.float(), gates)
    return out.reshape(B, S, D).to(h.dtype), aux


def capacity(cfg: ArchConfig, T: int) -> int:
    c = int(math.ceil(T * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    return max(8, -(-c // 8) * 8)


def dispatch_slots(top_i: Tensor, C: int, E: int):
    """Capacity-bounded slots for ``top_i (T, K)`` expert choices.

    The (token, choice) pairs are sorted by expert, stably (the JAX
    package's ``argsort`` is stable; another order would drop other tokens
    at capacity), and each pair's rank within its expert is its slot; a
    rank of ``C`` or more is dropped.  Returns ``(slot_token, order,
    sorted_e, rank, keep)``: ``slot_token (E*C,) int32`` names the token in
    each slot, ``T`` where a slot stays empty; the rest are per sorted
    pair.  ``slot_token`` is built by ONE scatter into ``E*C + 1`` entries
    whose last one takes every dropped write -- the JAX package's
    ``mode="drop"`` -- so nothing here waits for the device."""
    T, K = top_i.shape
    flat_e = top_i.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(T * K, device=top_i.device) - first
    keep = rank < C
    dest = torch.where(keep, sorted_e * C + rank, E * C)
    slot_token = torch.full((E * C + 1,), T, dtype=torch.int32,
                            device=top_i.device)
    slot_token.scatter_(0, dest, (order // K).to(torch.int32))
    return slot_token[:E * C], order, sorted_e, rank, keep


def moe_ffn_sorted(cfg: ArchConfig, lp, h: Tensor) -> Tuple[Tensor, Tensor]:
    """Serving path: sort-based capacity dispatch (see module doc)."""
    B, S, D = h.shape
    T = B * S
    K, E = cfg.top_k, cfg.n_experts
    C = capacity(cfg, T)
    xt = h.reshape(T, D)
    top_p, top_i, aux = _route(cfg, lp["router"], xt)
    slot_token, order, sorted_e, rank, keep = dispatch_slots(top_i, C, E)
    buf = ops.dispatch(xt, slot_token).view(E, C, D)     # the B5 kernel

    y = swiglu(buf, lp["we_gate"], lp["we_up"], lp["we_down"])  # (E, C, D)

    # Combine.  The JAX package adds every pair into its token with a
    # scatter-add; on the card that is atomics in no fixed order, and a
    # rerun would round differently.  Each token has exactly K pairs, so
    # they are gathered back into (T, K) order through the inverse of the
    # sort and summed in float32 in that order: the same sum, in another
    # order than the JAX package's, within float32 rounding of it.
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(T * K, device=h.device))
    row = (sorted_e * C + torch.clamp(rank, max=C - 1))[inv]
    y_tok = y.reshape(E * C, D)[row].masked_fill(~keep[inv][:, None], 0)
    out = (y_tok.float() * top_p.reshape(-1, 1)).view(T, K, D).sum(1)
    return out.reshape(B, S, D).to(h.dtype), aux


def moe_ffn_a2a(cfg: ArchConfig, lp, h: Tensor):
    raise NotImplementedError(
        "moe_impl 'a2a' (expert-parallel dispatch over a device mesh) is not "
        "in repro_torch yet: it comes with the multi-device side of the "
        "port; use 'sorted'")


MOE_IMPLS = {"dense": moe_ffn_dense, "sorted": moe_ffn_sorted,
             "a2a": moe_ffn_a2a}


# ---------------------------------------------------------------------------
# Whole-sequence passes and single-token decode
# ---------------------------------------------------------------------------


def _ffn(cfg: ArchConfig, impl: str, aux=None):
    """Every layer's feed-forward: the routed experts, plus the dense FFN
    where the config has a shared expert.  ``aux`` (a list) receives each
    layer's load-balancing loss."""
    moe_fn = MOE_IMPLS[impl]

    def ffn(lp, h):
        delta, aux_l = moe_fn(cfg, lp, h)
        if aux is not None:
            aux.append(aux_l)
        if cfg.shared_expert:
            delta = delta + swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])
        return delta

    return ffn


@torch.no_grad()
def forward(cfg: ArchConfig, params: Params, tokens: Tensor,
            impl: str = "sorted") -> Tuple[Tensor, Tensor]:
    """tokens (B, S) -> (final hidden states (B, S, D), the load-balancing
    loss averaged over the layers)."""
    aux = []
    h = tfm.forward(cfg, params, tokens, ffn=_ffn(cfg, impl, aux))
    return h, sum(aux) / cfg.n_layers


@torch.no_grad()
def prefill(cfg: ArchConfig, params: Params, tokens: Tensor, max_len: int,
            impl: str = "sorted") -> Tuple[Tensor, tfm.KVCache]:
    """``transformer.prefill`` with the expert layer as the feed-forward:
    last-position logits and a cache ``max_len`` long."""
    return tfm.prefill(cfg, params, tokens, max_len, ffn=_ffn(cfg, impl))


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Params, cache: tfm.KVCache,
                tokens: Tensor, impl: str = "sorted", block_k: int = 1024
                ) -> Tuple[Tensor, tfm.KVCache]:
    """One decode step of the MoE transformer: the dense step
    (``transformer.decode_step``, cache updated in place) with the routed
    experts -- plus the dense FFN where the config has a shared expert --
    as every layer's feed-forward."""
    return tfm.decode_step(cfg, params, cache, tokens, block_k=block_k,
                           ffn=_ffn(cfg, impl))
