"""Plain reference of the mixture-of-experts transformer (olmoe).

A pre-norm decoder: RMSNorm with a ``1 + w`` gain, rotary attention over
the sequence, and a feed-forward of routed experts.  The router is a
float32 product; each token takes its ``top_k`` most probable experts,
their probabilities renormalised to sum to 1, and each expert a SwiGLU.
An expert takes at most ``capacity`` (token, choice) pairs of a batch,
the first in the batch's order (token by token, a token's choices from
the most probable): Switch and GShard's capacity, as the configuration
states it.  A *group* is the batch one call of the program routes
together; ``layout`` names each position's group and its place in it.

Everything is float32 from the bfloat16 weights, one layer at a time over
the whole batch.
"""

from __future__ import annotations

import math

import torch

from .common import Precision, attention_block, rms_norm, swiglu


def capacity(arch: dict, tokens: int) -> int:
    """Pairs an expert takes from a group of ``tokens`` tokens: the mean
    times the capacity factor, rounded up to a multiple of
    ``capacity_multiple``, at least ``capacity_min`` (the configuration
    file's ``rules``)."""
    c = math.ceil(tokens * arch["top_k"] * arch["capacity_factor"]
                  / arch["n_experts"])
    m = arch["capacity_multiple"]
    return max(arch["capacity_min"], -(-c // m) * m)


def one_group(B: int, S: int, device):
    """The layout of a batch routed as one group: position ``(b, s)`` is
    token ``b * S + s`` of group 0."""
    group = torch.zeros((B, S), dtype=torch.long, device=device)
    order = torch.arange(B * S, device=device).view(B, S)
    return group, order


def moe_ffn(prec: Precision, arch: dict, lp: dict, h: torch.Tensor,
            layout) -> torch.Tensor:
    """The routed experts' output for ``h (B, S, D)`` under ``layout``
    ``(group, order)``, each ``(B, S)``."""
    B, S, D = h.shape
    E, K = arch["n_experts"], arch["top_k"]
    x = h.reshape(-1, D)
    T = x.shape[0]
    probs = torch.softmax(x @ lp["router"].float(), dim=-1)
    top_p, top_i = torch.topk(probs, K, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    group, order = (t.reshape(-1) for t in layout)
    # each pair's rank among the pairs of its (group, expert), in the
    # group's order
    key = (group[:, None] * E + top_i).reshape(-1)
    prio = (order[:, None] * K + torch.arange(K, device=h.device)).reshape(-1)
    idx = torch.argsort(key * (int(prio.max()) + 1) + prio)
    sk = key[idx]
    rank = torch.empty_like(idx)
    rank[idx] = (torch.arange(idx.numel(), device=h.device)
                 - torch.searchsorted(sk, sk, side="left"))
    sizes = torch.bincount(group)
    cap = torch.tensor([capacity(arch, int(n)) for n in sizes.tolist()],
                       device=h.device)[group]
    keep = rank.view(T, K) < cap[:, None]
    out = torch.zeros_like(x)
    for e in range(E):
        t, k = torch.nonzero((top_i == e) & keep, as_tuple=True)
        if t.numel():
            y = swiglu(prec, x[t], lp["we_gate"][e], lp["we_up"][e],
                       lp["we_down"][e])
            out.index_add_(0, t, y * top_p[t, k, None])
    return out.view(B, S, D)


def hidden(arch: dict, params: dict, tokens: torch.Tensor,
           prec: Precision, *, layout=None, on_kv=None,
           on_ssm=None) -> torch.Tensor:
    """The final normed hidden states ``(B, S, D)`` of ``tokens (B, S)``
    routed in groups by ``layout`` (default: the batch as one group);
    ``on_kv(layer, k, v)`` sees each layer's keys and values.  (No SSM
    block: ``on_ssm`` is never called.)"""
    eps = arch["norm_eps"]
    if layout is None:
        layout = one_group(*tokens.shape, tokens.device)
    x = params["embed"].float()[tokens.long()]
    layers = params["layers"]
    for i in range(arch["n_layers"]):
        lp = {name: w[i] for name, w in layers.items()}
        x, k, v = attention_block(
            prec, lp, x, n_heads=arch["n_heads"], n_kv=arch["n_kv_heads"],
            head_dim=arch["head_dim"], theta=arch["rope_theta"], eps=eps)
        if on_kv is not None:
            on_kv(i, k, v)
        del k, v
        x = x + moe_ffn(prec, arch, lp, rms_norm(x, lp["ln2"], eps), layout)
    return rms_norm(x, params["ln_f"], eps)


def head(params: dict) -> torch.Tensor:
    """The output projection ``(V, D)``: ``lm_head``, or the tied
    embedding."""
    return params.get("lm_head", params["embed"])
