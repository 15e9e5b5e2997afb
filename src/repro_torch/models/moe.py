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
``T = B * S`` tokens.  ``lm_loss`` adds the load-balancing loss to the
cross-entropy; gradients reach the tokens through the dispatch kernel's
autograd function.  ``a2a`` is the expert-parallel dispatch over the
``model`` axis of a ``DeviceMesh`` (``moe_ffn_a2a``); without one it is
``sorted``.  Under a mesh the ``a2a`` model's passes carry this rank's
block of the sequence from the embedding on (``parallel/hints.py``), the
layout its combine lands in.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from ..configs.base import ArchConfig
from ..core.tracing import MODEL_SPANS
from ..device import resolve_device
from ..kernels import ops
from ..parallel.hints import (column_in, current_split, hint, layer_blocks,
                              model_axis, model_block, model_shape,
                              policy_defaults, policy_value, residual_block,
                              row_parallel_end, split_sequence, whole_layers)
from . import transformer as tfm
from .layers import (dense_init, parallel_swiglu, remat, rms_norm, swiglu,
                     unstack)

Tensor = torch.Tensor
Params = Dict[str, Any]


def init_moe_params(cfg: ArchConfig, generator: torch.Generator,
                    dtype=torch.bfloat16, device="cuda", keep=None) -> Params:
    """Random parameters from ``generator`` (on ``device``), the JAX
    package's tree: the dense transformer's, with a float32 ``router``
    ``(L, D, E)`` and expert weights ``we_gate``/``we_up`` ``(L, E, D, F)``
    and ``we_down`` ``(L, E, F, D)``; the dense FFN is dropped unless the
    config has a shared expert.  One layer's float32 draw at a time;
    ``keep`` as in ``transformer.init_dense_params``."""
    p = tfm.init_dense_params(cfg, generator, dtype, device, keep=keep)
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

    def leaf(name, t):
        return t if keep is None else keep("layers/" + name, t)

    lyr["router"] = leaf("router", stack((D, E), 0.02, torch.float32))
    lyr["we_gate"] = leaf("we_gate", stack((E, D, Fm), 1 / math.sqrt(D),
                                           dtype))
    lyr["we_up"] = leaf("we_up", stack((E, D, Fm), 1 / math.sqrt(D), dtype))
    lyr["we_down"] = leaf("we_down", stack((E, Fm, D), 1 / math.sqrt(Fm),
                                           dtype))
    return p


# ---------------------------------------------------------------------------
# Routing + dispatch
# ---------------------------------------------------------------------------


def _route(cfg: ArchConfig, router_w: Tensor, xt: Tensor,
           batch_fe: bool = False):
    """xt (T, D) -> (probs (T, K), idx (T, K), aux load-balance loss).

    ``batch_fe``: in a pass whose batch rows are cut over ``data``
    (``parallel.hints.split_sequence``), the share of tokens each expert
    takes first is the whole batch's, so that the mean of the ranks' aux
    (``lm_loss``) is the whole batch's, as the JAX package's ``sorted``
    and ``dense`` layers compute it under a mesh (its ``a2a`` layer
    routes each data row apart).  A router cut on the experts over
    ``model`` gives this rank's ``(T, E/n)`` logits, gathered whole before
    the softmax and the top-k, so that the routing is the whole row's and
    the same in every rank."""
    logits = xt.float() @ router_w.float()                 # (T, E)
    if logits.shape[-1] < cfg.n_experts:
        from ..parallel.collectives import all_gather_dim
        logits = all_gather_dim(logits, 1, model_axis()[0])
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balancing aux loss: E * sum_e f_e * p_e
    E = probs.shape[-1]
    me = probs.mean(0)
    fe = torch.nn.functional.one_hot(top_i[:, 0], E).float().mean(0)
    split = current_split() if batch_fe else None
    if split is not None:
        fe = split.batch_mean(fe)
    aux = E * torch.sum(fe * me)
    return top_p, top_i, aux


def moe_ffn_dense(cfg: ArchConfig, lp, h: Tensor) -> Tuple[Tensor, Tensor]:
    """Oracle path: run all experts on all tokens (small shapes only)."""
    B, S, D = h.shape
    xt = h.reshape(-1, D)
    top_p, top_i, aux = _route(cfg, lp["router"], xt, batch_fe=True)
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
    """Serving path: sort-based capacity dispatch (see module doc).

    In a pass whose batch rows are cut over ``data``
    (``hints.current_split``), the pairs kept are the whole batch's, as
    the JAX package's layer keeps them under a mesh: every rank's choices
    gathered over ``data``, sorted by expert in the same stable order and
    ranked against ``capacity(cfg, T_whole)``; each rank fills its own
    tokens' slots and returns its own rows.  With expert weights (and
    router) cut over ``model`` (the ``"expert_buffer"`` expert cut) each
    rank runs its ``E/n`` experts' rows of the buffer and the combine of
    their pairs, summed over ``model`` by ``hints.row_parallel_end``."""
    B, S, D = h.shape
    T = B * S
    K, E = cfg.top_k, cfg.n_experts
    E_loc = lp["we_gate"].shape[-3]
    cut = E_loc < E
    with MODEL_SPANS.span("moe.route"):
        if cut or lp["router"].shape[-1] < E:
            h = column_in(h)
        xt = h.reshape(T, D)
        top_p, top_i, aux = _route(cfg, lp["router"], xt, batch_fe=True)
    split = current_split()
    n_data = 1 if split is None else split.n_data
    C = capacity(cfg, T * n_data)
    with MODEL_SPANS.span("moe.dispatch"):
        if n_data == 1:
            slot_token, order, sorted_e, rank, keep = dispatch_slots(
                top_i, C, E)
        else:
            import torch.distributed as dist

            from ..parallel.collectives import all_gather_dim
            slot_token, order, sorted_e, rank, keep = dispatch_slots(
                all_gather_dim(top_i, 0, split.data), C, E)
            # the whole batch's slots, of which this rank fills its tokens'
            lo = dist.get_rank(split.data) * T
            mine = (slot_token >= lo) & (slot_token < lo + T)
            slot_token = torch.where(mine, slot_token - lo,
                                     T).to(torch.int32)
        # the pairs kept under capacity, of those routed (the whole
        # batch's where its rows are cut over data)
        MODEL_SPANS.count("moe.pairs_kept", keep)
        MODEL_SPANS.count("moe.pairs_routed", keep.numel())
        if cut:              # this rank's experts' slots
            m = model_axis()[2]
            slot_token = slot_token[m * E_loc * C:(m + 1) * E_loc * C]
        buf = hint(ops.dispatch(xt, slot_token).view(E_loc, C, D),  # B5
                   "expert_buffer")

    with MODEL_SPANS.span("moe.experts"):
        y = swiglu(buf, lp["we_gate"], lp["we_up"], lp["we_down"])

    # Combine.  The JAX package adds every pair into its token with a
    # scatter-add; on the card that is atomics in no fixed order, and a
    # rerun would round differently.  Each token has exactly K pairs, so
    # they are gathered back into (T, K) order through the inverse of the
    # sort and summed in float32 in that order: the same sum, in another
    # order than the JAX package's, within float32 rounding of it.
    with MODEL_SPANS.span("moe.combine"):
        inv = torch.empty_like(order).scatter_(
            0, order, torch.arange(order.shape[0], device=h.device))
        row = (sorted_e * C + torch.clamp(rank, max=C - 1))[inv]
        keep = keep[inv]
        if n_data > 1:       # this rank's tokens' pairs
            pairs = slice(lo * K, (lo + T) * K)
            row, keep = row[pairs], keep[pairs]
        if cut:              # the pairs of this rank's experts
            keep = keep & (top_i.reshape(-1) // E_loc == m)
            row = torch.where(keep, row - m * E_loc * C, 0)
        y_tok = y.reshape(E_loc * C, D)[row].masked_fill(~keep[:, None], 0)
        out = (y_tok.float() * top_p.reshape(-1, 1)).view(T, K, D).sum(1)
        out = out.reshape(B, S, D)
        if cut:
            out = row_parallel_end(out)
        out = out.to(h.dtype)
    return out, aux


def moe_ffn_a2a(cfg: ArchConfig, lp, h: Tensor) -> Tuple[Tensor, Tensor]:
    """Expert-parallel dispatch over the ``model`` axis of the
    ``DeviceMesh`` in the sharding policy (``parallel.hints``).

    Banking view: experts are banks on the ``model`` axis; the dispatch
    crossbar is *local selection* (every rank of a ``model`` group holds
    the same tokens, as the block-input all-gather of the attention path
    leaves them), and the combine crossbar is one reduce-scatter that lands
    the output in the sequence-sharded residual layout.  Per layer the
    collective bytes drop from O(E*C*D) buffer all-reduces to one (T x D)
    reduce-scatter.

    Process-local, as a rank sees it: ``h`` (B_loc, S, D) is this rank's
    batch rows, ``lp["router"]`` the whole (D, E) router (or its ``E/n``
    columns under tensor parallelism, gathered by ``_route``), and the
    expert weights this rank's ``E/n`` experts (``convert.for_ranks``),
    each a ``model`` block: where the policy declares them cut over the
    data axes too (``"__params__"``, the dry-run's FSDP specs: F at full
    width, D where F does not bank), the pass has gathered them on the
    dim their spec cuts (``hints.layer_blocks``), layer by layer.
    Returns this rank's sequence block
    (B_loc, S/n, D) of the combined output and the load-balancing loss of
    ``h``'s tokens, the same in every rank of the ``model`` group
    (``lm_loss`` takes its mean over the ranks).  Without a mesh in the
    policy, or where E or S does not divide by the ``model`` size, it is
    ``moe_ffn_sorted``, as in the JAX package: every decode step's one
    token.  Each call adds one to its branch's count in
    :data:`A2A_BRANCHES`.
    """
    import torch.distributed as dist

    from ..parallel.collectives import reduce_scatter_dim
    from ..parallel.sharding import mesh_axes

    mesh = policy_value("__mesh__")
    n_model = (mesh_axes(mesh)["model"] if mesh is not None
               and "model" in (getattr(mesh, "mesh_dim_names", None) or ())
               else None)
    E = cfg.n_experts
    if n_model is None or E % n_model or h.shape[1] % n_model:
        A2A_BRANCHES["sorted"] += 1
        return moe_ffn_sorted(cfg, lp, h)
    A2A_BRANCHES["a2a"] += 1
    E_loc = E // n_model
    we_gate, we_up, we_down = lp["we_gate"], lp["we_up"], lp["we_down"]
    if we_gate.shape[0] != E_loc:
        raise ValueError(f"expert weights hold {we_gate.shape[0]} experts; "
                         f"a rank of a model axis of {n_model} holds "
                         f"{E_loc} of {E}")
    group = mesh.get_group("model")
    m = dist.get_rank(group)
    B, S, D = h.shape
    T, K = B * S, cfg.top_k
    C = capacity(cfg, T)
    xt = h.reshape(T, D)
    top_p, top_i, aux = _route(cfg, lp["router"], xt)
    # this rank's experts sort first by local index, every foreign pair
    # after them under the key E_loc; stable, so a kept pair's rank is its
    # rank within its expert over all tokens, as in moe_ffn_sorted
    mine = top_i // E_loc == m
    key = torch.where(mine, top_i - m * E_loc, E_loc)
    slot_token, order, sorted_e, rank, keep = dispatch_slots(key, C,
                                                             E_loc + 1)
    keep = keep & (sorted_e < E_loc)
    buf = ops.dispatch(xt, slot_token[:E_loc * C]).view(E_loc, C, D)  # B5
    y = swiglu(buf, we_gate, we_up, we_down)             # (E_loc, C, D)

    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(T * K, device=h.device))
    row = (torch.clamp(sorted_e, max=E_loc - 1) * C
           + torch.clamp(rank, max=C - 1))[inv]
    y_tok = y.reshape(E_loc * C, D)[row].masked_fill(~keep[inv][:, None], 0)
    out = (y_tok.float() * top_p.reshape(-1, 1)).view(T, K, D).sum(1)
    # the combine crossbar: each token's expert sums over the model axis,
    # landing sequence-sharded (the residual layout)
    out = reduce_scatter_dim(out.view(B, S, D), 1, group)
    return out.to(h.dtype), aux


MOE_IMPLS = {"dense": moe_ffn_dense, "sorted": moe_ffn_sorted,
             "a2a": moe_ffn_a2a}
# the calls of ``moe_ffn_a2a`` by the branch they took: the expert-parallel
# layer, or its fallback to ``moe_ffn_sorted``
A2A_BRANCHES = {"a2a": 0, "sorted": 0}


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
            delta = residual_block(delta) + parallel_swiglu(
                h, lp["w_gate"], lp["w_up"], lp["w_down"], cfg.d_ff)
        return delta

    return ffn


def _layout(impl: str):
    """The layout the pass takes: the ``a2a`` layer's combine lands in the
    sequence-cut residual, so under a mesh whose policy says nothing of
    the residual the pass takes the dry-run's attention layout (the
    residual cut on the sequence over ``model``, the block inputs
    whole)."""
    mesh = policy_value("__mesh__")
    if impl != "a2a" or mesh is None:
        return policy_defaults()
    from ..parallel.sharding import sequence_parallel_layout

    return policy_defaults(**sequence_parallel_layout(mesh))


def forward(cfg: ArchConfig, params: Params, tokens: Tensor,
            impl: str = "sorted") -> Tuple[Tensor, Tensor]:
    """tokens (B, S) -> (final hidden states (B, S, D), the load-balancing
    loss averaged over the layers): ``transformer.forward``'s layers with
    the expert layer as the feed-forward, each recomputed in the backward
    when gradients are being recorded (the expert buffer through
    ``ops.dispatch``'s autograd function).  Each layer returns its own aux
    loss, so a recomputed layer adds nothing twice.

    Under a policy whose ``"residual"`` cuts the sequence (with ``a2a``
    and a mesh: always, see :func:`_layout`) the residual stream is this
    rank's block from the embedding on, as in ``transformer.forward``;
    the JAX package hints no embedding here, so the cut is made without a
    hint."""
    with _layout(impl), split_sequence(tokens.shape[1]):
        x = residual_block(tfm.embed_tokens(params, tokens, cfg.vocab))
        windows = tfm.layer_windows(cfg)

        def block(lp, x, window):
            aux = []
            x, _ = tfm.dense_layer(cfg, layer_blocks(lp), x, window,
                                   ffn=_ffn(cfg, impl, aux))
            return hint(x, "residual"), aux[0]

        total = 0.0
        layers = whole_layers(params["layers"])
        for i, lp in enumerate(unstack(layers, cfg.n_layers)):
            x, aux_l = remat(block, lp, x, int(windows[i]))
            total = total + aux_l
        return (rms_norm(x, model_block(params["ln_f"], "ln_f"),
                         cfg.norm_eps), total / cfg.n_layers)


def lm_loss(cfg: ArchConfig, params: Params, batch: Dict[str, Tensor],
            impl: str = "sorted", aux_weight: float = 0.01) -> Tensor:
    """The chunked cross-entropy plus ``aux_weight`` times the
    load-balancing loss, as in the JAX package.  Under a policy with a
    ``"__mesh__"``: ``transformer.lm_loss``'s mean over the ranks and
    summed gradients and, for the leaves cut over ``model`` (the experts
    of ``a2a``, every cut leaf under tensor parallelism), each rank's own.
    Every rank of a ``model`` group routes its data row's whole gathered
    sequence, so each holds the same load-balancing loss (``a2a``: its
    row's; ``sorted`` and ``dense``: its row's router probabilities
    against the whole batch's first choices, see ``_route``): the loss
    takes the mean over every rank -- over the ``model`` group too where
    the router is cut, sequence cut or not -- and each rank's gradient is
    its share of it (summed over the ranks by ``spread_grads`` and the
    router's gather)."""
    with _layout(impl), split_sequence(batch["tokens"].shape[1]) as split:
        with tfm.loss_params(params, split) as params:
            h, aux = forward(cfg, params, batch["tokens"], impl=impl)
            if split is not None:
                router = model_shape(params["layers"]["router"],
                                     "layers/router")
                aux = (split.mean_with_model(aux)
                       if router[-1] < cfg.n_experts else split.mean(aux))
            return (tfm.chunked_xent(cfg, params, h, batch["labels"])
                    + aux_weight * aux)


@torch.no_grad()
def prefill(cfg: ArchConfig, params: Params, tokens: Tensor, max_len: int,
            impl: str = "sorted") -> Tuple[Tensor, tfm.KVCache]:
    """``transformer.prefill`` with the expert layer as the feed-forward:
    last-position logits and a cache ``max_len`` long.  With ``a2a`` under
    a mesh the residual is cut on the sequence (:func:`_layout`)."""
    with _layout(impl):
        return tfm.prefill(cfg, params, tokens, max_len, ffn=_ffn(cfg, impl),
                           residual_hint=False)


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
