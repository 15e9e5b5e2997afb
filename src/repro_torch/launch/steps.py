"""Step functions shared by the trainer, the server and the launchers."""

from __future__ import annotations

import torch

from ..core.tracing import MODEL_SPANS
from ..models import Model
from ..optim import adamw
from ..parallel.hints import state_layout


def value_and_grad(model: Model, params, batch):
    """``(loss, grads)``: ``model.loss`` and its gradient with respect to
    every parameter (``torch.autograd.grad`` where the JAX package takes
    ``jax.value_and_grad``), ``grads`` a tree like ``params``.  The batch's
    arrays (numpy or tensors anywhere) go to the parameters' device."""
    device = params["embed"].device
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    leaves = adamw.tree_map(lambda p: p.detach().requires_grad_(True),
                            params)
    loss = model.loss(leaves, batch)
    grads = iter(torch.autograd.grad(loss, adamw.tree_leaves(leaves)))
    return loss.detach(), adamw.tree_map(lambda _: next(grads), leaves)


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig):
    """``train_step(params, opt_state, batch) -> (loss, params,
    opt_state)``: :func:`value_and_grad`, then one AdamW update, which
    writes the new parameters and state into the tensors it was given.
    ``loss`` is a 0-d float32 tensor on the parameters' device.  Under a
    sharding policy with a ``"__mesh__"`` the gradients come back summed
    over the ranks (``models.transformer.spread_grads``) and the clip
    takes the model's norm over every rank (``Model.grad_norm``: a leaf
    cut over ``model`` counted once, from its blocks), so the leaves each
    rank holds whole stay equal in every rank and AdamW updates each
    rank's blocks as the whole model's step would.  Where the policy
    declares the optimizer state cut beyond the weights (``"__opt__"``,
    ZeRO-1: ``parallel.hints.state_layout``), ``opt_state`` holds this
    rank's blocks (``adamw.init(params, cuts=state_layout(params))``
    under the same policy) and each weight is gathered from the ranks'
    updated blocks."""
    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(model, params, batch)
        gnorm = model.grad_norm(grads) if model.grad_norm else None
        params, opt_state = adamw.update(opt_cfg, grads, opt_state, params,
                                         gnorm=gnorm,
                                         cuts=state_layout(params))
        return loss, params, opt_state

    return train_step


def make_prefill_step(model: Model, max_len: int):
    """``prefill_step(params, batch) -> (logits, cache)``: the whole prompt
    ``batch["tokens"]`` (B, S) in one pass, with a cache ``max_len`` long
    to decode on from; the encoder-decoder family also takes
    ``batch["frames"]`` (B, S_enc, D).  Tokens and frames given as numpy or
    on another device go to the device of the parameters.  Each call is
    the step ``"prefill"`` of ``core.tracing.MODEL_SPANS``."""
    if model.prefill is None:
        raise NotImplementedError(
            f"{model.cfg.name} ({model.cfg.family}) has no prefill in "
            f"repro_torch yet")

    def prefill_step(params, batch):
        device = params["embed"].device
        with MODEL_SPANS.step("prefill", device):
            moved = {k: torch.as_tensor(batch[k], device=device)
                     for k in ("tokens", "frames") if k in batch}
            return model.prefill(params, {**batch, **moved}, max_len)

    return prefill_step


def make_serve_step(model: Model):
    """``serve_step(params, cache, tokens) -> (next tokens (B, 1) int32,
    logits, cache)``: one decode step and its greedy tokens; each call is
    the step ``"decode"`` of ``core.tracing.MODEL_SPANS``."""
    def serve_step(params, cache, tokens):
        with MODEL_SPANS.step("decode", params["embed"].device):
            logits, new_cache = model.decode(params, cache, tokens)
            next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, new_cache

    return serve_step
