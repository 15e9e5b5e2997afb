"""Step functions shared by the server and the launchers."""

from __future__ import annotations

import torch

from ..models import Model


def make_prefill_step(model: Model, max_len: int):
    """``prefill_step(params, batch) -> (logits, cache)``: the whole prompt
    ``batch["tokens"]`` (B, S) in one pass, with a cache ``max_len`` long
    to decode on from; the encoder-decoder family also takes
    ``batch["frames"]`` (B, S_enc, D).  Tokens and frames given as numpy or
    on another device go to the device of the parameters."""
    if model.prefill is None:
        raise NotImplementedError(
            f"{model.cfg.name} ({model.cfg.family}) has no prefill in "
            f"repro_torch yet")

    def prefill_step(params, batch):
        device = params["embed"].device
        moved = {k: torch.as_tensor(batch[k], device=device)
                 for k in ("tokens", "frames") if k in batch}
        return model.prefill(params, {**batch, **moved}, max_len)

    return prefill_step


def make_serve_step(model: Model):
    def serve_step(params, cache, tokens):
        logits, new_cache = model.decode(params, cache, tokens)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, new_cache

    return serve_step
