"""Step functions shared by the server and the launchers."""

from __future__ import annotations

import torch

from ..models import Model


def make_serve_step(model: Model):
    def serve_step(params, cache, tokens):
        logits, new_cache = model.decode(params, cache, tokens)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, new_cache

    return serve_step
