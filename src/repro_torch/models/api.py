"""Family dispatch: one uniform Model interface over the architectures.

``get_model(cfg)`` returns a ``Model`` with:

* ``init(generator, device=..., dtype=...)`` -> params
* ``loss(params, batch)``                    -> 0-d float32 tensor
* ``prefill(params, batch, max_len)``        -> (logits, cache)
* ``decode(params, cache, tokens)``          -> (logits, cache)
* ``init_cache(batch, max_len, device=...)`` -> cache

Every family has its loss, prefill and decode paths here: the dense
transformer (``dense`` and ``vlm`` -- chameleon: its VQ image tokens live
in the shared vocabulary, frontend stubbed to token ids), the MoE
transformer (``moe``, expert dispatch chosen by ``moe_impl``), the Mamba2
SSM (``ssm``), the Zamba2 hybrid (``hybrid``) and the Whisper
encoder-decoder (``encdec`` / ``audio``: its prefill takes
``batch["frames"]`` beside the tokens, and its ``init_cache`` is
``None``, since the cross K/V come from the frames at prefill).
``loss`` is the training objective (the chunked cross-entropy of
``batch["labels"]``; the MoE family adds its load-balancing loss, the
encoder-decoder reads ``batch["frames"]`` too); gradients flow through it
into every parameter, through the kernels' autograd functions.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, Optional

from ..configs.base import ArchConfig
from . import encdec, hybrid, moe, ssm
from . import transformer as tfm

Params = Dict[str, Any]


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable
    loss: Callable                  # (params, batch) -> scalar
    prefill: Optional[Callable]     # (params, batch, max_len) -> (logits, cache)
    decode: Callable                # (params, cache, tokens) -> (logits, cache)
    init_cache: Optional[Callable]  # (batch, max_len) -> cache; encdec: None
    # (grads) -> the global norm over every rank, where ranks may hold
    # different blocks of the leaves (tensor parallelism, the
    # expert-parallel MoE model); else None
    grad_norm: Optional[Callable] = None


def get_model(cfg: ArchConfig, moe_impl: str = "sorted") -> Model:
    fam = cfg.family
    if fam in ("dense", "vlm"):
        return Model(
            cfg=cfg,
            init=partial(tfm.init_dense_params, cfg),
            loss=partial(tfm.lm_loss, cfg),
            prefill=lambda p, batch, max_len: tfm.prefill(
                cfg, p, batch["tokens"], max_len),
            decode=partial(tfm.decode_step, cfg),
            init_cache=partial(tfm.init_cache, cfg),
            grad_norm=tfm.grad_norm,
        )
    if fam == "moe":
        if moe_impl not in moe.MOE_IMPLS:
            raise ValueError(f"unknown moe_impl {moe_impl!r}; "
                             f"one of {sorted(moe.MOE_IMPLS)}")
        return Model(
            cfg=cfg,
            init=partial(moe.init_moe_params, cfg),
            loss=partial(moe.lm_loss, cfg, impl=moe_impl),
            prefill=lambda p, batch, max_len: moe.prefill(
                cfg, p, batch["tokens"], max_len, impl=moe_impl),
            decode=partial(moe.decode_step, cfg, impl=moe_impl),
            init_cache=partial(tfm.init_cache, cfg),
            grad_norm=tfm.grad_norm,
        )
    if fam == "ssm":
        def ssm_cache(batch, max_len, **kw):     # the state has no length
            return ssm.init_cache(cfg, batch, **kw)

        return Model(
            cfg=cfg,
            init=partial(ssm.init_params, cfg),
            loss=partial(ssm.lm_loss, cfg),
            prefill=lambda p, batch, max_len: ssm.prefill(
                cfg, p, batch["tokens"]),
            decode=partial(ssm.decode_step, cfg),
            init_cache=ssm_cache,
            grad_norm=tfm.grad_norm,
        )
    if fam == "hybrid":
        return Model(
            cfg=cfg,
            init=partial(hybrid.init_params, cfg),
            loss=partial(hybrid.lm_loss, cfg),
            prefill=lambda p, batch, max_len: hybrid.prefill(
                cfg, p, batch["tokens"], max_len),
            decode=partial(hybrid.decode_step, cfg),
            init_cache=partial(hybrid.init_cache, cfg),
            grad_norm=tfm.grad_norm,
        )
    if fam in ("encdec", "audio"):
        return Model(
            cfg=cfg,
            init=partial(encdec.init_params, cfg),
            loss=partial(encdec.lm_loss, cfg),
            prefill=lambda p, batch, max_len: encdec.prefill(
                cfg, p, batch["frames"], batch["tokens"], max_len),
            decode=partial(encdec.decode_step, cfg),
            init_cache=None,      # the cross K/V come from the frames
            grad_norm=tfm.grad_norm,
        )
    raise ValueError(f"unknown family {fam}")


def param_shapes(model: Model) -> Params:
    """The model's parameter tree on the ``meta`` device: every leaf's
    shape and dtype, nothing allocated (the JAX package's
    ``jax.eval_shape`` of ``init``)."""
    import torch

    return model.init(torch.Generator(), device="meta")
