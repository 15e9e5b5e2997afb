"""Family dispatch: one uniform Model interface over the architectures.

``get_model(cfg)`` returns a ``Model`` with:

* ``init(generator, device=..., dtype=...)`` -> params
* ``prefill(params, batch, max_len)``        -> (logits, cache)
* ``decode(params, cache, tokens)``          -> (logits, cache)
* ``init_cache(batch, max_len, device=...)`` -> cache

This package holds the decode paths of the dense transformer (``dense``
and ``vlm`` -- chameleon: its VQ image tokens live in the shared
vocabulary, frontend stubbed to token ids) and of the MoE transformer
(``moe``, expert dispatch chosen by ``moe_impl``), and the prefill and
decode paths of the Mamba2 SSM (``ssm``) and of the Zamba2 hybrid
(``hybrid``).  ``loss`` is ``None`` until the training side is ported, and
so is the dense and MoE families' ``prefill``; the encoder-decoder family
raises ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, Optional

from ..configs.base import ArchConfig
from . import hybrid, moe, ssm
from . import transformer as tfm

Params = Dict[str, Any]


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable
    loss: Optional[Callable]        # (params, batch) -> scalar
    prefill: Optional[Callable]     # (params, batch, max_len) -> (logits, cache)
    decode: Callable                # (params, cache, tokens) -> (logits, cache)
    init_cache: Callable            # (batch, max_len) -> cache


def get_model(cfg: ArchConfig, moe_impl: str = "sorted") -> Model:
    fam = cfg.family
    if fam in ("dense", "vlm"):
        return Model(
            cfg=cfg,
            init=partial(tfm.init_dense_params, cfg),
            loss=None,
            prefill=None,
            decode=partial(tfm.decode_step, cfg),
            init_cache=partial(tfm.init_cache, cfg),
        )
    if fam == "moe":
        if moe_impl not in moe.MOE_IMPLS:
            raise ValueError(f"unknown moe_impl {moe_impl!r}; "
                             f"one of {sorted(moe.MOE_IMPLS)}")
        return Model(
            cfg=cfg,
            init=partial(moe.init_moe_params, cfg),
            loss=None,
            prefill=None,
            decode=partial(moe.decode_step, cfg, impl=moe_impl),
            init_cache=partial(tfm.init_cache, cfg),
        )
    if fam == "ssm":
        def ssm_cache(batch, max_len, **kw):     # the state has no length
            return ssm.init_cache(cfg, batch, **kw)

        return Model(
            cfg=cfg,
            init=partial(ssm.init_params, cfg),
            loss=None,
            prefill=lambda p, batch, max_len: ssm.prefill(
                cfg, p, batch["tokens"]),
            decode=partial(ssm.decode_step, cfg),
            init_cache=ssm_cache,
        )
    if fam == "hybrid":
        return Model(
            cfg=cfg,
            init=partial(hybrid.init_params, cfg),
            loss=None,
            prefill=lambda p, batch, max_len: hybrid.prefill(
                cfg, p, batch["tokens"], max_len),
            decode=partial(hybrid.decode_step, cfg),
            init_cache=partial(hybrid.init_cache, cfg),
        )
    if fam in ("encdec", "audio"):
        raise NotImplementedError(
            f"model family {fam!r} ({cfg.name}) is not in repro_torch yet; "
            f"the dense/vlm, moe, ssm and hybrid families are")
    raise ValueError(f"unknown family {fam}")
