"""Family dispatch: one uniform Model interface over the architectures.

``get_model(cfg)`` returns a ``Model`` with:

* ``init(generator, device=..., dtype=...)`` -> params
* ``decode(params, cache, tokens)``          -> (logits, cache)
* ``init_cache(batch, max_len, device=...)`` -> cache

This package holds the decode paths of the dense transformer (``dense``
and ``vlm`` -- chameleon: its VQ image tokens live in the shared
vocabulary, frontend stubbed to token ids) and of the MoE transformer
(``moe``, expert dispatch chosen by ``moe_impl``).  ``loss`` and
``prefill`` are ``None`` until the training and prefill paths are ported;
every other family raises ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, Optional

from ..configs.base import ArchConfig
from . import moe
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
    if fam in ("ssm", "hybrid", "encdec", "audio"):
        raise NotImplementedError(
            f"model family {fam!r} ({cfg.name}) is not in repro_torch yet; "
            f"only the dense/vlm and moe decode paths are")
    raise ValueError(f"unknown family {fam}")
