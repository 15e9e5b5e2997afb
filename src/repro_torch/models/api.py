"""Family dispatch: one uniform Model interface over the architectures.

``get_model(cfg)`` returns a ``Model`` with:

* ``init(generator, device=..., dtype=...)`` -> params
* ``decode(params, cache, tokens)``          -> (logits, cache)
* ``init_cache(batch, max_len, device=...)`` -> cache

This package holds the dense transformer's decode path so far: ``dense``
and ``vlm`` (chameleon: its VQ image tokens live in the shared vocabulary,
frontend stubbed to token ids).  ``loss`` and ``prefill`` are ``None``
until the training and prefill paths are ported; every other family raises
``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, Optional

from ..configs.base import ArchConfig
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


def get_model(cfg: ArchConfig) -> Model:
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
    if fam in ("moe", "ssm", "hybrid", "encdec", "audio"):
        raise NotImplementedError(
            f"model family {fam!r} ({cfg.name}) is not in repro_torch yet; "
            f"only the dense/vlm decode path is")
    raise ValueError(f"unknown family {fam}")
