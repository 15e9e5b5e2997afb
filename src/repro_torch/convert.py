"""Carry parameters of the JAX package over into this one.

The JAX package keeps a model's parameters as a pytree: nested dicts of
arrays, layer tensors stacked on a leading ``L`` axis.  This package keeps
the same tree with ``torch`` tensors at the leaves, so weights map one to
one.  Hand :func:`params_from_numpy` the tree converted to numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)`` on the caller's side: this
module never sees a ``jax`` array type).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .device import resolve_device


def tensor_from_numpy(a, device="cuda", dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """One array -> tensor on ``device``.  bfloat16 arrives from JAX as an
    ``ml_dtypes`` numpy type that ``torch.from_numpy`` refuses; it goes
    through float32, which holds every bfloat16 value exactly, and comes
    back as ``torch.bfloat16`` unless ``dtype`` says otherwise."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a.astype(np.float32)))
        return t.to(device=device, dtype=dtype or torch.bfloat16)
    t = torch.from_numpy(np.array(a))    # a copy: arrays from JAX are read-only
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree: Dict[str, Any], device="cuda",
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Nested dicts of numpy arrays -> the same nesting of tensors on
    ``device``.  ``dtype`` overrides the floating-point leaves' type
    (integer leaves keep theirs); the default keeps every leaf's own."""
    device = resolve_device(device)
    out: Dict[str, Any] = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = params_from_numpy(leaf, device, dtype)
            continue
        a = np.asarray(leaf)
        floating = a.dtype.name == "bfloat16" or a.dtype.kind == "f"
        out[name] = tensor_from_numpy(a, device, dtype if floating else None)
    return out


def for_ranks(tree: Dict[str, Any], *, stages: Optional[int] = None,
              experts: Optional[Tuple[int, int]] = None) -> Dict[str, Any]:
    """A layer tree cut for a world of processes; numpy arrays or tensors,
    cut as views where the leaves allow.

    ``stages=S``: every ``(L, ...)`` stack becomes stage-major ``(S, L/S,
    ...)``, what ``parallel.pipeline.pipeline_apply`` takes.
    ``experts=(rank, n)``: every expert stack (``we_*``, experts on dim -3)
    keeps the ``rank``-th of ``n`` equal blocks of experts, what a rank of
    a ``model`` axis of ``n`` holds in ``models.moe.moe_ffn_a2a``."""
    out: Dict[str, Any] = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = for_ranks(leaf, stages=stages, experts=experts)
            continue
        if stages is not None:
            L = leaf.shape[0]
            if L % stages:
                raise ValueError(f"{name}: {L} layers in {stages} stages")
            leaf = leaf.reshape((stages, L // stages) + tuple(leaf.shape[1:]))
        if experts is not None and name.startswith("we_"):
            rank, n = experts
            E = leaf.shape[-3]
            if E % n:
                raise ValueError(f"{name}: {E} experts over {n} ranks")
            blk = E // n
            leaf = leaf[..., rank * blk:(rank + 1) * blk, :, :]
        out[name] = leaf
    return out
