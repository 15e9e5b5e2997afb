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
              experts: Optional[Tuple[int, int]] = None,
              specs: Optional[Dict[str, Any]] = None, mesh=None,
              coords: Optional[Dict[str, int]] = None,
              head_dim=None) -> Dict[str, Any]:
    """A parameter tree cut for a world of processes; numpy arrays or
    tensors, cut leaf by leaf as views where the leaves allow (hand the
    reference's numpy tree in, then :func:`params_from_numpy`, and a rank
    holds its blocks alone).

    ``stages=S``: every ``(L, ...)`` stack becomes stage-major ``(S, L/S,
    ...)``, what ``parallel.pipeline.pipeline_apply`` takes.
    ``specs``, ``mesh``, ``coords``: this rank's block of every leaf under
    its spec (``parallel.sharding.param_specs``) on ``mesh`` at the rank's
    coordinates (axis name -> index), what a rank of a tensor-parallel
    model holds, cut over ``model`` and, under ZeRO-3, over the data axes
    (``parallel.sharding.rank_blocks``: an attention leaf's block may
    split a head; ``head_dim``, ``parallel.sharding.head_widths(cfg)``,
    turns on the check that a Mamba2 head is not).
    ``experts=(rank, n)``: the expert stacks' specs
    (``parallel.sharding.expert_specs``): every ``we_*`` leaf keeps the
    ``rank``-th of ``n`` equal blocks of experts (dim -3), the rest
    whole, what a rank of a ``model`` axis of ``n`` holds in
    ``models.moe.moe_ffn_a2a``."""
    from .parallel.sharding import expert_specs, leaf_block, mesh_axes

    axes = mesh_axes(mesh) if mesh is not None else None

    def cut(path, leaf, spec):
        name = path.rsplit("/", 1)[-1]
        if stages is not None:
            L = leaf.shape[0]
            if L % stages:
                raise ValueError(f"{name}: {L} layers in {stages} stages")
            leaf = leaf.reshape((stages, L // stages) + tuple(leaf.shape[1:]))
        if experts is not None:
            rank, n = experts
            if name.startswith("we_") and leaf.shape[-3] % n:
                raise ValueError(f"{name}: {leaf.shape[-3]} experts over "
                                 f"{n} ranks")
            leaf = leaf_block(path, leaf, expert_specs({name: leaf})[name],
                              {"model": n}, {"model": rank})
        if spec is not None:
            leaf = leaf_block(path, leaf, spec, axes, coords, head_dim)
        return leaf

    def walk(t, s, prefix):
        return {k: walk(v, None if s is None else s[k],
                        f"{prefix}/{k}" if prefix else k)
                if isinstance(v, dict) else
                cut(f"{prefix}/{k}" if prefix else k, v,
                    None if s is None else s[k])
                for k, v in t.items()}

    return walk(tree, specs, "")


def block_init(specs: Dict[str, Any], mesh, coords: Dict[str, int],
               head_dim=None):
    """The ``keep`` of a model's ``init``: each leaf, as soon as it is
    drawn, replaced by a copy of this rank's block (over ``model`` and the
    data axes alike; ``head_dim`` as in
    :func:`for_ranks`), so that a rank that draws a whole model from a
    seed holds no more than its blocks and one whole leaf.  A whole leaf
    of a full-width model is large (internlm2-20b's ``w_gate`` stack 9.7
    GB in bfloat16): ranks that share a card draw in turn."""
    from .parallel.sharding import leaf_block, mesh_axes

    axes = mesh_axes(mesh)

    def keep(path, leaf):
        spec = specs
        for k in path.split("/"):
            if k not in spec:         # drawn, then dropped by the init
                return leaf
            spec = spec[k]
        block = leaf_block(path, leaf, spec, axes, coords, head_dim)
        return block if block is leaf else block.clone()

    return keep
