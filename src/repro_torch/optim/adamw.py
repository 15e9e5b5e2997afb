"""AdamW with a cosine schedule and global-norm clipping, written by hand.

The JAX package's ``optim/adamw.py`` is a pure-pytree optimizer; this one
keeps its state as the same structure -- ``AdamWState(step, m, v,
master)``, each of ``m``, ``v`` and ``master`` a tree like the parameters
-- so that the two compare leaf by leaf and a checkpoint of either names
the same leaves.  ``torch.optim.AdamW`` keeps its state per parameter
object and would not.

Every number is float32 as in the JAX package: the schedule (``step``
cast to float32 before ``step / warmup``), the global norm, the clip
scale, the bias corrections, the moments (stored in ``moment_dtype``) and
the float32 master copy, from which the parameters are cast back to their
own dtype.  :func:`update` writes the new moments, master and parameters
**in place** into the tensors it was given (under ``torch.no_grad``) and
returns them in the structures the JAX package returns: the state of a
full-width model is then held once, not twice.

``zero1_specs`` gives the state's partition specs (ZeRO-1: the state
inherits the parameters' specs), as in the JAX package.  A state cut
beyond its weight -- the dry-run's opt specs cut every leaf over the data
axes, the weights of a small model only over ``model`` -- is given as a
tree of cuts (``parallel.hints.state_layout``: ``take`` a rank's block of
a tensor shaped like its weight, ``put`` the weight back from every
rank's block): :func:`init` keeps the rank's block of each moment and
master, :func:`update` its block of each gradient, and the new weight is
gathered from the ranks' blocks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch

Params = Dict[str, Any]


class AdamWState(NamedTuple):
    step: torch.Tensor   # 0-d int32
    m: Any
    v: Any
    master: Any          # float32 master copy of every parameter


@dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same shape."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, in key order."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [tree]


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``lr_peak``, then a cosine down to ``lr_min`` at
    ``total_steps``; float32, from an integer ``step`` tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _no_cuts(params: Params) -> Any:
    return tree_map(lambda p: None, params)


def init(params: Params, moment_dtype=torch.float32, cuts=None
         ) -> AdamWState:
    """Zero moments in ``moment_dtype`` (bfloat16 halves their memory; the
    master copy stays float32) and a float32 master copy of every leaf,
    on the parameters' device; with ``cuts`` (module docstring) of this
    rank's block of each leaf where its cut is given."""
    def block(p, c):
        return p.detach() if c is None else c.take(p.detach())

    def zeros(p, c):
        return torch.zeros(block(p, c).shape, dtype=moment_dtype,
                           device=p.device)

    cuts = _no_cuts(params) if cuts is None else cuts
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32,
                         device=tree_leaves(params)[0].device),
        m=tree_map(zeros, params, cuts), v=tree_map(zeros, params, cuts),
        master=tree_map(lambda p, c: block(p, c).to(torch.float32,
                                                    copy=True),
                        params, cuts))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Params, state: AdamWState,
           params: Params, gnorm=None, cuts=None
           ) -> Tuple[Params, AdamWState]:
    """One AdamW step: clip ``grads`` by their global norm (``gnorm``
    where the caller gives it: the norm over every rank of a model whose
    leaves are cut over ranks), update the moments and the master copy,
    cast the master back into ``params``.  Every tensor of ``state`` and
    ``params`` is updated in place; returns ``(params, AdamWState(step +
    1, m, v, master))``.  With ``cuts`` (module docstring) a leaf's state
    is this rank's block of it: the update takes that block of the
    gradient, and the weight is gathered from every rank's new block
    (cast to the weight's dtype first)."""
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=stepf.device), stepf)

    def upd(g, m, v, master, p, cut):
        if cut is not None:
            g = cut.take(g)
        if g.shape != master.shape:
            raise ValueError(f"a state of {tuple(master.shape)} for a "
                             f"gradient block of {tuple(g.shape)}: the "
                             f"state is cut as the cuts given say")
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        mh, vh = m32 / b1c, v32 / b2c
        m.copy_(m32)
        v.copy_(v32)
        # each float32 temporary of the leaf freed as soon as it is spent:
        # a full-width leaf's take several GB
        del g, m32, v32
        master.copy_(master - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                                    + cfg.weight_decay * master))
        del mh, vh
        p.copy_(master if cut is None else cut.put(master.to(p.dtype)))
        return p

    cuts = _no_cuts(params) if cuts is None else cuts
    params = tree_map(upd, grads, state.m, state.v, state.master, params,
                      cuts)
    return params, AdamWState(step, state.m, state.v, state.master)


def zero1_specs(pspecs: Any) -> AdamWState:
    """Optimizer-state specs (``parallel.sharding.PartitionSpec`` trees):
    m, v and master inherit the parameters' specs (already model- and
    possibly data-cut; the moments never need gathering, so inheriting is
    enough for any mesh), and ``step`` is replicated."""
    from ..parallel.sharding import PartitionSpec

    return AdamWState(step=PartitionSpec(), m=pspecs,
                      v=tree_map(lambda s: s, pspecs), master=pspecs)
