"""Pipeline parallelism (GPipe schedule) over point-to-point sends.

An optional distribution mode: layers are split into S contiguous stages,
one a rank of a process group; microbatches stream through with the
classic (M + S - 1)-tick schedule.  Activations hop to the next stage's
rank point to point (the JAX package's ``ppermute``), and the last stage's
outputs reach every rank by a broadcast from it (the JAX package's
``psum`` of outputs that only the last stage wrote).

Generic as in the JAX package: ``stage_fn(stage_params, x)`` applies one
stage's layer stack, and the caller hands stage-major parameters (the
``(L, ...)`` stacks reshaped to ``(S, L/S, ...)``: ``convert.for_ranks``).
A stage computes only on the ticks that carry a microbatch; the JAX
package also runs its bubbles on zeros, whose results no stage emits.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from .collectives import through_host


def _stage(tree: Any, s: int) -> Any:
    if isinstance(tree, dict):
        return {k: _stage(v, s) for k, v in tree.items()}
    return tree[s]


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any,       # leaves (S, ...) -- stage-major
                   x: torch.Tensor,         # (M, mb, ...) microbatched input
                   group=None) -> torch.Tensor:
    """Run a GPipe pipeline over the ranks of ``group`` (the default group
    when None), stage ``s`` on the group's rank ``s``.  Every rank passes
    the same ``x``; only stage 0 reads it.  Returns ``(M, mb, ...)`` on
    every rank."""
    group = group if group is not None else dist.group.WORLD
    S = dist.get_world_size(group)
    s = dist.get_rank(group)
    M = x.shape[0]
    params = _stage(stage_params, s)
    outs = torch.zeros_like(x)
    prev = dist.get_global_rank(group, s - 1) if s > 0 else None
    nxt = dist.get_global_rank(group, s + 1) if s < S - 1 else None
    for t in range(M + S - 1):
        m = t - s                       # the microbatch at this stage now
        if not 0 <= m < M:
            continue
        if s == 0:
            h_in = x[m]
        else:
            h_in = torch.empty_like(x[m])
            with through_host(group, writes=[h_in]) as (_, (buf,)):
                dist.recv(buf, src=prev, group=group)
        h_out = stage_fn(params, h_in).to(x.dtype)
        if nxt is not None:
            with through_host(group, reads=[h_out]) as ((buf,), _):
                dist.send(buf, dst=nxt, group=group)
        else:
            outs[m] = h_out
    dist.broadcast(outs, src=dist.get_global_rank(group, S - 1), group=group)
    return outs
