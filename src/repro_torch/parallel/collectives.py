"""Distributed-optimization collectives, and the host staging of gloo.

``compressed_grad_mean``: an int8-quantized gradient mean with
error-feedback residuals.  At 1000+ nodes the pod-crossing gradient
all-reduce is the slowest collective in the step; quantizing to int8 cuts
its bytes 4x (bf16) / 8x (float32).  Error feedback keeps the *accumulated*
quantization error bounded: each step's residual is added back before the
next quantization, so the compressed trajectory tracks the exact one
(Seide et al.; Karimireddy et al.).  The arithmetic is the JAX package's:
a per-tensor max-abs scale in float32, round half to even, clip to +-127, a
float32 all-reduce of ``q * scale`` divided by the group's size, and the
residual ``x - deq`` exactly.  The group is a ``torch.distributed``
process group that the caller hands in.

``through_host`` is the one place where a collective is staged through
host memory: the gloo backend carries tensors on the card for
``all_reduce`` and ``broadcast`` only, so point-to-point, reduce-scatter
and all-gather of CUDA tensors over gloo (several ranks on one card, which
NCCL refuses) copy to the host and back.  ``STAGED`` counts those bytes,
a backward's too.

The collectives a model runs under a mesh are autograd functions:
``all_gather_dim`` and ``reduce_scatter_dim``, each the other's gradient;
``all_reduce_sum`` (the loss, the load-balancing loss, the row-parallel
end of a tensor-parallel layer), whose gradient passes through;
``summed_grads``, the identity whose gradient is summed over the ranks
that share a leaf; and ``all_reduce_max``, outside autograd (the shift of
the vocabulary-parallel logsumexp, which takes no gradient).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Dict, Sequence, Tuple

import torch
import torch.distributed as dist

# bytes copied between the card and the host for gloo, in this process
STAGED: Dict[str, int] = {"bytes": 0}
# through_host's host buffers, per thread (the autograd engine's own for
# a backward), by (role, index): each one buffer grown to the largest
# tensor staged there, viewed as each call's shape -- a pass stages the
# same few shapes layer after layer, and a fresh buffer costs its page
# faults or its page-locking every time
_HOST = threading.local()
_EVERY_THREAD: list = []         # each thread's dict of buffers
_LOCK = threading.Lock()


def _host_buffer(role: str, i: int, t: torch.Tensor) -> torch.Tensor:
    """A host tensor of ``t``'s shape and dtype in this thread's buffer
    ``(role, i)``, page-locked where a card is present; valid until the
    next call for the same buffer in this thread."""
    held = getattr(_HOST, "buffers", None)
    if held is None:
        held = _HOST.buffers = {}
        with _LOCK:
            _EVERY_THREAD.append(held)
    n = t.numel() * t.element_size()
    buf = held.get((role, i))
    if buf is None or buf.numel() < n:
        held.pop((role, i), None)          # freed before the larger one
        buf = held[(role, i)] = torch.empty(
            n, dtype=torch.uint8, pin_memory=torch.cuda.is_available())
    return buf[:n].view(t.dtype).view(t.shape)


def host_buffer_bytes() -> int:
    """The bytes of every thread's host buffers of :func:`through_host`:
    in each thread, role and index, the largest tensor staged there."""
    with _LOCK:
        return sum(b.numel() for held in _EVERY_THREAD
                   for b in list(held.values()))


def release_host_buffers() -> None:
    """Free every thread's host buffers (at a world's end)."""
    with _LOCK:
        for held in _EVERY_THREAD:
            held.clear()


@contextmanager
def through_host(group, reads: Sequence[torch.Tensor] = (),
                 writes: Sequence[torch.Tensor] = ()):
    """Yield ``(reads, writes)`` as tensors the group's backend can carry:
    host copies of ``reads`` and host buffers for ``writes`` where the
    backend is gloo and a tensor lies on the card (copied back into
    ``writes`` on exit), else the tensors themselves.  The host buffers
    are this thread's, page-locked and reused by the next call
    (:func:`_host_buffer`): what the caller is yielded is valid until it
    returns."""
    tensors = (*reads, *writes)
    if dist.get_backend(group) != "gloo" or not any(t.is_cuda
                                                    for t in tensors):
        yield tuple(reads), tuple(writes)
        return
    host_reads = tuple(_host_buffer("r", i, t).copy_(t)
                       for i, t in enumerate(reads))
    host_writes = tuple(_host_buffer("w", i, t)
                        for i, t in enumerate(writes))
    yield host_reads, host_writes
    for t, h in zip(writes, host_writes):
        t.copy_(h)
    STAGED["bytes"] += sum(t.numel() * t.element_size() for t in tensors)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, scale float32)``: ``scale = max(max|x|, 1e-12) / 127``,
    ``q = clip(round(x / scale), -127, 127)``, round half to even."""
    x = x.float()
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum_leaf(x: torch.Tensor, residual: torch.Tensor, group
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One error-feedback compressed all-reduce step for one tensor over
    ``group``: ``(mean, new_residual)``, both float32."""
    x = x.float() + residual
    q, scale = quantize_int8(x)
    summed = q.float() * scale
    dist.all_reduce(summed, group=group)
    mean = summed / float(dist.get_world_size(group))
    return mean, x - dequantize_int8(q, scale)


def compressed_grad_mean(grads: Any, residuals: Any, group
                         ) -> Tuple[Any, Any]:
    """Error-feedback int8 mean of gradients over ``group``.

    ``grads``/``residuals``: nested dicts of this rank's partial gradients
    and its float32 residuals (zeros at the first step).  Returns
    ``(mean_grads, new_residuals)`` as the same nesting, float32."""
    if isinstance(grads, dict):
        pairs = {k: compressed_grad_mean(g, residuals[k], group)
                 for k, g in grads.items()}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    return compressed_psum_leaf(grads, residuals, group)


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((dist.get_world_size(group) * src.shape[0],)
                      + src.shape[1:], dtype=x.dtype, device=x.device)
    with through_host(group, reads=[src], writes=[out]) as ((a,), (b,)):
        dist.all_gather_into_tensor(b, a, group=group)
    # laid out as a tensor of that shape computed in one process: a sum
    # over the last dim (a norm) or a product then takes the same order
    return out.movedim(0, dim).contiguous()


def _scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    src = x.movedim(dim, 0).contiguous()
    n = dist.get_world_size(group)
    out = torch.empty((src.shape[0] // n,) + src.shape[1:], dtype=x.dtype,
                      device=x.device)
    with through_host(group, reads=[src], writes=[out]) as ((a,), (b,)):
        dist.reduce_scatter_tensor(b, a, group=group)
    return out.movedim(0, dim).contiguous()


class _AllGatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, sum_dtype):
        ctx.dim, ctx.group, ctx.sum_dtype = dim, group, sum_dtype
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, ct):
        if ctx.sum_dtype is None or ct.dtype == ctx.sum_dtype:
            return _scatter(ct, ctx.dim, ctx.group), None, None, None
        return (_scatter(ct.to(ctx.sum_dtype), ctx.dim, ctx.group)
                .to(ct.dtype), None, None, None)


class _ReduceScatterDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter(x, dim, group)

    @staticmethod
    def backward(ctx, ct):
        return _gather(ct, ctx.dim, ctx.group), None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        ct = ct.contiguous().clone()
        for g in ctx.groups:
            dist.all_reduce(ct, group=g)
        return ct, None


def all_gather_dim(x: torch.Tensor, dim: int, group,
                   sum_dtype: torch.dtype = None) -> torch.Tensor:
    """The group's tensors joined along ``dim`` in rank order (the JAX
    package's tiled ``all_gather``).  Its gradient is the reduce-scatter
    of the output's: each rank's block gets the sum over the group, taken
    in ``sum_dtype`` where given (the ranks' partial cotangents of a
    bfloat16 activation summed in float32) and cast back."""
    return _AllGatherDim.apply(x, dim, group, sum_dtype)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group of ``x``, of which rank ``r`` keeps block
    ``r`` of ``dim`` (the JAX package's tiled ``psum_scatter``).  Its
    gradient is the all-gather of the output's."""
    return _ReduceScatterDim.apply(x, dim, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group, a new tensor.  Its gradient passes
    through unchanged: what follows the sum is the same in every rank, so
    each rank's ``x`` takes the gradient of the one sum (the loss and the
    load-balancing loss)."""
    return _AllReduceSum.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over the group, a new tensor outside
    autograd."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def summed_grads(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """``x`` itself in the forward; in the backward its gradient summed
    over every group of ``groups``: a leaf that is whole in each rank of a
    group whose ranks each see only their share of the tokens."""
    if not groups or not x.requires_grad:
        return x
    return _SumGrads.apply(x, tuple(groups))
