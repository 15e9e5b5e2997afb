"""MoE dispatch: the token -> expert crossbar, as a CUDA kernel with its
plain torch version.

Expert routing is the paper's banking problem with experts as banks and
capacity as ports.  After the router and the sort (``models/moe.py``
computes ``slot_token``: for every (expert, capacity) slot, which token
fills it, or ``T`` for an empty slot) this kernel materialises the
``(E*C, D)`` expert input buffer:

* :func:`moe_dispatch` -- ``out[s, :] = x_padded[slot_token[s], :]``, where
  row ``T`` of ``x_padded`` is zeros; it replaces the Pallas TPU kernel of
  the same name in the JAX package's ``kernels/moe_dispatch.py``.
* :func:`moe_combine` -- the weighted scatter-add back to the tokens.  It
  is plain ``jnp`` in the JAX package and plain torch here, not a kernel.

The wrapper launches ``csrc/moe_dispatch.cu`` when ``x_padded`` lies on a
CUDA device (and raises if the build, the arguments or the launch are not
right -- nothing falls back), and takes :func:`moe_dispatch_plain` only
because ``x_padded`` lies on the CPU.  ``LAUNCHES`` counts kernel launches,
nothing else.

Indices that arrive on the host (numpy, lists, CPU tensors) are
range-checked and raise ``IndexError``; indices that already lie on the
card are not inspected, since that would synchronize, and the kernel
writes a zero row for one that is out of range.

The gradient: :class:`DispatchFn`, which ``ops.dispatch`` calls, runs
:func:`moe_dispatch` forward and :func:`moe_dispatch_backward` -- each
row's slot gradients summed in a fixed order, in torch ops -- backward.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .banked_gather import as_index

LAUNCHES: Dict[str, int] = {"moe_dispatch": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_lib = None


def _bind(lib) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.md_dispatch.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.md_dispatch.restype = ctypes.c_int


def _library():
    """The compiled kernel, built at first use; raises when it cannot be
    built."""
    global _lib
    if _lib is None:
        from . import _build

        _lib = _build.load("moe_dispatch", _bind)
    return _lib


def moe_dispatch_plain(x_padded: torch.Tensor,
                       slot_token: torch.Tensor) -> torch.Tensor:
    """Plain torch version of :func:`moe_dispatch`: one indexing."""
    return x_padded[slot_token.to(torch.int64)]


def moe_dispatch(x_padded: torch.Tensor, slot_token) -> torch.Tensor:
    """x_padded: ``(T+1, D)`` tokens with a zeros row at index ``T``;
    slot_token: ``(E*C,)`` source token per slot (``T`` = empty).  Returns
    the ``(E*C, D)`` expert input buffer.

    On a CUDA tensor: one launch of ``md_dispatch`` -- a warp per slot, or
    per piece of its row when the slots are too few to fill the card, the
    row copied as bytes in up to 16-byte loads."""
    if not isinstance(x_padded, torch.Tensor):
        raise TypeError(f"x_padded must be a torch.Tensor, "
                        f"got {type(x_padded).__name__}")
    if x_padded.ndim != 2:
        raise ValueError(f"x_padded must be (T+1, D), "
                         f"got {tuple(x_padded.shape)}")
    rows = x_padded.shape[0]
    idx = as_index(slot_token, x_padded.device, rows, "slot_token")
    if idx.ndim != 1:
        raise ValueError(f"slot_token must be (E*C,), got {tuple(idx.shape)}")
    if not x_padded.is_cuda:
        return moe_dispatch_plain(x_padded, idx)
    x = x_padded.contiguous()
    S, D = idx.shape[0], x.shape[1]
    if max(rows, S, D * x.element_size()) >= 1 << 31:
        raise ValueError(f"the dispatch kernel counts rows, slots and row "
                         f"bytes in int32: {tuple(x.shape)} -> {S} slots")
    out = torch.empty((S, D), dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.md_dispatch(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), S, rows,
            D * x.element_size(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_dispatch: CUDA launch failed with error "
                           f"{err}")
    LAUNCHES["moe_dispatch"] += 1
    return out


def moe_dispatch_backward(dout: torch.Tensor, slot_token: torch.Tensor,
                          rows: int) -> torch.Tensor:
    """The gradient of :func:`moe_dispatch` with respect to ``x_padded``
    (``rows`` of them) for ``dout (S, D)``: row ``t`` gets the sum of the
    gradients of the slots that read it (a token fills up to ``top_k``
    slots, the zeros row every empty one), in float32, returned in
    ``dout``'s dtype.

    Deterministic, in torch ops, with no atomics and no host
    synchronization: the slots are sorted stably by the row they read, and
    a segmented scan (``log2(S)`` passes, each adding the partial sum
    ``2^k`` places back where it lies in the same row) sums each row's
    slots in a fixed order; a row's sum is its last slot's entry.  A float
    ``index_add_`` would add in an order that changes from run to run on
    the card."""
    S, D = dout.shape
    idx = slot_token.to(torch.int64)
    order = torch.argsort(idx, stable=True)
    seg = idx[order]
    acc = dout[order].float()
    step = 1
    while step < S:
        same = (seg[step:] == seg[:-step])[:, None]
        acc = torch.cat([acc[:step],
                         torch.where(same, acc[step:] + acc[:-step],
                                     acc[step:])])
        step *= 2
    want = torch.arange(rows, device=dout.device)
    last = torch.searchsorted(seg, want, right=True) - 1
    read = (last >= 0) & (seg[last.clamp(min=0)] == want)
    grad = torch.where(read[:, None], acc[last.clamp(min=0)], 0.0)
    return grad.to(dout.dtype)


class DispatchFn(torch.autograd.Function):
    """:func:`moe_dispatch` with its gradient: the forward is the wrapper as
    it is (the kernel on a CUDA tensor, the plain version on the CPU), the
    backward :func:`moe_dispatch_backward`.  ``kernels.ops.dispatch`` calls
    it; the zeros row's gradient is then dropped by the backward of the
    ``F.pad`` that appended the row."""

    @staticmethod
    def forward(ctx, x_padded, slot_token):
        out = moe_dispatch(x_padded, slot_token)
        ctx.save_for_backward(as_index(slot_token, x_padded.device,
                                       x_padded.shape[0], "slot_token"))
        ctx.rows = x_padded.shape[0]
        return out

    @staticmethod
    def backward(ctx, dout):
        slot_token, = ctx.saved_tensors
        return moe_dispatch_backward(dout, slot_token, ctx.rows), None


def moe_combine(y_buf: torch.Tensor, slot_token: torch.Tensor,
                weights: torch.Tensor, T: int) -> torch.Tensor:
    """Weighted scatter-add back to tokens, in float32.

    y_buf: ``(E*C, D)``; slot_token: ``(E*C,)`` in ``[0, T]``; weights:
    ``(E*C,)``.  Empty slots (``T``) add into a spare row that is dropped.
    On a CUDA tensor ``index_add_`` adds with atomics, so the order of the
    adds, and the rounding, may change from run to run; the MoE layer sums
    a token's contributions in a fixed order instead (``models/moe.py``)."""
    contrib = y_buf.float() * weights.float()[:, None]
    out = torch.zeros((T + 1, y_buf.shape[1]), dtype=torch.float32,
                      device=y_buf.device)
    out.index_add_(0, slot_token.to(torch.int64), contrib)
    return out[:T]
