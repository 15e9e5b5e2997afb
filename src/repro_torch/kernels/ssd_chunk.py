"""One chunk of the Mamba2 SSD scan, as a CUDA kernel with its plain torch
version.

For every (batch, head), with ``x (Q, P)``, ``dt`` and ``cum (Q,)`` (the
running log-decay within the chunk), ``B`` and ``C (Q, N)`` shared by the
heads of a batch row, and the carried state ``S_prev (P, N)``::

    L[i, j] = exp(cum_i - cum_j)  for i >= j, else 0 (masked before exp)
    y       = ((C B^T) o L) (dt o x) + exp(cum) o (C S_prev^T)
    S_new   = exp(cum_last) S_prev + ((dt o x) o exp(cum_last - cum))^T B

:func:`ssd_chunk` replaces the Pallas TPU kernel of the same name in the JAX
package's ``kernels/ssd_chunk.py``.  The scan across chunks, which carries
``S``, stays in the model (``models/ssm.py``).

The wrapper launches ``csrc/ssd_chunk.cu`` when ``x`` lies on a CUDA device
(and raises if the build, the arguments or the launch are not right --
nothing falls back), and takes :func:`ssd_chunk_plain` only because ``x``
lies on the CPU.  ``LAUNCHES`` counts kernel launches, nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

LAUNCHES: Dict[str, int] = {"ssd_chunk": 0}

# what the kernel's shared-memory tiles hold (csrc/ssd_chunk.cu)
MAX_P, MAX_N = 64, 128


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_lib = None


def _library():
    """The compiled kernel, built at first use; raises when it cannot be
    built."""
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("ssd_chunk")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.sc_ssd_chunk.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
        lib.sc_ssd_chunk.restype = ctypes.c_int
        _lib = lib
    return _lib


def ssd_chunk_plain(x, dt, bm, cm, cum, s_prev
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`ssd_chunk`, in the direct form of the
    JAX package's ``ref.ssd_chunk_reference``.  Materialises the
    ``(B, H, Q, Q)`` decay and score matrices."""
    Q = x.shape[2]
    rel = cum[..., :, None] - cum[..., None, :]               # (B, H, Q, Q)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    Lmat = torch.exp(rel.masked_fill(~causal, float("-inf")))  # mask, then exp
    scores = torch.einsum("bin,bjn->bij", cm, bm)
    W = scores[:, None] * Lmat
    xdt = x * dt[..., None]
    y_intra = torch.einsum("bhij,bhjp->bhip", W, xdt)
    y_inter = torch.exp(cum)[..., None] * torch.einsum(
        "bin,bhpn->bhip", cm, s_prev)
    decay_to_end = torch.exp(cum[..., -1:] - cum)              # (B, H, Q)
    s_add = torch.einsum("bhqp,bqn,bhq->bhpn", xdt, bm, decay_to_end)
    s_new = torch.exp(cum[..., -1])[..., None, None] * s_prev + s_add
    return y_intra + y_inter, s_new


def _check(x, dt, bm, cm, cum, s_prev):
    named = {"x": x, "dt": dt, "bm": bm, "cm": cm, "cum": cum,
             "s_prev": s_prev}
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, "
                            f"got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} lies on {t.device}, x on {x.device}")
    if x.ndim != 4:
        raise ValueError(f"x must be (B, H, Q, P), got {tuple(x.shape)}")
    B, H, Q, P = x.shape
    N = bm.shape[-1] if bm.ndim == 3 else -1
    want = {"dt": (B, H, Q), "cum": (B, H, Q), "bm": (B, Q, N),
            "cm": (B, Q, N), "s_prev": (B, H, P, N)}
    for name, shape in want.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"{name} must be {shape} for x {tuple(x.shape)}, "
                             f"got {tuple(named[name].shape)}")
    if Q < 1:
        raise ValueError("a chunk needs at least one row (Q >= 1)")
    return B, H, Q, P, N


def ssd_chunk(x, dt, bm, cm, cum, s_prev
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One SSD chunk for all (batch, head) pairs, float32.

    x: ``(B, H, Q, P)``; dt, cum: ``(B, H, Q)``; bm, cm: ``(B, Q, N)``;
    s_prev: ``(B, H, P, N)``.  Returns ``(y (B, H, Q, P), s_new (B, H, P,
    N))``.  On a CUDA tensor: one launch of ``sc_ssd_chunk``, which takes
    any ``Q`` and ``P <= 64``, ``N <= 128``."""
    B, H, Q, P, N = _check(x, dt, bm, cm, cum, s_prev)
    if not x.is_cuda:
        return ssd_chunk_plain(x, dt, bm, cm, cum, s_prev)
    if P > MAX_P or N > MAX_N:
        raise ValueError(f"the ssd_chunk kernel takes P <= {MAX_P} and "
                         f"N <= {MAX_N}, got P={P}, N={N}")
    args = [t.contiguous() for t in (x, dt, bm, cm, cum, s_prev)]
    y = torch.empty((B, H, Q, P), dtype=torch.float32, device=x.device)
    s_new = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.sc_ssd_chunk(
            *(t.data_ptr() for t in args), y.data_ptr(), s_new.data_ptr(),
            B, H, Q, P, N, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk: CUDA launch failed with error {err}")
    LAUNCHES["ssd_chunk"] += 1
    return y, s_new
