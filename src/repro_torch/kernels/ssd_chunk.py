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

The kernel runs its products on the tensor cores in 3xTF32 (each operand
split into two TF32 parts, three products, float32 sums: near float32),
forms ``C B^T`` once per batch row for all its heads, and reads its inputs
through their strides: ``models/ssm.py`` hands it views of each chunk as
they lie and a view of the whole scan's output to write ``y`` into.  An x,
B, C or S_prev whose rows the kernel cannot copy in 16-byte pieces (a last
dimension that is not unit-stride, a start or a stride off 16 bytes; dt
and cum are read through any strides) is copied once by
:func:`kernel_operands`; ``COPIES`` counts the calls that made such a
copy.  No model's chunk needs one.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

LAUNCHES: Dict[str, int] = {"ssd_chunk": 0}
COPIES: Dict[str, int] = {"ssd_chunk": 0}     # calls with a copied input

# what the kernel takes (csrc/ssd_chunk.cu): one 64-column tile of P, N in
# k tiles of 64
MAX_P, MAX_N = 64, 128


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, COPIES):
        for k in counts:
            counts[k] = 0


_lib = None


def _bind(lib) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sc_ssd_chunk.argtypes = [ptr] * 9 + [i32] * 5 + [ptr, ptr]
    lib.sc_ssd_chunk.restype = ctypes.c_int
    lib.sc_scratch_floats.argtypes = [i32, i32]
    lib.sc_scratch_floats.restype = ctypes.c_longlong
    lib.sc_kernel_info.argtypes = [ctypes.POINTER(i32)] * 3
    lib.sc_kernel_info.restype = ctypes.c_int


def _library():
    """The compiled kernel, built at first use; raises when it cannot be
    built."""
    global _lib
    if _lib is None:
        from . import _build

        _lib = _build.load("ssd_chunk", _bind)
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


def _check(x, dt, bm, cm, cum, s_prev, out=None):
    named = {"x": x, "dt": dt, "bm": bm, "cm": cm, "cum": cum,
             "s_prev": s_prev}
    if out is not None:
        named["out"] = out
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
            "cm": (B, Q, N), "s_prev": (B, H, P, N), "out": (B, H, Q, P)}
    for name, t in named.items():
        if name != "x" and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]} for x "
                             f"{tuple(x.shape)}, got {tuple(t.shape)}")
    if Q < 1:
        raise ValueError("a chunk needs at least one row (Q >= 1)")
    return B, H, Q, P, N


def _readable(t: torch.Tensor) -> bool:
    """Whether the kernel reads ``t`` as it lies: a unit-stride last
    dimension, and every row starting on 16 bytes (an aligned start, the
    other strides multiples of 4 floats)."""
    return ((t.stride(-1) == 1 or t.shape[-1] == 1)
            and t.data_ptr() % 16 == 0
            and all(s % 4 == 0 for s in t.stride()[:-1]))


def kernel_operands(x, dt, bm, cm, cum, s_prev):
    """``([x, dt, bm, cm, cum, s_prev], copied)`` as the kernel reads them:
    an x, bm, cm or s_prev it cannot read as it lies (see
    :func:`_readable`) is copied once into a fresh tensor whose last
    dimension is padded to a multiple of 4 (and sliced back), so its rows
    start on 16 bytes; dt and cum are read through any strides and never
    copied.  Pure torch, on any device."""
    out, copied = [], False
    for name, t in zip(("x", "dt", "bm", "cm", "cum", "s_prev"),
                       (x, dt, bm, cm, cum, s_prev)):
        if name not in ("dt", "cum") and not _readable(t):
            n = t.shape[-1]
            c = t.new_zeros(t.shape[:-1] + (-(-n // 4) * 4,))
            c[..., :n] = t
            t, copied = c[..., :n], True
        out.append(t)
    return out, copied


def ssd_chunk(x, dt, bm, cm, cum, s_prev, out=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One SSD chunk for all (batch, head) pairs, float32.

    x: ``(B, H, Q, P)``; dt, cum: ``(B, H, Q)``; bm, cm: ``(B, Q, N)``;
    s_prev: ``(B, H, P, N)``, any strides.  Returns ``(y (B, H, Q, P),
    s_new (B, H, P, N))``; ``y`` is written into ``out`` (a ``(B, H, Q,
    P)`` view with a unit-stride last dimension) when it is given.  On a
    CUDA tensor: one launch of ``sc_ssd_chunk``, which takes any ``Q`` and
    ``P <= 64``, ``N <= 128``."""
    B, H, Q, P, N = _check(x, dt, bm, cm, cum, s_prev, out)
    if not x.is_cuda:
        y, s_new = ssd_chunk_plain(x, dt, bm, cm, cum, s_prev)
        if out is None:
            return y, s_new
        out.copy_(y)
        return out, s_new
    if P > MAX_P or N > MAX_N:
        raise ValueError(f"the ssd_chunk kernel takes P <= {MAX_P} and "
                         f"N <= {MAX_N}, got P={P}, N={N}")
    if out is not None and out.stride(-1) != 1 and P > 1:
        raise ValueError("out needs a unit-stride last dimension")
    args, copied = kernel_operands(x, dt, bm, cm, cum, s_prev)
    x, dt, bm, cm, cum, s_prev = args
    y = (torch.empty((B, H, Q, P), dtype=torch.float32, device=x.device)
         if out is None else out)
    s_new = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    lib = _library()
    scratch = torch.empty(lib.sc_scratch_floats(B, Q), dtype=torch.float32,
                          device=x.device)
    strides = (ctypes.c_longlong * 19)(
        *x.stride()[:3], *dt.stride(), *bm.stride()[:2], *cm.stride()[:2],
        *cum.stride(), *s_prev.stride()[:3], *y.stride()[:3])
    with torch.cuda.device(x.device):
        err = lib.sc_ssd_chunk(
            *(t.data_ptr() for t in args), y.data_ptr(), s_new.data_ptr(),
            scratch.data_ptr(), B, H, Q, P, N, strides,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk: CUDA launch failed with error {err}")
    LAUNCHES["ssd_chunk"] += 1
    if copied:
        COPIES["ssd_chunk"] += 1
    return y, s_new


def kernel_info() -> Dict[str, int]:
    """Registers a thread, dynamic shared memory (bytes) and blocks
    resident on one SM of the kernel, as the CUDA runtime reports them;
    needs a card."""
    lib = _library()
    vals = [ctypes.c_int() for _ in range(3)]
    err = lib.sc_kernel_info(*(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"sc_kernel_info failed with error {err}")
    return dict(zip(("registers", "shared_bytes", "blocks_per_sm"),
                    (v.value for v in vals)))
