"""Attention over a whole prompt (online softmax), as a CUDA kernel with its
plain torch version.

For every (batch, head) and query row ``i``, with ``q`` cast to float32 and
scaled before the product::

    s[i, j] = (q[i] * scale) . k[j]                        float32
    keep    = j < kv_len  and  (causal: j <= i)  and  (window > 0: i - j < window)
    o[i]    = softmax(where(keep, s, -1e30))[i] @ v        cast to q's dtype

Positions count from 0 for q and k alike (there is no query offset).

:func:`flash_attention` replaces the Pallas TPU kernel of the same name in
the JAX package's ``kernels/flash_attention.py`` and keeps its
``(BH, Sq, D)`` signature; :func:`attention` takes the models' ``(B, S, H,
D)`` layout with grouped-query heads (``H`` a multiple of ``Hkv``: query
head ``h`` reads kv head ``h // (H // Hkv)``, nothing is repeated) and is
what ``ops.mha`` calls.  Both are one launch of ``csrc/flash_attention.cu``,
which reads q, k and v through their strides.

**Rows with no unmasked key** (``kv_len < 1``, or a window with ``Sq >
kv_len + window - 1``: they are the last rows) get what the JAX oracle
``ref.mha_reference`` gives them: every score masked to ``-1e30``, its
softmax weighs all ``Sk`` keys alike, so such a row is the mean of v over
all ``Sk`` rows (float32, cast to q's dtype).  The plain version computes
that as it is; on the card the wrapper finds the first such row by integer
arithmetic on ``(Sq, Sk, kv_len, window)`` and only then launches the
small ``fa_blind_rows`` kernel of the same source over those rows, after
the attention kernel over the others (``BLIND_LAUNCHES`` counts those
calls; no model's call has such a row).

The wrappers launch the kernel when q lies on a CUDA device (and raise if
the build, the arguments or the launch are not right -- nothing falls
back), and take :func:`mha_plain` only because q lies on the CPU.
``LAUNCHES`` counts kernel launches, nothing else.

**The aligned copy (bfloat16).**  The bf16 kernel loads its tiles with TMA,
which reads a 16-byte aligned base and strides that are multiples of 16
bytes, and it runs over D in steps of 16.  An input that breaks that (D not
a multiple of 16, a view at an odd offset, an odd stride) is copied once by
:func:`tma_operands` into a fresh contiguous tensor with D zero-padded to a
multiple of 16; the kernel runs on the copies, with the scale of the
original D, and the output is sliced back to D.  ``COPIES`` counts the calls
that made such a copy.  The copy is neither the plain version nor the
float32 kernel, and no model needs it (their head sizes are 64, 80, 128 and
240, their q, k and v views aligned).  float32 takes any D and strides.

**The gradient.**  The Pallas kernel has no backward (the JAX package trains
through ``jnp``), and neither has this one: :class:`AttentionFn`, which
``ops.mha`` calls, runs :func:`attention` forward and
:func:`attention_backward` -- the gradient ``jax.grad`` takes through
``ref.mha_reference``, recomputed over blocks of query rows in float32
torch ops -- backward.  It launches nothing of its own.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

LAUNCHES: Dict[str, int] = {"flash_attention": 0}
COPIES: Dict[str, int] = {"flash_attention": 0}   # calls with an aligned copy
# calls that launched fa_blind_rows (rows that see no key)
BLIND_LAUNCHES: Dict[str, int] = {"flash_attention": 0}

NEG_INF = -1e30
MAX_D = 256          # what the kernel's shared-memory tiles hold
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, COPIES, BLIND_LAUNCHES):
        for k in counts:
            counts[k] = 0


_lib = None


def _bind(lib) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fa_flash_attention.argtypes = (
        [ptr] * 4 + [i32] * 6 + [i64] * 9 + [i32] * 3
        + [ctypes.c_float, i32, ptr])
    lib.fa_flash_attention.restype = ctypes.c_int
    lib.fa_bf16_kernel_info.argtypes = [i32] + [ctypes.POINTER(i32)] * 3
    lib.fa_bf16_kernel_info.restype = ctypes.c_int
    lib.fa_blind_rows.argtypes = (
        [ptr] * 2 + [i32] * 6 + [i64] * 3 + [i32] * 2 + [ptr])
    lib.fa_blind_rows.restype = ctypes.c_int


def _library():
    """The compiled kernel, built at first use; raises when it cannot be
    built."""
    global _lib
    if _lib is None:
        from . import _build

        _lib = _build.load("flash_attention", _bind)
    return _lib


def _mask(Sq, Sk, causal, window, kv_len, device):
    """(Sq, Sk) boolean mask of the keys each query row may see."""
    i = torch.arange(Sq, device=device)[:, None]
    j = torch.arange(Sk, device=device)[None, :]
    keep = j < (Sk if kv_len is None else kv_len)
    if causal:
        keep = keep & (j <= i)
    if window > 0:
        keep = keep & (i - j < window)
    return keep


def mha_plain(q, k, v, *, causal=True, window=0, kv_len=None, scale=None
              ) -> torch.Tensor:
    """Plain torch version of :func:`attention` over ``(B, S, H, D)``, in
    the direct form of the JAX package's ``ref.mha_reference``: the
    ``(B, H, Sq, Sk)`` float32 scores are materialised, masked to ``-1e30``
    and put through ``softmax``.  Query heads are grouped over their kv
    head by a reshape, not a repeat."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    q5 = (q.float() * scale).reshape(B, Sq, Hkv, H // Hkv, D)
    s = torch.einsum("bqhrd,bkhd->bhrqk", q5, k.float())
    keep = _mask(Sq, Sk, causal, int(window), kv_len, q.device)
    p = torch.softmax(s.masked_fill(~keep, NEG_INF), dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", p, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def flash_attention_plain(q, k, v, *, causal=True, window=0, kv_len=None,
                          scale=None) -> torch.Tensor:
    """Plain torch version of :func:`flash_attention` over ``(BH, S, D)``
    (``ref.mha_reference``'s form)."""
    return mha_plain(q[:, :, None], k[:, :, None], v[:, :, None],
                     causal=causal, window=window, kv_len=kv_len,
                     scale=scale)[:, :, 0]


def _check(q, k, v, causal, window, kv_len):
    named = {"q": q, "k": k, "v": v}
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, "
                            f"got {type(t).__name__}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, "
                            f"got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
        if t.ndim != 4:
            raise ValueError(f"{name} must be (B, S, heads, D), got "
                             f"{tuple(t.shape)}")
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Sk, Hkv, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must both be (B, Sk, Hkv, D) = "
                         f"({B}, Sk, Hkv, {D}) for q {tuple(q.shape)}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if min(B, Sq, Sk, H, Hkv, D) < 1:
        raise ValueError(f"every size must be at least 1: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} kv heads")
    if not isinstance(causal, bool):
        raise TypeError(f"causal must be a bool, got {causal!r}")
    if int(window) != window or window < 0:
        raise ValueError(f"window must be an int >= 0, got {window!r}")
    if kv_len is not None and int(kv_len) != kv_len:
        raise ValueError(f"kv_len must be an int or None, got {kv_len!r}")
    seen = Sk if kv_len is None else min(int(kv_len), Sk)
    return B, Sq, H, Hkv, Sk, D, seen


def first_blind_row(Sq: int, seen: int, window: int) -> int:
    """The first query row that sees no key (``Sq`` when every row sees
    one), for ``seen = min(kv_len, Sk)`` keys: row ``i`` sees key ``j`` when
    ``j < seen``, ``j <= i`` if causal and ``i - j < window`` if windowed,
    which leaves it none only when ``seen < 1`` or ``i >= seen + window -
    1`` -- the same under a causal mask and without one."""
    if seen < 1:
        return 0
    if window > 0:
        return min(Sq, seen + window - 1)
    return Sq


def _strides(t):
    """Element strides of ``(B, S, heads, D)``, with a size-1 dimension given
    the row's length: its stride is never read, and TMA takes only strides
    that are multiples of 16 bytes."""
    return [s if n > 1 else t.shape[-1] for s, n in zip(t.stride()[:3],
                                                         t.shape[:3])]


def _tma_ready(t) -> bool:
    """Whether the bf16 kernel's TMA loads can read ``t`` as it lies."""
    return (t.shape[-1] % 16 == 0 and t.stride(-1) == 1
            and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in _strides(t)))


def tma_operands(q, k, v):
    """``(q, k, v, copied)`` for the bf16 kernel: each input TMA cannot read
    as it lies (see :func:`_tma_ready`) is copied once into a fresh
    contiguous tensor with D zero-padded to a multiple of 16 (all three are
    padded together when D is not one); the others are returned as they
    are.  Pure torch, on any device."""
    D = q.shape[-1]
    Dp = -(-D // 16) * 16
    out, copied = [], False
    for t in (q, k, v):
        if Dp == D and _tma_ready(t):
            out.append(t)
            continue
        c = t.new_zeros(t.shape[:3] + (Dp,))
        c[..., :D] = t
        out.append(c)
        copied = True
    return (*out, copied)


def attention(q, k, v, *, causal=True, window=0, kv_len=None, scale=None
              ) -> torch.Tensor:
    """Attention over ``q (B, Sq, H, D)`` and ``k``, ``v (B, Sk, Hkv, D)``,
    float32 or bfloat16 (one dtype for all three); returns ``(B, Sq, H, D)``
    in that dtype.  On a CUDA tensor: one launch of ``fa_flash_attention``
    (and one of ``fa_blind_rows`` where rows see no key, see the module's
    docstring), which takes any ``D <= 256``, any ``Sq`` and ``Sk``, and
    reads the three inputs through their strides (in float32 a last
    dimension that is not contiguous is copied first; in bf16 an input TMA
    cannot read is copied aligned and padded, see the module's
    docstring)."""
    B, Sq, H, Hkv, Sk, D, seen = _check(q, k, v, causal, window, kv_len)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if not q.is_cuda:
        return mha_plain(q, k, v, causal=causal, window=window,
                         kv_len=kv_len, scale=scale)
    if D > MAX_D:
        raise ValueError(f"the flash_attention kernel takes D <= {MAX_D}, "
                         f"got D={D}")
    copied = False
    if q.dtype == torch.bfloat16:
        q, k, v, copied = tma_operands(q, k, v)
    else:
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (q, k, v))
    Dk = q.shape[-1]
    out = torch.empty((B, Sq, H, Dk), dtype=q.dtype, device=q.device)
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    row0 = first_blind_row(Sq, seen, int(window))
    with torch.cuda.device(q.device):
        if row0 > 0:
            err = lib.fa_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, H, Hkv, Sq, Sk, Dk, *_strides(q), *_strides(k),
                *_strides(v), int(causal), int(window), seen, float(scale),
                _DTYPES[q.dtype], stream)
            if err != 0:
                raise RuntimeError(
                    f"flash_attention: CUDA launch failed with error {err}")
            LAUNCHES["flash_attention"] += 1
        if row0 < Sq:
            err = lib.fa_blind_rows(
                v.data_ptr(), out.data_ptr(), B, H, Hkv, Sq, Sk, Dk,
                *_strides(v), row0, _DTYPES[q.dtype], stream)
            if err != 0:
                raise RuntimeError(
                    f"flash_attention: the blind-row launch failed with "
                    f"error {err}")
            BLIND_LAUNCHES["flash_attention"] += 1
    if copied:
        COPIES["flash_attention"] += 1
    return out if Dk == D else out[..., :D]


# The backward holds a few float32 (B, H, rows, Sk) tensors of one block of
# query rows at a time; ``rows`` keeps each under this many bytes (at
# qwen2-7b's 4 x 2048, 28 heads: 109 rows, about 0.4 GB for the block).
BWD_TENSOR_BYTES = 96 << 20


def attention_backward(q, k, v, dout, *, causal=True, window=0, kv_len=None,
                       scale=None):
    """``(dq, dk, dv)`` of :func:`attention` for the output gradient
    ``dout``: the gradient ``jax.grad`` takes through ``ref.mha_reference``,
    written out in torch ops (no kernel; the matrix products go to
    ``torch.matmul`` through ``einsum``).

    Over blocks of query rows it recomputes ``S = q k^T scale`` and the
    masked softmax ``P`` in float32, then ``dV += P^T dO``, ``dS = P o (dO
    V^T - rowsum(P o dO V^T))`` with the masked entries zeroed (the
    gradient of the ``where``), ``dQ = dS K scale`` and ``dK += dS^T Q
    scale``, summed over each kv head's group of query heads.  A row that
    sees no key has a uniform ``P`` (its output is the mean of v), so it
    passes ``dO / Sk`` to every key's ``dV`` and nothing to ``dQ`` and
    ``dK``.  Accumulated in float32, returned in the inputs' dtypes."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kf, vf = k.float(), v.float()
    keep_all = _mask(Sq, Sk, causal, int(window), kv_len, q.device)
    dq = torch.empty((B, Sq, H, D), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Sk, Hkv, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    rows = max(1, BWD_TENSOR_BYTES // (B * H * Sk * 4))
    for r0 in range(0, Sq, rows):
        r1 = min(Sq, r0 + rows)
        n = r1 - r0
        q5 = (q[:, r0:r1].float() * scale).reshape(B, n, Hkv, rep, D)
        do5 = dout[:, r0:r1].float().reshape(B, n, Hkv, rep, D)
        hidden = ~keep_all[r0:r1]
        s = torch.einsum("bqhrd,bkhd->bhrqk", q5, kf)
        p = torch.softmax(s.masked_fill_(hidden, NEG_INF), dim=-1)
        del s
        dv += torch.einsum("bhrqk,bqhrd->bkhd", p, do5)
        ds = torch.einsum("bqhrd,bkhd->bhrqk", do5, vf)
        ds.sub_((p * ds).sum(-1, keepdim=True)).mul_(p)
        del p
        ds.masked_fill_(hidden, 0.0)
        dq[:, r0:r1] = torch.einsum("bhrqk,bkhd->bqhrd", ds, kf).reshape(
            B, n, H, D) * scale
        dk += torch.einsum("bhrqk,bqhrd->bkhd", ds, q5)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class AttentionFn(torch.autograd.Function):
    """:func:`attention` with its gradient: the forward is the wrapper as
    it is (the kernel on a CUDA tensor, the plain version on the CPU), the
    backward :func:`attention_backward`.  ``kernels.ops.mha`` calls it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_len, scale):
        ctx.save_for_backward(q, k, v)
        ctx.mask = dict(causal=causal, window=window, kv_len=kv_len,
                        scale=scale)
        return attention(q, k, v, **ctx.mask)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        return (*attention_backward(q, k, v, dout, **ctx.mask),
                None, None, None, None)


def kernel_info(D: int) -> Dict[str, int]:
    """Registers a thread at launch, dynamic shared memory (bytes) and
    blocks resident on one SM of the bf16 kernel that takes head size
    ``D``, as the CUDA runtime reports them; needs a card."""
    lib = _library()
    vals = [ctypes.c_int() for _ in range(3)]
    err = lib.fa_bf16_kernel_info(int(D), *(ctypes.byref(x) for x in vals))
    if err != 0:
        raise RuntimeError(f"fa_bf16_kernel_info failed with error {err}")
    return dict(zip(("registers", "shared_bytes", "blocks_per_sm"),
                    (x.value for x in vals)))


def flash_attention(q, k, v, *, causal=True, window=0, kv_len=None,
                    scale=None) -> torch.Tensor:
    """q ``(BH, Sq, D)``, k and v ``(BH, Sk, D)``, heads folded into the
    leading axis: the JAX function's signature (its TPU block sizes have no
    counterpart).  One launch on a CUDA tensor, as :func:`attention`."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if isinstance(t, torch.Tensor) and t.ndim != 3:
            raise ValueError(f"{name} must be (BH, S, D), got "
                             f"{tuple(t.shape)}")
    return attention(q[:, :, None], k[:, :, None], v[:, :, None],
                     causal=causal, window=window, kv_len=kv_len,
                     scale=scale)[:, :, 0]
