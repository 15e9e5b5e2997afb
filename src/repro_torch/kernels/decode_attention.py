"""Attention of a decode step against a KV cache, as a CUDA kernel beside
its plain torch version.

For every (batch, query head) and query row ``i`` at position ``p =
q_offset + i``, with ``q`` cast to float32 and scaled before the product::

    s[i, j] = (q[i] * scale) . k[j]                        float32
    keep    = j < kv_len  and  (causal: j <= p)  and  (window > 0: p - j < window)
    o[i]    = softmax(where(keep, s, -1e30))[i] @ v        cast to q's dtype

The plain version is ``models.layers.decode_attention``: one grouped einsum
over the whole buffer, in float32, masked afterwards.  It is what the CPU
runs and the oracle the kernel is held to; ``layers.chunked_attention``
picks between the two by the tensors' device.  :func:`decode_attention`
keeps its signature and launches ``csrc/decode_attention.cu`` once: it
reads only the keys the rows keep, each once, in bfloat16, and computes in
float32 (see the source's note).  It replaces no TPU kernel.

It takes what the decode paths hand it: ``q (B, Sq, H, D)`` and the cache
buffers ``k``, ``v (B, Smax, Hkv, D)`` as they lie, bfloat16 and
contiguous, ``Sq <= 4``, ``Sq * H / Hkv <= 32`` rows a kv head and ``D`` one
of the models' head sizes (64, 80, 128, 240, and 32 for the reduced
configurations); ``q_offset``, ``kv_len`` and ``window`` are host ints, so
nothing is read back from the card.  Anything else raises, a CPU tensor
too (after the checks, which hold on any device): nothing falls back.

A row that keeps no key gets what the plain version gives it, the mean of v
over all ``Smax`` rows; no model's call has one.  ``LAUNCHES`` counts kernel
launches, nothing else.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

LAUNCHES: Dict[str, int] = {"decode_attention": 0}

HEAD_DIMS = (32, 64, 80, 128, 240)   # the instantiations of the kernel
MAX_SQ = 4
MAX_ROWS = 32                    # Sq x (H / Hkv): a block's query rows
TILE = 64                        # key positions a tile (DA_TILE)
MAX_SPLITS = 32
MIN_TILES_PER_SPLIT = 2
BLOCKS_PER_SM = 2                # the grid the splits aim for


def reset_launch_counts() -> None:
    LAUNCHES["decode_attention"] = 0


_lib = None
# per (device, stream): int32 counters of finished splits, one a (batch,
# kv head), left at 0 by the kernel
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}
_SMS: Dict[int, int] = {}


def _bind(lib) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.da_decode_attention.argtypes = (
        [ptr] * 6 + [i32] * 5 + [i32] + [i64] * 2 + [i32] * 6
        + [ctypes.c_float, ptr])
    lib.da_decode_attention.restype = ctypes.c_int


def _library():
    """The compiled kernel, built at first use; raises when it cannot be
    built."""
    global _lib
    if _lib is None:
        from . import _build

        _lib = _build.load("decode_attention", _bind)
    return _lib


def _check(q, k, v, causal, window, q_offset, kv_len):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, "
                            f"got {type(t).__name__}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the decode_attention kernel takes bfloat16, "
                            f"{name} is {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
        if t.ndim != 4:
            raise ValueError(f"{name} must be (B, S, heads, D), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous with a 16-byte "
                             f"aligned base, as the cache buffers lie")
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Sk, Hkv, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must both be (B, Smax, Hkv, D) = "
                         f"({B}, Smax, Hkv, {D}) for q {tuple(q.shape)}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the decode_attention kernel takes head sizes "
                         f"{HEAD_DIMS}, got {D}")
    if min(B, Sq, Sk, H, Hkv) < 1:
        raise ValueError(f"every size must be at least 1: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} kv heads")
    if Sq > MAX_SQ or Sq * (H // Hkv) > MAX_ROWS:
        raise ValueError(f"the decode_attention kernel takes at most "
                         f"{MAX_SQ} query rows and {MAX_ROWS} rows a kv head "
                         f"(Sq x H / Hkv), got Sq {Sq}, H {H}, Hkv {Hkv}")
    if not isinstance(causal, bool):
        raise TypeError(f"causal must be a bool, got {causal!r}")
    if int(window) != window or window < 0:
        raise ValueError(f"window must be an int >= 0, got {window!r}")
    if int(q_offset) != q_offset:
        raise ValueError(f"q_offset must be an int, got {q_offset!r}")
    if kv_len is not None and int(kv_len) != kv_len:
        raise ValueError(f"kv_len must be an int or None, got {kv_len!r}")
    return B, Sq, H, Hkv, Sk, D


def key_range(p: int, Sk: int, kv_end: int, causal: bool, window: int
              ) -> Tuple[int, int]:
    """``[lo, hi)``: the keys the query row at position ``p`` keeps, for
    ``kv_end = min(kv_len, Sk)``; ``(0, Sk)`` for a row that keeps none
    (every score masked alike).  The kernel computes the same per row."""
    hi = min(kv_end, p + 1) if causal else kv_end
    lo = max(0, p - window + 1) if window > 0 else 0
    return (lo, hi) if hi > lo else (0, Sk)


def key_span(Sq: int, Sk: int, q_offset: int, kv_len: Optional[int],
             causal: bool, window: int) -> Tuple[int, int]:
    """The union of the ``Sq`` rows' key ranges: the keys a call reads."""
    kv_end = Sk if kv_len is None else min(int(kv_len), Sk)
    ranges = [key_range(q_offset + i, Sk, kv_end, causal, window)
              for i in range(Sq)]
    return min(r[0] for r in ranges), max(r[1] for r in ranges)


def splits(pairs: int, span: int, sms: int) -> Tuple[int, int]:
    """``(tiles_per_split, splits)``: the span's tiles cut into as many
    splits as fill ``BLOCKS_PER_SM`` blocks on each of ``sms`` SMs over the
    ``pairs`` (batch, kv head) blocks, at least ``MIN_TILES_PER_SPLIT``
    tiles and at most ``MAX_SPLITS`` splits, none empty."""
    tiles = -(-span // TILE)
    want = min(MAX_SPLITS, max(1, -(-BLOCKS_PER_SM * sms // pairs)))
    per = max(MIN_TILES_PER_SPLIT, -(-tiles // want))
    return per, -(-tiles // per)


def _sms(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = c
    return c


def decode_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                     kv_len=None, scale=None) -> torch.Tensor:
    """``models.layers.decode_attention``'s function over ``q (B, Sq, H,
    D)`` and the cache buffers ``k``, ``v (B, Smax, Hkv, D)``; returns
    ``(B, Sq, H, D)`` in bfloat16: one launch of the kernel over the keys
    the rows keep.  The arguments are checked on any device (see the
    module's docstring); then a CPU tensor raises."""
    B, Sq, H, Hkv, Sk, D = _check(q, k, v, causal, window, q_offset, kv_len)
    if not q.is_cuda:
        raise ValueError("the decode_attention kernel takes CUDA tensors; "
                         "on the CPU models.layers.decode_attention runs")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    window, q_offset = int(window), int(q_offset)
    kv_end = Sk if kv_len is None else min(int(kv_len), Sk)
    jlo, jhi = key_span(Sq, Sk, q_offset, kv_len, causal, window)
    pairs = B * Hkv
    per, n = splits(pairs, jhi - jlo, _sms(q.device))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part = count = None
    if n > 1:
        part = torch.empty((pairs, n, Sq * (H // Hkv), D + 2),
                           dtype=torch.float32, device=q.device)
        count = _counters(q.device, stream, pairs)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.da_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            None if count is None else count.data_ptr(),
            B, Sq, H, Hkv, Sk, D, q_offset, kv_end, int(causal), window,
            jlo, jhi, per, n, float(scale), stream)
    if err != 0:
        raise RuntimeError(
            f"decode_attention: CUDA launch failed with error {err}")
    LAUNCHES["decode_attention"] += 1
    return out
