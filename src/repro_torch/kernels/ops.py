"""Public wrappers around the kernels.

``gather_banked``, ``scatter_banked`` and ``pack_banked`` go through a
compiled banking artifact, which launches the CUDA kernels of
``kernels/banked_gather.py`` for a table on the card and their plain torch
versions for a table on the CPU.  ``dispatch`` fills the MoE expert buffer
through ``kernels/moe_dispatch.py`` the same way, ``ssd`` runs one
Mamba2 SSD chunk through ``kernels/ssd_chunk.py``, and ``mha`` attends over
a whole prompt through ``kernels/flash_attention.py``; ``moe_combine`` is
plain torch.
"""

from __future__ import annotations

import torch.nn.functional as F

from ..core.artifact import as_compiled
from . import flash_attention as _fa
from . import moe_dispatch as _md
from .moe_dispatch import moe_combine
from .ssd_chunk import ssd_chunk


def gather_banked(table, indices, compiled):
    """Gather logical rows from a bank-major table through a compiled
    banking artifact; its strength-reduced resolution arithmetic runs
    inside the kernel, in front of the load (see kernels/banked_gather.py).

    ``indices`` may be a flat ``(T,)`` vector or a stacked ``(T, R)``
    matrix of row-sets (one decode tick's reads for every active
    sequence): the batched form issues ONE kernel launch for the whole
    tick and returns ``(T, R, D)``.

    Accepts a ``CompiledBankingPlan`` or anything ``as_compiled`` takes;
    passing a raw ``BankingSolution`` still works but is deprecated."""
    return as_compiled(compiled).gather(table, indices)


def scatter_banked(table, indices, values, compiled, *, col=None):
    """Write logical rows into a bank-major table through a compiled
    banking artifact -- the scatter analogue of :func:`gather_banked`.

    ``indices`` is a flat ``(T,)`` vector of logical addresses.  With
    ``col=None``, ``values`` is ``(T, D)`` replacement rows; with
    ``col`` a ``(T,)`` vector of column indices, ``values`` is ``(T,)``
    scalars -- the serving runtime's batched per-slot token-record
    write.  The table is updated in place and returned."""
    return as_compiled(compiled).scatter(table, indices, values, col=col)


def pack_banked(flat, compiled, device=None):
    """Layout conversion: logical (A, D) rows -> bank-major (N, V, D) per
    the compiled artifact's physical layout (reference Eq. 1-2 placement --
    tests assert the kernels' transformed arithmetic agrees with it)."""
    return as_compiled(compiled).pack(flat, device=device)


def dispatch(x, slot_token):
    """x: ``(T, D)`` tokens; slot_token: ``(E*C,)`` source token per slot,
    ``T`` for an empty one.  Appends the zeros row that empty slots read
    and returns the ``(E*C, D)`` expert buffer."""
    return _md.moe_dispatch(F.pad(x, (0, 0, 0, 1)), slot_token)


def ssd(x, dt, bm, cm, cum, s_prev):
    """One SSD chunk for every (batch, head): x ``(B, H, Q, P)``, dt and cum
    ``(B, H, Q)``, bm and cm ``(B, Q, N)``, s_prev ``(B, H, P, N)``, all
    float32.  Returns ``(y (B, H, Q, P), s_new (B, H, P, N))``."""
    return ssd_chunk(x, dt, bm, cm, cum, s_prev)


def mha(q, k, v, *, causal=True, window=0, kv_len=None):
    """Multi-head attention through the flash attention kernel: q ``(B, Sq,
    H, Dh)``, k and v ``(B, Sk, Hkv, Dh)``, float32 or bfloat16.  Grouped
    query heads read their kv head by index (``h // (H // Hkv)``); k and v
    are neither repeated nor transposed.  One launch on a CUDA tensor.
    Positions count from 0 for q and k alike; a row that sees no key gets
    the mean of v over all keys, as the JAX oracle gives it (see
    ``kernels/flash_attention.py``)."""
    return _fa.attention(q, k, v, causal=causal, window=window,
                         kv_len=kv_len)


__all__ = ["dispatch", "gather_banked", "mha", "moe_combine", "pack_banked",
           "scatter_banked", "ssd"]
