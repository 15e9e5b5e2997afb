"""Public wrappers around the kernels.

``gather_banked``, ``scatter_banked`` and ``pack_banked`` go through a
compiled banking artifact, which launches the CUDA kernels of
``kernels/banked_gather.py`` for a table on the card and their plain torch
versions for a table on the CPU.  ``dispatch`` fills the MoE expert buffer
through ``kernels/moe_dispatch.py`` the same way; ``moe_combine`` is plain
torch.
"""

from __future__ import annotations

import torch.nn.functional as F

from ..core.artifact import as_compiled
from . import moe_dispatch as _md
from .moe_dispatch import moe_combine


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


__all__ = ["dispatch", "gather_banked", "moe_combine", "pack_banked",
           "scatter_banked"]
