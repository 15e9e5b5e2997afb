"""Layout-free oracles for the kernels (shape-swept in tests)."""

from __future__ import annotations

from .flash_attention import flash_attention_plain as mha_reference
from .ssd_chunk import ssd_chunk_plain as ssd_chunk_reference  # direct form


def banked_gather_reference(flat_rows, indices):
    """Gather straight from the logical (A, D) tensor."""
    return flat_rows[indices]


def moe_dispatch_reference(x_padded, slot_token):
    """The (E*C, D) expert buffer: one row of ``x_padded`` per slot."""
    return x_padded[slot_token.long()]


__all__ = ["banked_gather_reference", "mha_reference",
           "moe_dispatch_reference", "ssd_chunk_reference"]
