"""Layout-free oracles for the kernels (shape-swept in tests)."""

from __future__ import annotations


def banked_gather_reference(flat_rows, indices):
    """Gather straight from the logical (A, D) tensor."""
    return flat_rows[indices]


def moe_dispatch_reference(x_padded, slot_token):
    """The (E*C, D) expert buffer: one row of ``x_padded`` per slot."""
    return x_padded[slot_token.long()]
