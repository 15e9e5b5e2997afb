"""Layout-free oracles for the kernels (shape-swept in tests)."""

from __future__ import annotations


def banked_gather_reference(flat_rows, indices):
    """Gather straight from the logical (A, D) tensor."""
    return flat_rows[indices]
