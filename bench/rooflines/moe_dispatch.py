"""B5, ``kernels/moe_dispatch.py``: the expert buffer of one MoE layer,
``E * C`` slots filled from ``T`` tokens, one launch a layer of a prefill
or a decode step.

Bytes: the ``T + 1`` token rows (the last the zeros an empty slot reads)
and the ``E * C`` slot indices read once, the ``(E * C, D)`` buffer
written once, bfloat16 rows; no operations.  ``C`` is the configuration's
capacity for a group of ``T`` tokens."""

from ..reference.moe import capacity

KERNELS = ("md_dispatch",)
PEAK = None


def cost(arch: dict, T: int):
    E, D = arch["n_experts"], arch["d_model"]
    slots = E * capacity(arch, T)
    return 0, (T + 1) * D * 2 + slots * 4 + slots * D * 2


def calls(arch: dict, family: str, record: dict):
    tokens = ([b * s for b, s in record.get("batches", ())]
              + [b for b, _ in record.get("steps", ())])
    return [cost(arch, T) for T in tokens for _ in range(arch["n_layers"])]
