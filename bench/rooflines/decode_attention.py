"""``kernels/decode_attention.py``: the attention of a decode step against
its KV cache, one launch an attention layer of a step.

Bytes: q read and the output written, ``B x H x Dh`` bfloat16 each (one
query row), and K and V over the keys the row keeps, ``2 * B * L' * Hkv *
Dh * 2``, where ``L'`` is the step's ``kv_len`` or, in a layer with a
window, ``min(kv_len, window)``.  Operations: ``q.k`` and ``p.v``, 2 FMA a
(head, key, element), on float32 FMA units; ``PEAK`` None: the bytes bound
it (1-2 FLOP a byte)."""

KERNELS = ("da_decode_attention",)
PEAK = None


def cost(arch: dict, B: int, L: int):
    H, Hkv, Dh = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    flops = 4 * B * H * L * Dh
    bytes_ = 2 * (2 * B * H * Dh + 2 * B * L * Hkv * Dh)
    return flops, bytes_


def windows(arch: dict):
    """Each layer's window (0: none), as ``transformer.layer_windows``
    lays a local:global pattern out."""
    w, ratio = arch.get("sliding_window", 0), arch.get("local_global_ratio", 0)
    if w and ratio:
        return [0 if (i + 1) % (ratio + 1) == 0 else w
                for i in range(arch["n_layers"])]
    return [w] * arch["n_layers"]


def calls(arch: dict, family: str, record: dict):
    """One call a layer a decode step, ``(rows, kv_len)`` from the
    record's ``steps``; the families whose every layer attends its cache
    (dense, MoE)."""
    if family not in ("dense", "moe"):
        return []
    return [cost(arch, B, min(L, w) if w else L)
            for B, L in record.get("steps", ()) for w in windows(arch)]
