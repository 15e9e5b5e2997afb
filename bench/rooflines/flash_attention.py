"""B4, ``kernels/flash_attention.py``: causal attention over a prompt, one
launch an attention layer of a prefill.

Operations: ``QK^T`` and ``PV`` over the causal half, ``2 * 2 * Dh`` a
(query, key) pair of a head, ``S (S + 1) / 2`` pairs.  Bytes: q, k, v read
once and the output written once, bfloat16."""

KERNELS = ("fa_hopper", "fa_kernel", "fa_blind_rows")
PEAK = "bf16"


def cost(arch: dict, B: int, S: int):
    H, Hkv, Dh = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    flops = 2 * B * H * Dh * S * (S + 1)
    bytes_ = 2 * B * S * Dh * (2 * H + 2 * Hkv)
    return flops, bytes_


def calls(arch: dict, family: str, record: dict):
    return [cost(arch, B, S) for B, S in record.get("batches", ())
            for _ in range(arch["n_layers"])]
