"""The decode-attention kernel's roofline (``bench/rooflines/
decode_attention.py``): its bytes and calls against hand counts for the
decode mix, with and without a window, and ``None`` on a prefill record."""

from __future__ import annotations

from types import SimpleNamespace

from bench.readers import roofline_share
from bench.rooflines import decode_attention


def test_decode_attention_cost_by_hand():
    arch = {"n_heads": 4, "n_kv_heads": 2, "head_dim": 8, "n_layers": 3}
    flops, bytes_ = decode_attention.cost(arch, B=2, L=5)
    # q and o: 2 x 4 x 8 each; k and v: 2 rows x 5 keys x 2 x 8 each; bf16
    assert bytes_ == 2 * (64 + 64 + 160 + 160)
    assert flops == 2 * 4 * 5 * 8 * 2 * 2        # q.k and p.v, 2 FMA each
    # the decode mix's steps: (rows, kv_len), one call a layer
    rec = {"steps": [(64, 2049), (64, 2050)]}
    got = decode_attention.calls(arch, "moe", rec)
    assert got == [decode_attention.cost(arch, 64, L)
                   for L in (2049, 2050) for _ in range(3)]
    assert got[0][1] == 2 * (2 * 64 * 4 * 8 + 2 * 64 * 2049 * 2 * 8)


def test_decode_attention_calls_under_a_window():
    """gemma3's pattern: every 6th layer global, the others read only the
    last ``window`` keys."""
    arch = {"n_heads": 2, "n_kv_heads": 1, "head_dim": 4, "n_layers": 6,
            "sliding_window": 1024, "local_global_ratio": 5}
    assert decode_attention.windows(arch) == [1024] * 5 + [0]
    got = decode_attention.calls(arch, "dense", {"steps": [(2, 3000),
                                                           (2, 700)]})
    want = ([decode_attention.cost(arch, 2, 1024)] * 5
            + [decode_attention.cost(arch, 2, 3000)]
            + [decode_attention.cost(arch, 2, 700)] * 6)
    assert got == want
    every = {**arch, "local_global_ratio": 0}
    assert decode_attention.windows(every) == [1024] * 6


def test_decode_attention_reads_none_on_a_prefill_record():
    arch = {"n_heads": 2, "n_kv_heads": 1, "head_dim": 4, "n_layers": 2}
    rec = {"entry": "prefill", "seconds": 1.0, "batches": [(8, 1000)]}
    assert decode_attention.calls(arch, "moe", rec) == []
    assert decode_attention.calls(arch, "ssm", {"steps": [(1, 9)]}) == []
    ctx = SimpleNamespace(record=rec, arch=arch, family="moe",
                          peaks={"bytes_per_s": 3.35e12}, trace=None)
    assert roofline_share(ctx, "decode_attention", "generate") is None
