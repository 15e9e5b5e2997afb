"""The traffic generator and the yardstick's arithmetic: rooflines and
model FLOPs against hand counts at small shapes."""

from __future__ import annotations

import itertools
import json
from pathlib import Path

import pytest
import torch

from bench import traffic
from bench.flops import moe as moe_flops
from bench.flops import ssm as ssm_flops
from bench.reference.moe import capacity
from bench.rooflines import flash_attention, moe_dispatch, ssd_chunk
from bench.tests.tiny import ARCH

ROOT = Path(__file__).resolve().parents[2]
MIX = json.loads((ROOT / "bench/traffic/prefill-8x1k-4k.json").read_text())


def test_same_seed_same_prompts():
    a = traffic.Prompts(MIX, 50304, 2**31 + 7, "cpu")
    b = traffic.Prompts(MIX, 50304, 2**31 + 7, "cpu")
    la, lb = traffic.lengths(MIX, 2**31 + 7), traffic.lengths(MIX, 2**31 + 7)
    for _ in range(3):
        n = next(la)
        assert n == next(lb)
        assert torch.equal(a.batch(n), b.batch(n))


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 1, 9_876_543_210])
def test_lengths_in_range_and_each_stratum_once_a_cycle(seed):
    strata = traffic.stratum_lengths(MIX)
    assert len(strata) == MIX["strata"] == 8
    assert all(1000 <= n <= 4096 for n in strata)
    assert sorted(strata) == strata and len(set(strata)) == 8
    lens = list(itertools.islice(traffic.lengths(MIX, seed), 24))
    for c in range(3):
        assert sorted(lens[8 * c:8 * c + 8]) == strata
    toks = traffic.Prompts(MIX, 50304, seed, "cpu").batch(lens[0])
    assert toks.shape == (8, lens[0])
    assert 0 <= int(toks.min()) and int(toks.max()) < 50304


def test_seeds_change_the_order_not_the_set():
    a = list(itertools.islice(traffic.lengths(MIX, 1), 8))
    b = list(itertools.islice(traffic.lengths(MIX, 2), 8))
    assert a != b and sorted(a) == sorted(b)


def test_flash_attention_cost_by_hand():
    arch = {"n_heads": 2, "n_kv_heads": 1, "head_dim": 4}
    flops, bytes_ = flash_attention.cost(arch, B=1, S=3)
    # pairs (i, j <= i): 6; a pair of a head: QK^T 4 MACs, PV 4 MACs
    assert flops == 6 * 2 * (4 + 4) * 2
    # q and o: 3 x 2 x 4 each, k and v: 3 x 1 x 4 each, bf16
    assert bytes_ == 2 * (24 + 24 + 12 + 12)


def test_moe_dispatch_cost_by_hand():
    arch = {"n_experts": 4, "d_model": 8, "top_k": 2, "capacity_factor": 1.25,
            "capacity_multiple": 8, "capacity_min": 8}
    C = capacity(arch, 10)                 # ceil(10 * 2 * 1.25 / 4) = 7 -> 8
    assert C == 8
    flops, bytes_ = moe_dispatch.cost(arch, 10)
    assert flops == 0
    assert bytes_ == 11 * 8 * 2 + 32 * 4 + 32 * 8 * 2
    rec = {"batches": [(2, 5)], "steps": [(3, 9)]}
    assert len(moe_dispatch.calls({**arch, "n_layers": 2}, "moe", rec)) == 4


def test_ssd_chunk_cost_by_hand():
    arch = {"d_model": 4, "ssm_expand": 2, "ssm_head_dim": 4, "ssm_state": 3,
            "ssm_chunk": 5, "n_layers": 2}
    B, H, P, N, Q = 1, 2, 4, 3, 5
    flops, bytes_ = ssd_chunk.cost(arch, B)
    assert flops == (2 * Q * Q * N + 2 * H * Q * Q * P + 2 * H * Q * P * N
                     + 2 * H * Q * P * N)
    assert bytes_ == 4 * (2 * H * Q * P + 2 * H * Q + 2 * Q * N
                          + 2 * H * P * N)
    # 11 positions: 3 chunks a block, 2 blocks
    assert len(ssd_chunk.calls(arch, "ssm", {"batches": [(1, 11)]})) == 6


def test_moe_flops_by_hand():
    a = ARCH["moe"]
    D, H, Hkv, Dh, E, K, F, V, L = (a["d_model"], a["n_heads"],
                                    a["n_kv_heads"], a["head_dim"],
                                    a["n_experts"], a["top_k"],
                                    a["moe_d_ff"], a["vocab"], a["n_layers"])
    B, S = 2, 5
    per_tok = (2 * D * H * Dh + 2 * 2 * D * Hkv * Dh + 2 * H * Dh * D
               + 2 * D * E + K * 3 * 2 * D * F)
    attn = B * H * 15 * Dh * 2 * 2                 # 15 causal pairs a row
    assert moe_flops.prefill(a, B, S) == L * (B * S * per_tok + attn) \
        + 2 * B * D * V
    assert moe_flops.decode(a, 3, 7) == L * (3 * per_tok
                                             + 3 * H * 7 * Dh * 4) \
        + 2 * 3 * D * V


def test_ssm_flops_by_hand():
    a = ARCH["ssm"]
    D, N, W = a["d_model"], a["ssm_state"], a["ssm_conv"]
    di = 2 * D
    H = di // a["ssm_head_dim"]
    block = (2 * D * (2 * di + 2 * N + H) + 2 * W * (di + 2 * N)
             + 5 * di * N + 2 * di * D)
    B, S = 2, 4
    assert ssm_flops.prefill(a, B, S) == (
        B * S * a["n_layers"] * block + 2 * B * D * a["vocab"])
    assert ssm_flops.decode(a, 3, 99) == (
        3 * a["n_layers"] * block + 2 * 3 * D * a["vocab"])
