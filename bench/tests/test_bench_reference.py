"""The plain reference against itself: in blocks against whole, the SSD
form against the recurrence written step by step, the capacity rule
against a loop, and the trace's reduction on made-up events."""

from __future__ import annotations

import math

import pytest
import torch

from bench import weights
from bench.reference import common, moe, ssm
from bench.tests.tiny import ARCH, RULES
from bench.tracing import summarise


def _naive_attention(q, k, v):
    S, H, Dh = q.shape
    rep = H // k.shape[1]
    k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(Dh)
    s = s.masked_fill(torch.ones(S, S).triu(1).bool(), float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v)


@pytest.mark.parametrize("block", [1, 7, 512])
def test_attention_in_blocks(block):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(23, 4, 8, generator=g)
    k, v = torch.randn(23, 2, 8, generator=g), torch.randn(23, 2, 8,
                                                           generator=g)
    torch.testing.assert_close(common.causal_attention(q, k, v, block),
                               _naive_attention(q, k, v),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunk", [4, 16, 64])
def test_ssd_against_the_recurrence(chunk):
    g = torch.Generator().manual_seed(1)
    S, H, P, N = 37, 3, 4, 5
    x = torch.randn(S, H, P, generator=g)
    dt = torch.rand(S, H, generator=g) * 0.5
    A = -torch.rand(H, generator=g) * 4
    Bm, Cm = torch.randn(S, N, generator=g), torch.randn(S, N, generator=g)
    s = torch.zeros(H, P, N)
    ys = []
    for t in range(S):
        s = s * torch.exp(dt[t] * A)[:, None, None] + torch.einsum(
            "n,hp->hpn", Bm[t], x[t] * dt[t][:, None])
        ys.append(torch.einsum("n,hpn->hp", Cm[t], s))
    y, state = ssm.ssd(x, dt, A, Bm, Cm, chunk)
    torch.testing.assert_close(y, torch.stack(ys), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(state, s, rtol=1e-4, atol=1e-4)


def test_capacity_rule_against_a_loop():
    arch = dict(ARCH["moe"], **RULES, n_experts=4, top_k=2,
                capacity_factor=0.5)
    g = torch.Generator().manual_seed(2)
    B, S, D = 3, 5, arch["d_model"]
    h = torch.randn(B, S, D, generator=g)
    lp = {"router": torch.randn(D, 4, generator=g),
          "we_gate": torch.randn(4, D, 8, generator=g) / 16,
          "we_up": torch.randn(4, D, 8, generator=g) / 16,
          "we_down": torch.randn(4, 8, D, generator=g) / 3}
    prec = common.Precision()
    # two groups: rows 0-1 and row 2, row 2's order reversed
    group = torch.tensor([[0] * S, [0] * S, [1] * S])
    order = torch.stack([torch.arange(S), S + torch.arange(S),
                         torch.arange(S).flip(0)])
    out = moe.moe_ffn(prec, arch, lp, h, (group, order))
    probs = torch.softmax(h.reshape(-1, D) @ lp["router"], -1)
    top_p, top_i = torch.topk(probs, 2, -1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    want = torch.zeros(B * S, D)
    for grp, toks in ((0, list(range(2 * S))),
                      (1, [2 * S + s for s in reversed(range(S))])):
        C = moe.capacity(arch, len(toks))
        taken = [0] * 4
        for t in toks:
            for k in range(2):
                e = int(top_i[t, k])
                if taken[e] < C:
                    taken[e] += 1
                    x = h.reshape(-1, D)[t]
                    y = common.swiglu(prec, x, lp["we_gate"][e],
                                      lp["we_up"][e], lp["we_down"][e])
                    want[t] += top_p[t, k] * y
    torch.testing.assert_close(out.reshape(-1, D), want, rtol=1e-5,
                               atol=1e-5)


def _params(fam, seed=3):
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import get_model
    from repro_torch.models.api import param_shapes

    shapes = param_shapes(get_model(ArchConfig(**ARCH[fam])))
    return weights.draw(shapes, seed, "cpu",
                        ssm={"time_step_min": 1e-3, "time_step_max": 0.1})


@pytest.mark.parametrize("fam", ["moe", "ssm"])
def test_reference_rows_alone_equal_the_batch(fam):
    """Row by row equals the whole batch where nothing couples the rows
    (the MoE at a capacity no expert reaches)."""
    arch = (dict(ARCH[fam], **RULES, capacity_factor=8.0) if fam == "moe"
            else ARCH[fam])
    params = _params(fam)
    tokens = torch.randint(0, arch["vocab"], (3, 19),
                           generator=torch.Generator().manual_seed(4))
    prec = common.Precision()
    ref = moe if fam == "moe" else ssm

    def run(t):
        return ref.hidden(arch, params, t, prec)

    whole = run(tokens)
    rows = torch.cat([run(tokens[b:b + 1]) for b in range(3)])
    torch.testing.assert_close(whole, rows, rtol=1e-4, atol=1e-4)


def test_weights_from_the_seed():
    a, b, c = _params("ssm", 5), _params("ssm", 5), _params("ssm", 6)
    for (pa, la), (_, lb), (_, lc) in zip(weights.leaves(a),
                                          weights.leaves(b),
                                          weights.leaves(c)):
        assert torch.equal(la, lb), pa
        if pa.rsplit("/", 1)[-1] != "D_skip":
            assert not torch.equal(la, lc), pa
    dt = torch.nn.functional.softplus(a["layers"]["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    A = torch.exp(a["layers"]["A_log"])
    assert float(A.min()) >= 1.0 and float(A.max()) <= 16.0


def test_trace_busy_gaps_and_spans():
    ev = [("bench.window", "span", 0.0, 100.0),
          ("bench.step", "span", 0.0, 60.0),
          ("bench.copy", "span", 60.0, 75.0),
          ("k1", "op", 10.0, 30.0), ("k2", "op", 25.0, 40.0),
          ("k1", "op", 62.0, 80.0)]
    t = summarise(ev)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(48e-6)             # 10-40 and 62-80
    assert t.launches == 3 and t.kernels["k1"][0] == 2
    # a gap goes to the span its start falls in: 0-10 and 40-62 to the
    # step, 80-100 to the window alone
    assert t.idle_by_span == pytest.approx({"bench.step": 32e-6,
                                            "bench.window": 20e-6})
    assert t.matching(("k",)) == (3, pytest.approx(53e-6))
    assert t.breakdown()["device_ops"][0] == ["k1", pytest.approx(38e-6)]
