"""Whole runs of each cell on the CPU at toy size: the result line's
shape, a traced run, ``correct`` false under each fault the cell can have
and under its control, and a mix added as data alone."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from bench import harness
from bench.reference.common import Precision
from bench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
CELLS = list(tiny.CELLS)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(workload, trace):
    c = tiny.cell(workload)
    r = tiny.run(c, trace)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    dev = r["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(r["metrics"]) <= {m["name"] for m in c.per_layer}
    else:
        assert set(r["metrics"]) == {m["name"] for m in c.end_to_end}
        assert "setup_s" in r["metrics"]
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(r["checks"]) == set(c.limits["numbers"])
    json.dumps(r)


def test_decode_refills_a_full_cache():
    """A cache that fills inside the window: the next batch is prefilled
    there, steps once at least, and is the one judged."""
    from bench.tracing import Tracer

    c = tiny.cell("olmoe-1b-7b.decode-64x4k")
    mix = c.traffic
    c.traffic = dict(mix, max_len=mix["prompt"] + mix["warm_steps"])
    drv = c.driver()
    s = drv.setup(c)
    rec = drv.window(c, s, Tracer(False, "cpu"))
    assert rec["refills"] == 1 and len(rec["steps"]) == 1
    assert rec["tokens"] == 2 * mix["rows"]
    correct, checks = harness.judged(c, drv.judge_numbers(c, s, rec))
    assert correct, checks


class Broken:
    """The program with one fault planted where its outputs are made."""

    def __init__(self, fault: str):
        self.p, self.fault = harness.load_program(), fault
        for name in ("ArchConfig", "get_model", "param_shapes"):
            setattr(self, name, getattr(self.p, name))

    def make_prefill_step(self, model, max_len):
        step = self.p.make_prefill_step(model, max_len)

        def broken(params, batch):
            logits, cache = step(params, batch)
            if self.fault == "state_unchanged":     # the cache as it began
                cache = model.init_cache(logits.shape[0], max_len,
                                         device=logits.device)
            if self.fault == "token_altered":       # row 0's best made worst
                logits = logits.clone()
                logits[0] = -logits[0]
            return logits, cache

        return broken

    def make_serve_step(self, model):
        step = self.p.make_serve_step(model)

        def broken(params, cache, tokens):
            if self.fault == "state_unchanged":     # nothing written, no pos
                tok, logits, _ = step(params, type(cache)(
                    *(t.clone() if torch.is_tensor(t) else t
                      for t in cache)), tokens)
                return tok, logits, cache
            tok, logits, cache = step(params, cache, tokens)
            if self.fault == "token_altered":
                tok = tok.clone()
                tok[0, 0] = logits[0].argmin()
            return tok, logits, cache

        return broken


FAULTS = [(w, f) for w in CELLS for f in ("state_unchanged", "token_altered")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_is_not_correct(workload, fault):
    r = tiny.run(tiny.cell(workload, program=Broken(fault)))
    assert r["correct"] is False, (fault, r["checks"])


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    """The reference in float8 in the program's place fails the limits."""
    c = tiny.cell(workload)
    drv = c.driver()
    s = drv.setup(c)
    from bench.tracing import Tracer
    rec = drv.window(c, s, Tracer(False, "cpu"))
    correct, checks = harness.judged(
        c, drv.control_numbers(c, s, rec, Precision(fp8=True)))
    assert correct is False, checks


def test_a_mix_added_as_data_alone(tmp_path):
    """A new traffic mix, a new cell and a new per-layer metric are new
    files and entries: no file of the harness changes."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    name = "olmoe-1b-7b.throwaway"
    spec["workloads"].append({"name": name, "config": "olmoe-1b-7b",
                              "traffic": "throwaway", "chips": 1,
                              "why": "a test's"})
    for m in spec["end_to_end"]:
        if m["name"] == "prefill_tokens_per_s":
            m["workloads"].append(name)
    spec["per_layer"].append({"name": "batches_in_window", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "driver", "moves":
                              "prefill_tokens_per_s", "workloads": [name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    mix = dict(tiny.TRAFFIC["prefill"], rows=3, prompt=[9, 15], strata=2)
    (tmp_path / "bench/traffic/throwaway.json").write_text(json.dumps(mix))
    (tmp_path / "bench/metrics/batches_in_window.py").write_text(
        "def read(ctx):\n    return len(ctx.record['batches'])\n")
    limits = tmp_path / "bench/limits" / f"{name}.json"
    limits.write_text((ROOT / "bench/limits/olmoe-1b-7b.prefill-8x1k-4k.json")
                      .read_text())
    c = harness.Cell(name, 7, 0.3, root=tmp_path, device="cpu",
                     arch=tiny.ARCH["moe"])
    assert c.traffic["rows"] == 3 and c.traffic["prompt"] == [9, 15]
    r = tiny.run(c, trace=True)
    assert r["metrics"]["batches_in_window"]["value"] >= 1
    assert r["attempted"] % 3 == 0
    r = tiny.run(c)
    assert set(r["metrics"]) == {"prefill_tokens_per_s", "setup_s"}
