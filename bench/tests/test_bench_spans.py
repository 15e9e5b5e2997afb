"""The readers of the program's own spans and counters
(``bench/spans.py``): what a traced toy run gives them on the CPU, their
arithmetic on a recorder's summary, and ``None`` against a program without
the recorder."""

from __future__ import annotations

import json
import sys
import types
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench import harness
from bench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = {m["name"]: m for m in SPEC["per_layer"]
       if (ROOT / "bench/metrics" / f"{m['name']}.py").read_text()
       .count("..spans")}
DROPPED = {"moe_dropped_pair_share.prefill", "moe_dropped_pair_share.decode"}


def _reader(name):
    return harness.load_file(ROOT / "bench/metrics" / f"{name}.py",
                             "bench.metrics")


def test_the_eight_readers_and_their_cells():
    """Six readers: the attention and MoE layers' span times and the
    dropped shares, in the two olmoe-1b-7b cells."""
    assert len(NEW) == 6
    assert {c for m in NEW.values() for c in m["workloads"]} == {
        "olmoe-1b-7b.prefill-8x1k-4k", "olmoe-1b-7b.decode-64x4k"}


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_source_names_its_origin(name):
    """A span's time is the stream's between the program's two events, not
    the trace's busy time: ``program_span``; the dropped shares are
    ``program_counter``."""
    want = "program_counter" if name in DROPPED else "program_span"
    assert NEW[name]["source"] == want


@pytest.mark.parametrize("workload", ["olmoe-1b-7b.prefill-8x1k-4k",
                                      "olmoe-1b-7b.decode-64x4k"])
def test_a_traced_toy_run_reads_the_counters_and_no_device_time(workload):
    from repro_torch.core.tracing import MODEL_SPANS

    from bench.tracing import Tracer

    c = tiny.cell(workload)
    drv = c.driver()
    s = drv.setup(c)
    MODEL_SPANS.reset()
    tracer = Tracer(True, "cpu")        # harness.run's traced window
    with tracer:
        rec = drv.window(c, s, tracer)
    metrics = harness.per_layer(c, tracer.read(), rec, "cpu")
    MODEL_SPANS.reset()
    mine = {m["name"] for m in c.per_layer} & set(NEW)
    read = set(metrics) & set(NEW)
    assert read == mine & DROPPED            # no card: no device time
    for name in read:
        assert 0.0 <= metrics[name]["value"] <= 100.0
        assert metrics[name]["unit"] == "%"


def _ctx(entry):
    record = ({"entry": "prefill", "tokens": 2000, "batches": [(2, 1000)]}
              if entry == "prefill" else
              {"entry": "generate", "steps": [(64, 2049)] * 4})
    return SimpleNamespace(record=record)


def _program(monkeypatch, recorder):
    """The program's tracing module replaced by one holding ``recorder``
    (or no recorder at all)."""
    mod = types.ModuleType("repro_torch.core.tracing")
    if recorder is not None:
        mod.MODEL_SPANS = recorder
    monkeypatch.setitem(sys.modules, "repro_torch.core.tracing", mod)


@pytest.mark.parametrize("name", sorted(NEW))
def test_a_program_without_the_recorder_gives_none(monkeypatch, name):
    _program(monkeypatch, None)
    for entry in ("prefill", "generate"):
        assert _reader(name).read(_ctx(entry)) is None


class Recorder:
    def __init__(self, device_ms):
        def row(ms):
            return {"calls": 4, "host_ms": 1.0, "device_ms": ms,
                    "self_device_ms": ms}

        spans = {f"{step}/{name}": row(device_ms)
                 for step in ("prefill", "decode")
                 for name in ("attention", "ffn")}
        self.out = {"spans": spans, "counters": {
            "prefill/moe.pairs_kept": 950, "prefill/moe.pairs_routed": 1000,
            "decode/moe.pairs_kept": 512, "decode/moe.pairs_routed": 512}}

    def summary(self):
        return self.out


WANT = {"prefill.attention_us_per_token": ("prefill", 3.0),
        "prefill.moe_us_per_token": ("prefill", 3.0),
        "decode.attention_ms_per_tick": ("generate", 1.5),
        "decode.moe_ms_per_tick": ("generate", 1.5),
        "moe_dropped_pair_share.prefill": ("prefill", 5.0),
        "moe_dropped_pair_share.decode": ("generate", 0.0)}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_arithmetic(monkeypatch, name):
    """6 ms over 2,000 prompt tokens is 3 us a token; over 4 steps, 1.5
    ms a step; 950 of 1,000 pairs kept is 5 % dropped.  Each reads only
    its own step's keys, and a span without device time gives ``None``
    (the counters still read)."""
    entry, want = WANT[name]
    _program(monkeypatch, Recorder(6.0))
    assert _reader(name).read(_ctx(entry)) == pytest.approx(want)
    other = "generate" if entry == "prefill" else "prefill"
    assert _reader(name).read(_ctx(other)) is None
    _program(monkeypatch, Recorder(None))
    got = _reader(name).read(_ctx(entry))
    assert (got == pytest.approx(want)) if name in DROPPED else got is None
