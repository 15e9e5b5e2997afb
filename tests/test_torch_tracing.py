# tests/test_tracing.py of the JAX package, run against repro_torch: the same
# cases on the port's plan plane (CPU tensors where a case builds a server).
"""Observability plane: Tracer spans, MetricsRegistry, FlightRecorder
(repro_torch.core.tracing + PlanService integration).

Covers the metrics registry write paths (counters with labels, gauges,
bounded histogram quantiles, Prometheus text exposition), the tracer
span lifecycle (begin/end nesting, retroactive record, finish popping
the live trace into the recorder), the flight recorder's bounded ring
and anomaly dumps, Chrome ``trace_event`` required keys, the traced
1-shard solve + /metrics HTTP smoke the CI step runs (``-k smoke``).
The fabric stories (worker spans stitched into the driver's trace, a
worker kill's requeue span) need a solve fabric, which this package does
not have yet.
"""

import itertools
import json
import threading
import time
import urllib.request

import pytest

from repro_torch.core import (AccessDecl, Counter, Ctrl, FlightRecorder,
                              MemorySpec, MetricsRegistry, PlanService,
                              Program, QoSClass, Sched, TenantRegistry,
                              Tracer, chrome_trace_events, new_trace_id,
                              start_observability_server)
from repro_torch.core.planner import BankingPlanner
from repro_torch.core.polytope import Affine


_UID = itertools.count()


def _program(tag):
    """A unique banking problem per call (identity is structural, so
    uniqueness comes from distinct memory dims)."""
    name = f"{tag}{next(_UID)}"
    mem = MemorySpec(name, dims=(256 + 8 * next(_UID),), word_bits=32,
                     ports=1)
    return Program(
        root=Ctrl("reader", Sched.INNER,
                  counters=[Counter("i", 0, 1, 32, par=8)],
                  accesses=[AccessDecl(name, (Affine.of(i=1),))]),
        memories={name: mem},
    ), name


# ---------------------------------------------------------------------------
# MetricsRegistry
# ---------------------------------------------------------------------------


def test_metrics_counters_and_gauges_with_labels():
    m = MetricsRegistry()
    m.inc("solves")
    m.inc("solves", 2, tenant="a")
    m.inc("solves", tenant="a")
    m.set_gauge("queue_depth", 7)
    m.set_gauge("queue_depth", 3, tenant="a")
    assert m.counter("solves") == 1
    assert m.counter("solves", tenant="a") == 3
    assert m.counter("never_bumped") == 0
    assert m.gauge("queue_depth") == 7
    assert m.gauge("queue_depth", tenant="a") == 3
    snap = m.snapshot()
    assert snap["counters"]['solves{tenant="a"}'] == 3
    assert snap["gauges"]["queue_depth"] == 7


def test_metrics_histogram_quantiles_stay_bounded():
    m = MetricsRegistry(histogram_cap=64)
    for v in range(1000):            # way past cap: reservoir must bound
        m.observe("lat_ms", float(v))
    h = m.histogram("lat_ms")
    assert h["count"] == 1000
    assert len(m._hists[("lat_ms", ())].samples) <= 64
    assert h["min"] <= h["p50"] <= h["p95"] <= h["p99"] <= h["max"]
    assert h["max"] == 999.0
    # a fresh single-sample histogram degenerates sanely
    m.observe("one", 5.0)
    h1 = m.histogram("one")
    assert h1["p50"] == h1["p99"] == 5.0 and h1["count"] == 1


def test_prometheus_exposition_format():
    m = MetricsRegistry()
    m.inc("plan_submits", 4, tenant="acme")
    m.set_gauge("queue_depth", 2)
    m.observe("ticket_ms", 12.5)
    text = m.prometheus()
    lines = text.splitlines()
    assert 'plan_submits{tenant="acme"} 4' in lines
    assert "queue_depth 2.0" in lines
    assert any(ln.startswith("ticket_ms_count 1") for ln in lines)
    assert any('ticket_ms{quantile="0.5"}' in ln for ln in lines)
    assert any(ln.startswith("# TYPE plan_submits counter")
               for ln in lines)


# ---------------------------------------------------------------------------
# Tracer + FlightRecorder
# ---------------------------------------------------------------------------


def test_tracer_span_lifecycle_and_finish():
    rec = FlightRecorder(capacity=8)
    tr = Tracer(recorder=rec)
    tid = new_trace_id()
    root = tr.begin(tid, "ticket", memory="m0")
    with tr.span(tid, "lint"):
        pass
    t0 = time.perf_counter()
    time.sleep(0.002)
    tr.record(tid, "queue-wait", t0, time.perf_counter())
    tr.instant(tid, "requeue", worker=3)
    tr.end(root, status="ok")
    assert tid in [t.trace_id for t in tr.live_traces()]
    trace = tr.finish(tid, status="ok")
    assert tid not in [t.trace_id for t in tr.live_traces()]
    names = [s.name for s in trace.spans]
    assert sorted(names) == ["lint", "queue-wait", "requeue", "ticket"]
    waited = next(s for s in trace.spans if s.name == "queue-wait")
    assert waited.duration_ms >= 2.0
    assert trace.status == "ok"
    assert rec.traces()[-1] is trace


def test_flight_recorder_ring_bound_and_anomaly_dump(tmp_path):
    rec = FlightRecorder(capacity=4, trace_dir=str(tmp_path))
    tr = Tracer(recorder=rec)
    tids = []
    for i in range(10):
        tid = new_trace_id()
        tids.append(tid)
        with tr.span(tid, "work", i=i):
            pass
        tr.finish(tid, status="ok")
    kept = rec.traces()
    assert len(kept) == 4                       # ring stays bounded
    assert [t.trace_id for t in kept] == tids[-4:]
    # an anomaly dumps the implicated trace to the trace dir
    tid = new_trace_id()
    with tr.span(tid, "work"):
        tr.note_anomaly("cert-rejection", detail="deadbeef")
    tr.finish(tid, status="ok")
    dumps = list(tmp_path.glob("*.json"))
    assert dumps, "anomaly produced no dump"
    payload = json.loads(dumps[0].read_text())
    assert payload["traceEvents"]
    assert any(("cert-rejection", "deadbeef") == (kind, detail)
               for _, kind, detail in rec.anomalies())


def test_slo_breach_counts_as_anomaly():
    rec = FlightRecorder(capacity=4, slo_ms=0.0)     # everything breaches
    tr = Tracer(recorder=rec)
    tid = new_trace_id()
    with tr.span(tid, "work"):
        time.sleep(0.001)
    tr.finish(tid, status="ok")
    assert any(kind == "slo-exceeded" for _, kind, _ in rec.anomalies())


def test_chrome_trace_events_required_keys():
    tr = Tracer()
    tid = new_trace_id()
    root = tr.begin(tid, "ticket")
    with tr.span(tid, "lease"):
        pass
    tr.end(root)
    trace = tr.finish(tid, status="ok")
    events = chrome_trace_events([trace])
    assert events
    for e in events:
        for key in ("name", "ph", "ts", "pid", "tid"):
            assert key in e, f"{key} missing from {e}"
        if e["ph"] == "X":
            assert "dur" in e and e["dur"] >= 0
    assert any(e["ph"] == "M" for e in events)   # process/thread names
    assert min(e["ts"] for e in events if e["ph"] == "X") == 0


def test_remote_span_rebasing():
    """Wire spans from another clock domain land inside the driver's
    timeline, offset from the supplied base timestamp."""
    from repro_torch.core.tracing import spans_to_wire
    tr = Tracer()
    tid = new_trace_id()
    base = time.perf_counter()
    wire = spans_to_wire(
        [{"name": "w-eval", "start": base + 0.010, "end": base + 0.030,
          "attrs": {"evaluated": 5}}], base)
    tr.add_remote_spans(tid, wire, base=base, origin="worker-9")
    (span,) = tr.spans(tid)
    assert span.origin == "worker-9"
    assert span.start == pytest.approx(base + 0.010, abs=1e-5)
    assert span.duration_ms == pytest.approx(20.0, abs=0.1)
    assert span.attrs["evaluated"] == 5 and span.attrs["clock"] == "rebased"


# ---------------------------------------------------------------------------
# Service integration
# ---------------------------------------------------------------------------


def test_smoke_traced_solve_and_metrics_endpoint():
    """The CI observability gate: a traced 1-shard cold solve produces a
    valid Chrome trace and a scrapeable /metrics endpoint."""
    svc = PlanService(workers=1)
    svc.enable_tracing()
    prog, mem = _program("sm")
    ticket = svc.submit(prog, mem, use_cache=False, shard_budget=1)
    plan = ticket.result(timeout=120)
    assert plan.best is not None
    trace = next(t for t in svc.recorder.traces()
                 if t.trace_id == ticket.trace_id)
    names = [s.name for s in trace.spans]
    for expected in ("prepare", "queue-wait", "enumerate", "shard-eval",
                     "reduce", "ticket"):
        assert expected in names, f"{expected} not in {names}"
    chrome = svc.recorder.chrome_trace()
    for e in chrome["traceEvents"]:
        for key in ("name", "ph", "ts", "pid", "tid"):
            assert key in e
    assert svc.metrics.counter("plan_solved", tenant="default") == 1
    assert svc.metrics.histogram("ticket_ms")["count"] == 1
    server = start_observability_server(svc.metrics, svc.recorder,
                                        tracer=svc.tracer, port=0)
    try:
        host, port = server.server_address[:2]
        body = urllib.request.urlopen(
            f"http://{host}:{port}/metrics", timeout=10).read().decode()
        assert "plan_solved" in body and "ticket_ms" in body
        traces = json.loads(urllib.request.urlopen(
            f"http://{host}:{port}/traces", timeout=10).read())
        assert traces["traceEvents"]
    finally:
        server.shutdown()
    svc.shutdown()


def test_ticket_as_dict_reports_queue_and_deferred_ms():
    """A ticket deferred by admission then queued reports both waits in
    as_dict(), and its trace carries the matching span chain."""
    reg = TenantRegistry()
    reg.register("lim", QoSClass("lim", max_inflight=1))
    gate = threading.Event()
    real = BankingPlanner.build_space
    calls = []

    def gated(self, prep):
        calls.append(prep.mem.name)
        if len(calls) == 1:
            gate.wait(30)
        return real(self, prep)

    BankingPlanner.build_space = gated
    try:
        svc = PlanService(workers=1, tenants=reg)
        svc.enable_tracing()
        t1 = svc.submit(*_program("q"), tenant="lim")   # holds the slot
        t2 = svc.submit(*_program("q"), tenant="lim")
        assert t2.deferred
        time.sleep(0.01)                   # accrue measurable deferral
        gate.set()
        assert t1.result(timeout=120) is not None
        assert t2.result(timeout=120) is not None
        d = t2.as_dict()
        assert d["deferred_ms"] > 0
        assert d["queue_ms"] >= 0
        trace = next(t for t in svc.recorder.traces()
                     if t.trace_id == t2.trace_id)
        names = [s.name for s in trace.spans]
        assert "admission-deferred" in names
        assert "deferred-wait" in names
        assert "queue-wait" in names
        waited = next(s for s in trace.spans if s.name == "deferred-wait")
        assert waited.duration_ms == pytest.approx(d["deferred_ms"],
                                                   rel=0.5)
        svc.shutdown()
    finally:
        BankingPlanner.build_space = real
        gate.set()


def test_tracing_disabled_leaves_no_observable_state():
    """With tracing off (the default), tickets carry no trace_id and the
    service keeps no recorder/metrics -- the hooks are inert."""
    svc = PlanService(workers=1)
    prog, mem = _program("off")
    ticket = svc.submit(prog, mem, use_cache=False)
    assert ticket.result(timeout=120) is not None
    assert ticket.trace_id is None
    assert svc.tracer is None and svc.recorder is None \
        and svc.metrics is None
    d = ticket.as_dict()
    assert d["queue_ms"] >= 0 and d["deferred_ms"] == 0.0
    svc.shutdown()
