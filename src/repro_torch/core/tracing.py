"""Tracing: plan-plane spans, a metrics registry, a flight recorder, and
the model steps' layer spans.

A cold solve crosses seven subsystems -- lint gate, admission control,
fair-share queue, shard/fabric lease, reducer, certifier, joint
co-selection, server promotion -- and aggregate counters cannot say
*which stage* ate the latency between ``submit()`` and the hot-swap.
This module is the observability plane the rest of the repo threads
through:

* :class:`Tracer` -- hierarchical spans with monotonic timestamps and a
  per-ticket ``trace_id``.  The id **propagates over the fabric wire
  protocol** (stamped on lease frames, returned on done frames), so a
  remote worker's lease/eval spans stitch into the driver's trace as
  one tree.  All hooks are guarded by a ``tracer is None`` check at the
  call site, so a service without tracing pays ~0.
* :class:`MetricsRegistry` -- counters, gauges, and bounded histograms
  (p50/p95/p99 over a fixed-size reservoir) behind one write path.
  ``ServiceStats.bump`` mirrors every increment here (as
  ``plan_<counter>`` with a ``tenant`` label), so the registry subsumes
  the ad-hoc stats arithmetic without breaking its exact per-tenant
  reconciliation.  Exposes Prometheus text exposition and JSON.
* :class:`FlightRecorder` -- a bounded ring buffer of the last N
  completed ticket traces.  Dumps Chrome ``trace_event`` JSON
  (``chrome://tracing`` / Perfetto loadable) on demand, and
  automatically on anomaly: a ticket exceeding the latency SLO, a
  certificate rejection, or a telemetry demotion.
* :func:`start_observability_server` -- a tiny stdlib HTTP thread
  serving ``/metrics`` (Prometheus text), ``/traces`` (Chrome trace
  JSON), and ``/stats`` (registry snapshot) for ``launch/serve.py
  --metrics-port``.
* :class:`ModelSpans` (:data:`MODEL_SPANS`) -- spans and counters at the
  layer boundaries of the model's prefill and decode steps, each a
  ``torch.profiler`` range and, on a card, a pair of CUDA events: every
  layer's device time a step, and the MoE layer's kept pairs.  Off unless
  switched on (every span) or under a profile (the spans the benchmark's
  metrics read); off, a span is one load.

Clock discipline: spans carry ``time.perf_counter()`` timestamps local
to the recording process.  Worker-side spans travel as *relative*
offsets from lease receipt and are re-based onto the driver's monotonic
clock at the lease's issue time (attr ``clock="rebased"``) -- good for
attribution and visualization, honest about not being a distributed
clock sync.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


def new_trace_id() -> str:
    """A fresh 16-hex-digit trace id (one per ticket / serve loop)."""
    return uuid.uuid4().hex[:16]


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------


_next_span_id = itertools.count(1).__next__


class Span:
    """One timed stage of a trace.  ``start``/``end`` are
    ``perf_counter`` seconds; ``origin`` names the recording process
    (``"driver"`` or ``"worker-<id>"``) and becomes the Chrome-trace
    thread lane."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "start",
                 "end", "origin", "attrs")

    def __init__(self, trace_id: str, name: str, *,
                 parent_id: Optional[int] = None,
                 start: Optional[float] = None,
                 origin: str = "driver", attrs: Optional[dict] = None):
        self.trace_id = trace_id
        self.span_id = _next_span_id()
        self.parent_id = parent_id
        self.name = name
        self.start = time.perf_counter() if start is None else start
        self.end: Optional[float] = None
        self.origin = origin
        self.attrs = attrs or {}

    @property
    def duration_ms(self) -> float:
        end = self.end if self.end is not None else time.perf_counter()
        return (end - self.start) * 1e3

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id, "name": self.name,
            "start": self.start, "end": self.end, "origin": self.origin,
            "attrs": dict(self.attrs),
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"<Span {self.name} {self.duration_ms:.3f}ms "
                f"origin={self.origin}>")


def spans_to_wire(spans: List[dict], base: float) -> List[dict]:
    """Encode worker-local span dicts (``name``/``start``/``end``/
    ``attrs``) as relative offsets from ``base`` for the done frame."""
    out = []
    for s in spans:
        out.append({"n": s["name"], "s": s["start"] - base,
                    "d": (s["end"] - s["start"]),
                    "a": s.get("attrs") or {}})
    return out


class _NullSpan:
    """No-op stand-in so ``with tracer_or_none_span(...)`` sites stay
    branch-free; never allocated per call."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _LiveSpan:
    """Context manager wrapper closing a span on exit."""

    __slots__ = ("tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self.tracer = tracer
        self.span = span

    def __enter__(self) -> Span:
        return self.span

    def __exit__(self, *exc):
        self.tracer.end(self.span)
        return False


# ---------------------------------------------------------------------------
# Ticket traces + the flight recorder
# ---------------------------------------------------------------------------


@dataclass
class TicketTrace:
    """One completed ticket lifecycle: every span that shares the
    ``trace_id``, driver- and worker-side."""

    trace_id: str
    label: str = ""
    status: str = "ok"
    anomaly: Optional[str] = None
    started: float = 0.0            # perf_counter of the earliest span
    finished: float = 0.0
    spans: List[Span] = field(default_factory=list)
    dropped_spans: int = 0

    @property
    def duration_ms(self) -> float:
        return (self.finished - self.started) * 1e3

    def span_names(self) -> List[str]:
        return [s.name for s in self.spans]

    def origins(self) -> List[str]:
        return sorted({s.origin for s in self.spans})


def chrome_trace_events(traces: List[TicketTrace]) -> List[dict]:
    """Chrome ``trace_event`` complete ("X") events for ``traces``.

    Every event carries the format's required keys -- ``name``,
    ``ph``, ``ts``, ``pid``, ``tid`` (plus ``dur`` for "X" events) --
    with timestamps in microseconds re-based so the earliest span of
    the earliest trace sits at ts=0.  One ``pid`` per trace, one
    ``tid`` lane per span origin, with metadata ("M") events naming
    both, so Perfetto renders one process per ticket and one thread
    per worker.
    """
    events: List[dict] = []
    if not traces:
        return events
    t0 = min(t.started for t in traces if t.spans) \
        if any(t.spans for t in traces) else 0.0
    for pid, trace in enumerate(traces):
        events.append({"name": "process_name", "ph": "M", "ts": 0,
                       "pid": pid, "tid": 0,
                       "args": {"name": f"{trace.label or 'ticket'} "
                                        f"{trace.trace_id}"}})
        tids = {o: i for i, o in enumerate(trace.origins())}
        for origin, tid in sorted(tids.items(), key=lambda kv: kv[1]):
            events.append({"name": "thread_name", "ph": "M", "ts": 0,
                           "pid": pid, "tid": tid,
                           "args": {"name": origin}})
        for s in trace.spans:
            end = s.end if s.end is not None else trace.finished
            events.append({
                "name": s.name, "cat": "plan", "ph": "X",
                "ts": round((s.start - t0) * 1e6, 3),
                "dur": round(max(0.0, (end - s.start)) * 1e6, 3),
                "pid": pid, "tid": tids.get(s.origin, 0),
                "args": {"trace_id": s.trace_id, **s.attrs},
            })
    return events


class FlightRecorder:
    """Bounded ring buffer of the last ``capacity`` completed ticket
    traces, plus the anomaly trigger: traces whose status/anomaly is
    bad or whose duration exceeds ``slo_ms`` are dumped to
    ``trace_dir`` immediately (when one is configured)."""

    def __init__(self, capacity: int = 64, *,
                 slo_ms: Optional[float] = None,
                 trace_dir: Optional[str] = None,
                 metrics: Optional["MetricsRegistry"] = None):
        self.capacity = max(1, int(capacity))
        self.slo_ms = slo_ms
        self.trace_dir = trace_dir
        self.metrics = metrics
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._anomalies: deque = deque(maxlen=256)
        self.recorded = 0
        self.anomaly_dumps = 0

    # -- intake ---------------------------------------------------------------
    def add(self, trace: TicketTrace) -> None:
        anomaly = trace.anomaly
        if anomaly is None and self.slo_ms is not None \
                and trace.duration_ms > self.slo_ms:
            anomaly = "slo-exceeded"
            trace.anomaly = anomaly
        with self._lock:
            self._ring.append(trace)
            self.recorded += 1
        if self.metrics is not None:
            self.metrics.inc("traces_recorded")
            self.metrics.observe("ticket_ms", trace.duration_ms)
        if anomaly is not None:
            self.note_anomaly(anomaly, detail=trace.trace_id,
                              dump=trace)

    def note_anomaly(self, kind: str, detail: str = "",
                     dump: Optional[TicketTrace] = None) -> None:
        """Record an anomaly (SLO breach, cert rejection, demotion) and
        -- when a ``trace_dir`` is configured -- dump the offending
        trace (or the whole ring) for post-mortem."""
        with self._lock:
            self._anomalies.append((time.time(), kind, detail))
        if self.metrics is not None:
            self.metrics.inc("anomalies", kind=kind)
        if self.trace_dir:
            with self._lock:
                n = self.anomaly_dumps
                self.anomaly_dumps += 1
            traces = [dump] if dump is not None else self.traces()
            path = os.path.join(self.trace_dir,
                                f"anomaly_{n:04d}_{kind}.json")
            try:
                self.dump(path, traces=traces)
            except OSError:
                pass                    # observability must never fail serving

    # -- readout --------------------------------------------------------------
    def traces(self) -> List[TicketTrace]:
        with self._lock:
            return list(self._ring)

    def anomalies(self) -> List[Tuple[float, str, str]]:
        with self._lock:
            return list(self._anomalies)

    def chrome_trace(self,
                     traces: Optional[List[TicketTrace]] = None) -> dict:
        """The ring (or ``traces``) as a Chrome-``trace_event`` JSON
        object -- load the dump in ``chrome://tracing`` or Perfetto."""
        return {"traceEvents": chrome_trace_events(
            self.traces() if traces is None else traces),
            "displayTimeUnit": "ms"}

    def dump(self, path: str,
             traces: Optional[List[TicketTrace]] = None) -> str:
        """Write the Chrome trace JSON to ``path``; returns the path."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(traces), f, indent=1)
        return path


# ---------------------------------------------------------------------------
# The tracer
# ---------------------------------------------------------------------------


class Tracer:
    """Records hierarchical spans per ``trace_id`` and hands completed
    traces to the flight recorder.

    The service holds ``tracer = None`` until ``enable_tracing()``;
    every hook site guards with that check, so the disabled cost is one
    attribute load.  Enabled, a span is two ``perf_counter`` calls, a
    small object, and one lock-guarded list append."""

    def __init__(self, *, recorder: Optional[FlightRecorder] = None,
                 metrics: Optional["MetricsRegistry"] = None,
                 max_spans_per_trace: int = 4096):
        self.recorder = recorder
        self.metrics = metrics
        self.max_spans_per_trace = max(16, int(max_spans_per_trace))
        self._lock = threading.Lock()
        self._spans: Dict[str, List[Span]] = {}
        self._dropped: Dict[str, int] = {}
        self._labels: Dict[str, str] = {}

    # -- recording ------------------------------------------------------------
    def begin(self, trace_id: str, name: str, *,
              parent: Optional[Span] = None,
              origin: str = "driver", **attrs) -> Span:
        return Span(trace_id, name,
                    parent_id=parent.span_id if parent is not None else None,
                    origin=origin, attrs=attrs or None)

    def end(self, span: Span, **attrs) -> Span:
        span.end = time.perf_counter()
        if attrs:
            span.attrs.update(attrs)
        self._admit(span)
        return span

    def span(self, trace_id: str, name: str, *,
             parent: Optional[Span] = None, **attrs) -> _LiveSpan:
        """``with tracer.span(tid, "solve") as s: ...`` -- the span
        closes (and records) on exit."""
        return _LiveSpan(self, self.begin(trace_id, name, parent=parent,
                                          **attrs))

    def record(self, trace_id: str, name: str, start: float, end: float,
               *, parent: Optional[Span] = None, origin: str = "driver",
               **attrs) -> Span:
        """Record an already-timed stage retroactively (how the queue
        wait -- measured by timestamps, not an open span -- lands)."""
        span = Span(trace_id, name,
                    parent_id=parent.span_id if parent is not None else None,
                    start=start, origin=origin, attrs=attrs or None)
        span.end = end
        self._admit(span)
        return span

    def instant(self, trace_id: str, name: str, *,
                parent: Optional[Span] = None, origin: str = "driver",
                **attrs) -> Span:
        now = time.perf_counter()
        return self.record(trace_id, name, now, now, parent=parent,
                           origin=origin, **attrs)

    def add_remote_spans(self, trace_id: str, wire_spans: List[dict],
                         *, base: float, origin: str,
                         parent: Optional[Span] = None) -> int:
        """Stitch a worker's relative-offset spans (``{"n","s","d","a"}``
        dicts off a done frame) into the driver's trace, re-based onto
        the driver-side ``base`` timestamp (the lease's issue time)."""
        n = 0
        for w in wire_spans or ():
            try:
                start = base + float(w["s"])
                attrs = dict(w.get("a") or {})
                attrs["clock"] = "rebased"
                self.record(trace_id, str(w["n"]), start,
                            start + float(w["d"]), parent=parent,
                            origin=origin, **attrs)
                n += 1
            except (KeyError, TypeError, ValueError):
                continue                # a malformed span never kills intake
        return n

    def _admit(self, span: Span) -> None:
        with self._lock:
            spans = self._spans.setdefault(span.trace_id, [])
            if len(spans) >= self.max_spans_per_trace:
                self._dropped[span.trace_id] = \
                    self._dropped.get(span.trace_id, 0) + 1
                return
            spans.append(span)

    def label(self, trace_id: str, label: str) -> None:
        with self._lock:
            self._labels[trace_id] = label

    # -- readout / completion -------------------------------------------------
    def spans(self, trace_id: str) -> List[Span]:
        with self._lock:
            return list(self._spans.get(trace_id, ()))

    def live_traces(self) -> List[TicketTrace]:
        """Snapshot of every unfinished trace (the serve loop's rolling
        trace shows up here for ``/traces``)."""
        with self._lock:
            items = [(tid, list(spans))
                     for tid, spans in self._spans.items() if spans]
            labels = dict(self._labels)
            dropped = dict(self._dropped)
        now = time.perf_counter()
        out = []
        for tid, spans in items:
            out.append(TicketTrace(
                trace_id=tid, label=labels.get(tid, ""), status="live",
                started=min(s.start for s in spans), finished=now,
                spans=spans, dropped_spans=dropped.get(tid, 0)))
        return out

    def finish(self, trace_id: str, *, status: str = "ok",
               anomaly: Optional[str] = None,
               label: str = "") -> Optional[TicketTrace]:
        """Close the trace: pop its spans, assemble the
        :class:`TicketTrace`, and hand it to the flight recorder.
        Returns the trace (``None`` if nothing was ever recorded)."""
        with self._lock:
            spans = self._spans.pop(trace_id, None)
            dropped = self._dropped.pop(trace_id, 0)
            label = label or self._labels.pop(trace_id, "")
        if not spans:
            return None
        trace = TicketTrace(
            trace_id=trace_id, label=label, status=status, anomaly=anomaly,
            started=min(s.start for s in spans),
            finished=max(s.end if s.end is not None else s.start
                         for s in spans),
            spans=sorted(spans, key=lambda s: s.start),
            dropped_spans=dropped)
        if self.recorder is not None:
            self.recorder.add(trace)
        return trace

    def note_anomaly(self, kind: str, detail: str = "") -> None:
        """Forward an out-of-band anomaly (cert rejection, demotion) to
        the flight recorder's trigger."""
        if self.recorder is not None:
            self.recorder.note_anomaly(kind, detail)


# ---------------------------------------------------------------------------
# Model-step spans: the layers of a prefill or decode step, timed on the card
# ---------------------------------------------------------------------------


class _Open(threading.local):
    """The thread's step call in progress, or ``None``: one load decides
    whether a span records."""

    step = None


class _StepCall:
    __slots__ = ("name", "stream", "every", "stack")

    def __init__(self, name: str, stream, every: bool):
        self.name = name
        self.stream = stream              # the CUDA stream timed, or None
        self.every = every                # every span, or those read only
        self.stack: List[str] = []        # keys of the open spans


class _StepSpan:
    """One span of a step call: a ``record_function`` range named by its
    key, a pair of CUDA events on the step's stream (none on the CPU),
    and the host's clock."""

    __slots__ = ("rec", "call", "name", "key", "parent", "rf", "ev", "t0")

    def __init__(self, rec: "ModelSpans", call: _StepCall, name: str):
        self.rec, self.call, self.name = rec, call, name

    def __enter__(self):
        import torch

        call = self.call
        self.key = f"{call.name}/{self.name}"
        self.parent = call.stack[-1] if call.stack else None
        call.stack.append(self.key)
        self.rf = torch.profiler.record_function(self.key)
        self.rf.__enter__()
        self.ev = None
        if call.stream is not None:
            self.ev = self.rec._event()
            self.ev.record(call.stream)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host_ms = (time.perf_counter() - self.t0) * 1e3
        end = None
        if self.ev is not None:
            end = self.rec._event()
            end.record(self.call.stream)
        self.rf.__exit__(*exc)
        self.call.stack.pop()
        self.rec._closed(self.call.name, self.name, self.key, self.parent,
                         host_ms, self.ev, end)
        return False


class _StepScope:
    """``ModelSpans.step``'s context: the thread's step call, timed as its
    span ``"step"``."""

    __slots__ = ("rec", "call", "span", "prev")

    def __init__(self, rec: "ModelSpans", name: str, stream, every: bool):
        self.rec = rec
        self.call = _StepCall(name, stream, every)

    def __enter__(self):
        self.prev = self.rec._open.step
        self.rec._open.step = self.call
        self.span = _StepSpan(self.rec, self.call, "step")
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self.span.__exit__(*exc)
        finally:
            self.rec._open.step = self.prev
        # while the card runs this step: the earlier steps' pairs
        self.rec._fold(wait=False)
        return False


class ModelSpans:
    """Spans and counters inside the model's steps, one recorder a
    process (:data:`MODEL_SPANS`).

    ``step(name, device)`` opens a step call (``launch/steps.py``:
    ``"prefill"``, ``"decode"``) and times it as the span
    ``"<step>/step"``; inside it ``span(name)`` times a layer
    (``"<step>/<name>"``, nested in the innermost span open) and
    ``count(name, value)`` adds to the counter ``"<step>/<name>"``.
    Whether a step call records is decided once, when it opens: every
    span while :func:`enable_model_spans` holds; while a
    ``torch.profiler`` profile records, only the spans in :attr:`READ`
    (those a per-layer metric of the benchmark reads) and the counters,
    so that the traced run carries as few ranges and events as its
    metrics need.  Otherwise ``span`` is :data:`NULL_SPAN` after one load
    of the thread's step call, and ``count`` returns at once.

    A recording span opens a ``torch.profiler.record_function`` range
    named by its key (the device trace's clock, beside the kernels it
    launched), records a pair of timing ``torch.cuda.Event`` on the
    step's stream on a card, and reads the host's clock.  Nothing waits
    for the events: the pairs finished when a step has been launched are
    folded into running sums and their events reused.  A span's device
    time is the stream's time between its events, waits for the host
    included.  A tensor counted adds its sum, one reduction on its
    device, kept there until :meth:`summary`.  With a
    :class:`MetricsRegistry` attached (:func:`enable_model_spans`) each
    span's device time is observed there once folded, as
    ``model_span_device_ms`` (labels ``step`` and ``span``).  On the CPU
    there is no device time: ``device_ms`` is ``None``, never the
    host's."""

    # counted tensors kept a counter before they are summed into one
    KEEP = 4096
    # the spans a profile alone records, besides ``step``
    READ = frozenset({"attention", "ffn"})

    def __init__(self):
        self._open = _Open()
        self._lock = threading.Lock()
        self._enabled = False
        self.metrics: Optional[MetricsRegistry] = None
        # key -> [calls, host ms, device ms, children's device ms, timed]
        self._spans: Dict[str, list] = {}
        self._pending: deque = deque()     # (key, parent, labels, ev0, ev1)
        self._pool: List = []
        self._counts: Dict[str, int] = {}
        self._tensors: Dict[tuple, list] = {}   # (key, device) -> sums

    @property
    def enabled(self) -> bool:
        """Whether :func:`enable_model_spans` holds."""
        return self._enabled

    # -- recording ------------------------------------------------------------
    def step(self, name: str, device=None):
        """The context of one step call; on a ``device`` (of the step's
        tensors) that is a card, its spans time that device's current
        stream."""
        import torch

        every = self._enabled
        if not (every or torch.autograd._profiler_enabled()):
            return NULL_SPAN
        stream = None
        if device is not None and torch.device(device).type == "cuda":
            stream = torch.cuda.current_stream(device)
        return _StepScope(self, name, stream, every)

    def span(self, name: str):
        call = self._open.step
        if call is None or not (call.every or name in self.READ):
            return NULL_SPAN
        return _StepSpan(self, call, name)

    def count(self, name: str, value) -> None:
        """Adds ``value`` (an int, or a tensor's sum, taken on its device)
        to the counter ``"<step>/<name>"``."""
        call = self._open.step
        if call is None:
            return
        import torch

        key = f"{call.name}/{name}"
        if not torch.is_tensor(value):
            with self._lock:
                self._counts[key] = self._counts.get(key, 0) + int(value)
            return
        total = value.sum()
        with self._lock:
            kept = self._tensors.setdefault((key, total.device), [])
            kept.append(total)
            if len(kept) >= self.KEEP:
                self._tensors[key, total.device] = _summed(kept)

    def _event(self):
        import torch

        with self._lock:
            if self._pool:
                return self._pool.pop()
        return torch.cuda.Event(enable_timing=True)

    def _closed(self, step, name, key, parent, host_ms, ev0, ev1) -> None:
        with self._lock:
            s = self._spans.get(key)
            if s is None:
                s = self._spans[key] = [0, 0.0, 0.0, 0.0, 0]
            s[0] += 1
            s[1] += host_ms
            if ev0 is not None:
                self._pending.append((key, parent,
                                      {"step": step, "span": name},
                                      ev0, ev1))

    def _fold(self, wait: bool) -> None:
        """Adds the device time of the pending event pairs that have
        finished to their spans, stopping at the first unfinished one;
        with ``wait``, of every pending pair, each waited for."""
        if not self._pending:
            return
        done = []
        with self._lock:
            while self._pending:
                key, parent, labels, ev0, ev1 = self._pending[0]
                if wait:
                    ev1.synchronize()
                elif not ev1.query():
                    break
                self._pending.popleft()
                ms = ev0.elapsed_time(ev1)
                s = self._spans[key]
                s[2] += ms
                s[4] += 1
                if parent is not None:
                    self._spans[parent][3] += ms
                self._pool += (ev0, ev1)
                done.append((labels, ms))
        if self.metrics is not None:
            for labels, ms in done:
                self.metrics.observe("model_span_device_ms", ms, **labels)

    # -- readout --------------------------------------------------------------
    def summary(self) -> dict:
        """``{"spans": {key: {calls, host_ms, device_ms, self_device_ms}},
        "counters": {key: int}}`` of everything recorded since the last
        :meth:`reset`, after one synchronisation where a card was timed.
        ``device_ms`` is ``None`` unless every call of the span was timed
        on a card; ``self_device_ms`` is its device time less that of
        the spans directly inside it."""
        self._fold(wait=True)
        with self._lock:
            counts = dict(self._counts)
            for (key, device), kept in self._tensors.items():
                if len(kept) > 1:
                    self._tensors[key, device] = kept = _summed(kept)
                counts[key] = counts.get(key, 0) + int(kept[0])
            spans = {}
            for key, (calls, host, dev, child, timed) in \
                    sorted(self._spans.items()):
                on_card = timed == calls
                spans[key] = {"calls": calls, "host_ms": host,
                              "device_ms": dev if on_card else None,
                              "self_device_ms": dev - child if on_card
                              else None}
        return {"spans": spans, "counters": dict(sorted(counts.items()))}

    def reset(self) -> None:
        """Forgets every span and counter (pending event pairs too)."""
        with self._lock:
            self._spans.clear()
            self._pending.clear()
            self._counts.clear()
            self._tensors.clear()


def _summed(tensors: list) -> list:
    """One tensor: the sum of ``tensors``, on their device."""
    import torch

    return [torch.stack(tensors).sum()]


MODEL_SPANS = ModelSpans()


def enable_model_spans(metrics: Optional[MetricsRegistry] = None) -> None:
    """Records every span and counter of every step call from now on,
    each span's device time also observed in ``metrics`` where given."""
    MODEL_SPANS._enabled = True
    if metrics is not None:
        MODEL_SPANS.metrics = metrics


def disable_model_spans() -> None:
    """Leaves the recording to a running ``torch.profiler`` profile, and
    detaches the registry."""
    MODEL_SPANS._enabled = False
    MODEL_SPANS.metrics = None


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------


class _Histogram:
    """Bounded-reservoir histogram: exact count/sum/min/max, quantiles
    over the last ``cap`` samples (deterministic sliding window -- the
    recent behavior is what an operator is asking about)."""

    __slots__ = ("samples", "count", "total", "min", "max")

    def __init__(self, cap: int = 512):
        self.samples: deque = deque(maxlen=cap)
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, value: float) -> None:
        v = float(value)
        self.samples.append(v)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def quantile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        ordered = sorted(self.samples)
        idx = min(len(ordered) - 1, max(0, round(q * (len(ordered) - 1))))
        return ordered[idx]

    def summary(self) -> dict:
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "mean": (self.total / self.count) if self.count else 0.0,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_text(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class MetricsRegistry:
    """Counters, gauges, and bounded histograms behind one write path.

    Metric identity is ``(name, sorted labels)``; the exposition key is
    ``name{k="v",...}``.  ``ServiceStats.bump`` mirrors every counter
    increment here as ``plan_<counter>{tenant="..."}`` -- the documented
    ``ServiceStats`` -> ``MetricsRegistry`` mapping -- so the registry
    sees exactly the increments the stats slices reconcile over."""

    def __init__(self, histogram_cap: int = 512):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, tuple], float] = {}
        self._gauges: Dict[Tuple[str, tuple], float] = {}
        self._hists: Dict[Tuple[str, tuple], _Histogram] = {}
        self._hist_cap = max(16, int(histogram_cap))

    # -- the write path -------------------------------------------------------
    def inc(self, name: str, n: float = 1, **labels) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def set_gauge(self, name: str, value: float, **labels) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            self._gauges[key] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            hist = self._hists.get(key)
            if hist is None:
                hist = self._hists[key] = _Histogram(self._hist_cap)
            hist.observe(value)

    # -- readout --------------------------------------------------------------
    def counter(self, name: str, **labels) -> float:
        with self._lock:
            return self._counters.get((name, _label_key(labels)), 0)

    def gauge(self, name: str, **labels) -> Optional[float]:
        with self._lock:
            return self._gauges.get((name, _label_key(labels)))

    def histogram(self, name: str, **labels) -> Optional[dict]:
        with self._lock:
            hist = self._hists.get((name, _label_key(labels)))
            return hist.summary() if hist is not None else None

    def snapshot(self) -> dict:
        """Everything, JSON-serializable, keys flattened to
        ``name{labels}`` exposition form."""
        with self._lock:
            counters = {name + _label_text(k): v
                        for (name, k), v in sorted(self._counters.items())}
            gauges = {name + _label_text(k): v
                      for (name, k), v in sorted(self._gauges.items())}
            hists = {name + _label_text(k): h.summary()
                     for (name, k), h in sorted(self._hists.items())}
        return {"counters": counters, "gauges": gauges,
                "histograms": hists}

    def prometheus(self) -> str:
        """Prometheus text exposition (0.0.4): counters, gauges, and
        histograms as summaries with p50/p95/p99 quantile series."""
        lines: List[str] = []
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            hists = [(name, k, h.summary())
                     for (name, k), h in sorted(self._hists.items())]
        seen = set()
        for (name, k), v in counters:
            if name not in seen:
                seen.add(name)
                lines.append(f"# TYPE {name} counter")
            lines.append(f"{name}{_label_text(k)} {v}")
        for (name, k), v in gauges:
            if name not in seen:
                seen.add(name)
                lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name}{_label_text(k)} {v}")
        for name, k, s in hists:
            if name not in seen:
                seen.add(name)
                lines.append(f"# TYPE {name} summary")
            base = dict(k)
            for q in ("0.5", "0.95", "0.99"):
                lab = _label_text(_label_key({**base, "quantile": q}))
                val = {"0.5": s["p50"], "0.95": s["p95"],
                       "0.99": s["p99"]}[q]
                lines.append(f"{name}{lab} {val}")
            lines.append(f"{name}_sum{_label_text(k)} {s['sum']}")
            lines.append(f"{name}_count{_label_text(k)} {s['count']}")
        return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# /metrics + /traces HTTP endpoint (stdlib only)
# ---------------------------------------------------------------------------


def start_observability_server(metrics: MetricsRegistry,
                               recorder: Optional[FlightRecorder] = None,
                               *, tracer: Optional[Tracer] = None,
                               host: str = "127.0.0.1", port: int = 0):
    """Serve ``/metrics`` (Prometheus text), ``/traces`` (Chrome trace
    JSON: flight-recorder ring + live traces), and ``/stats`` (registry
    snapshot JSON) from a daemon thread.  Returns the
    ``ThreadingHTTPServer`` -- read the bound port off
    ``server.server_address`` and stop it with ``server.shutdown()``.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _send(self, body: bytes, ctype: str, code: int = 200) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib handler API)
            path = self.path.split("?", 1)[0]
            if path == "/metrics":
                self._send(metrics.prometheus().encode(),
                           "text/plain; version=0.0.4")
            elif path == "/traces":
                traces = recorder.traces() if recorder is not None else []
                if tracer is not None:
                    traces = traces + tracer.live_traces()
                body = json.dumps(
                    {"traceEvents": chrome_trace_events(traces),
                     "displayTimeUnit": "ms"}).encode()
                self._send(body, "application/json")
            elif path == "/stats":
                self._send(json.dumps(metrics.snapshot()).encode(),
                           "application/json")
            else:
                self._send(b"not found", "text/plain", 404)

        def log_message(self, *args):    # silence per-request stderr spam
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="observability-http").start()
    return server


__all__ = [
    "FlightRecorder",
    "MODEL_SPANS",
    "MetricsRegistry",
    "ModelSpans",
    "NULL_SPAN",
    "Span",
    "TicketTrace",
    "Tracer",
    "chrome_trace_events",
    "disable_model_spans",
    "enable_model_spans",
    "new_trace_id",
    "spans_to_wire",
    "start_observability_server",
]
