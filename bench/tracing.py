"""The traced run: ``torch.profiler`` over the window, read into what the
per-layer metrics and the ``breakdown`` need.

Spans are the benchmark's own ``record_function`` ranges around its calls
into the program (names starting ``bench.``); the program's own spans are
not read yet.  From the device's events: the busy time (the union of
their intervals), launches, time by operation name; from the gaps between
them inside the ``bench.window`` span: idle time by the benchmark span
the host was in when the gap began (``bench.window`` itself where it was
between two of them).
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW = "bench.window"


@dataclass
class Trace:
    busy_s: float
    window_s: float
    launches: int
    kernels: Dict[str, Tuple[int, float]]        # name -> (launches, s)
    idle_by_span: Dict[str, float] = field(default_factory=dict)

    def matching(self, parts) -> Tuple[int, float]:
        """Launches and seconds of the operations whose name holds one of
        ``parts``."""
        n = s = 0
        for name, (k, t) in self.kernels.items():
            if any(p in name for p in parts):
                n, s = n + k, s + t
        return n, s

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:top]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[name[:120], s] for name, (_, s) in ops],
                "idle_gaps": [[name, s] for name, s in gaps]}


class Tracer:
    """``span(name)`` ranges that cost nothing untraced; ``with tracer:``
    profiles what it encloses when tracing."""

    def __init__(self, on: bool, device: str = "cuda"):
        self.on, self.device = on, device
        self.prof = None

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def read(self) -> Trace:
        return summarise(_events(self.prof))


def _device_op(e, DeviceType) -> bool:
    """Whether a kineto event ran on the device as an operation, and not
    as the device's mirror of a host range."""
    return e.device_type() != DeviceType.CPU and not e.is_user_annotation()


def _events(prof) -> List[Tuple[str, str, float, float]]:
    """``(name, kind, start_us, end_us)`` of the profiled events that count:
    kind ``"op"`` for an operation on the device (a kernel, a copy, a
    fill; not the device's mirror of a host range), ``"span"`` for a
    host range of the benchmark's."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        kind = ("span" if e.device_type() == DeviceType.CPU
                and e.name().startswith("bench.") else
                "op" if _device_op(e, DeviceType) else None)
        if kind:
            start = e.start_ns() / 1e3
            out.append((e.name(), kind, start, start + e.duration_ns() / 1e3))
    return out


def summarise(events) -> Trace:
    spans = [(a, b, n) for n, kind, a, b in events if kind == "span"]
    window = [(a, b) for a, b, n in spans if n == WINDOW]
    if not window:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    w0, w1 = window[0]
    ops = sorted((a, b, n) for n, kind, a, b in events if kind == "op")
    kernels: Dict[str, List[float]] = {}
    busy, cur0, cur1, gaps = 0.0, None, None, []
    for a, b, n in ops:
        k = kernels.setdefault(n, [0, 0.0])
        k[0] += 1
        k[1] += (b - a) / 1e6
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if cur1 is None or a > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
                gaps.append((cur1, a))
            elif a > w0:
                gaps.append((w0, a))
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur1 is not None:
        busy += cur1 - cur0
        gaps.append((cur1, w1))
    else:
        gaps.append((w0, w1))
    # the spans inside the window follow each other without nesting
    leaf = sorted((a, b, n) for a, b, n in spans if n != WINDOW)
    starts = [s[0] for s in leaf]
    idle: Dict[str, float] = {}
    for a, b in gaps:
        i = bisect.bisect_right(starts, a) - 1
        name = leaf[i][2] if i >= 0 and a < leaf[i][1] else WINDOW
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    return Trace(busy_s=busy / 1e6, window_s=(w1 - w0) / 1e6,
                 launches=sum(k[0] for k in kernels.values()),
                 kernels={n: (k[0], k[1]) for n, k in kernels.items()},
                 idle_by_span=idle)
