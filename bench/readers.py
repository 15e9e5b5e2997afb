"""What the per-layer metrics' readers share: a kernel's share of its
roofline, the model's share of the chip's peak, and the device's idle
share, from the traced run.

A reader (``bench/metrics/<metric>.py``) is ``read(ctx) -> float or
None``; ``ctx`` holds ``trace`` (:class:`bench.tracing.Trace`), ``record``
(the driver's account of its window: ``entry``, ``seconds``, and
``batches`` of ``(rows, length)`` or ``steps`` of ``(rows, keys)``),
``arch``, ``family``, ``peaks`` (``bench/peaks.json``'s row of the
device, or ``None``) and ``root``.  ``None`` leaves the metric out of the
line: nothing to read, or a count that does not match the program's.
"""

from __future__ import annotations

import importlib
import sys


def _module(kind: str, name: str):
    return importlib.import_module(f"bench.{kind}.{name}")


def roofline_share(ctx, kernel: str, entry: str):
    """Per cent of its roofline that ``kernel`` reached over the window's
    calls: the least time the chip could take for them (each call's
    operations over the peak of ``PEAK``, or its bytes over the memory
    bandwidth, whichever is longer) over the kernel's device time."""
    if ctx.record["entry"] != entry or ctx.peaks is None:
        return None
    mod = _module("rooflines", kernel)
    calls = mod.calls(ctx.arch, ctx.family, ctx.record)
    launches, seconds = ctx.trace.matching(mod.KERNELS)
    if not calls or not launches:
        return None
    if launches != len(calls):
        print(f"{kernel}: {launches} launches traced, {len(calls)} "
              f"calls expected; its roofline is left out", file=sys.stderr)
        return None
    peak = ctx.peaks[mod.PEAK] if mod.PEAK else float("inf")
    least = sum(max(f / peak, b / ctx.peaks["bytes_per_s"])
                for f, b in calls)
    return 100.0 * least / seconds


def model_flops(ctx) -> float:
    """The model FLOPs of the window's work (``bench/flops/<family>.py``),
    from the configuration's widths and the lengths run."""
    mod = _module("flops", ctx.family)
    rec = ctx.record
    if rec["entry"] == "prefill":
        return sum(mod.prefill(ctx.arch, b, s) for b, s in rec["batches"])
    return sum(mod.decode(ctx.arch, b, k) for b, k in rec["steps"])


def mfu(ctx, entry: str):
    """Per cent of the chip's bfloat16 peak that the window's model FLOPs
    are, over the window's wall time."""
    if ctx.record["entry"] != entry or ctx.peaks is None:
        return None
    return 100.0 * model_flops(ctx) / ctx.record["seconds"] / ctx.peaks["bf16"]


def idle_share(ctx, entry: str):
    """Per cent of the traced window in which no operation ran on the
    device."""
    if ctx.record["entry"] != entry:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def per_step(ctx, value: float):
    steps = len(ctx.record.get("steps", ()))
    return value / steps if steps else None
