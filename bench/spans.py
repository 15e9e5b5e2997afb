"""What the readers of the program's own spans and counters share.

The program records them in ``repro_torch.core.tracing.MODEL_SPANS`` while
a profile records, so a traced run holds the window's steps and nothing of
the set-up: each layer's time on the card under ``"<step>/<span>"``
(``"prefill/attention"``, ``"decode/ffn"``, ...) and its counters under
``"<step>/<counter>"``.  That time is the stream's between the span's two
CUDA events, not the trace's busy time: where the card waits for the host
inside a span, the wait counts.  A prefill inside the decode cell's window is
filed under ``"prefill/"`` and is not read by a decode metric.  Against a
program without the recorder, or where it timed no card (the CPU), a
reader gets ``None`` and the metric is left out of the line.
"""

from __future__ import annotations

import sys

from .readers import per_step


def summary():
    """The recorder's summary, or ``None`` where the program has none."""
    try:
        from repro_torch.core.tracing import MODEL_SPANS
    except ImportError:
        return None
    try:
        return MODEL_SPANS.summary()
    except Exception as e:                  # a metric left out, not a run
        print(f"model spans: no summary ({e!r})", file=sys.stderr)
        return None


def device_ms(key):
    """The card's milliseconds of the span ``key``, or ``None`` where it
    was not recorded on a card."""
    s = summary()
    row = None if s is None else s["spans"].get(key)
    return None if row is None else row["device_ms"]


def us_per_token(ctx, key):
    """The prefill span ``key``'s time on the card, in microseconds a
    prompt token of the window."""
    if ctx.record["entry"] != "prefill":
        return None
    ms = device_ms(key)
    return None if ms is None else ms * 1e3 / ctx.record["tokens"]


def ms_per_tick(ctx, key):
    """The decode span ``key``'s time on the card, in milliseconds a step
    of the window."""
    if ctx.record["entry"] != "generate":
        return None
    ms = device_ms(key)
    return None if ms is None else per_step(ctx, ms)


def dropped_pair_share(ctx, step: str, entry: str):
    """Per cent of the MoE layer's routed pairs that its capacity dropped
    in the window's ``step`` calls."""
    if ctx.record["entry"] != entry:
        return None
    s = summary()
    if s is None:
        return None
    kept = s["counters"].get(f"{step}/moe.pairs_kept")
    routed = s["counters"].get(f"{step}/moe.pairs_routed")
    if kept is None or not routed:
        return None
    return 100.0 * (1.0 - kept / routed)
