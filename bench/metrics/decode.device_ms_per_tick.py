"""Milliseconds of device time (the union of its operations) a decode step."""

from ..readers import per_step


def read(ctx):
    if ctx.record["entry"] != "generate":
        return None
    return per_step(ctx, ctx.trace.busy_s * 1e3)
