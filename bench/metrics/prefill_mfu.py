"""Per cent of the bfloat16 peak: the prefills' model FLOPs over the window."""

from ..readers import mfu


def read(ctx):
    return mfu(ctx, "prefill")
