"""Device operations (kernels, copies, fills) launched a decode step."""

from ..readers import per_step


def read(ctx):
    if ctx.record["entry"] != "generate":
        return None
    return per_step(ctx, ctx.trace.launches)
