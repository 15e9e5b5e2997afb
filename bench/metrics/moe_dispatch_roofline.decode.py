"""B5's share of its roofline over the traced decode steps."""

from ..readers import roofline_share


def read(ctx):
    return roofline_share(ctx, "moe_dispatch", "generate")
