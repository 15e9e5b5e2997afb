"""B4's share of its roofline over the traced prefills."""

from ..readers import roofline_share


def read(ctx):
    return roofline_share(ctx, "flash_attention", "prefill")
