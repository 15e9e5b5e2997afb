"""The decode-attention kernel's share of its roofline over the traced
decode steps."""

from ..readers import roofline_share


def read(ctx):
    return roofline_share(ctx, "decode_attention", "generate")
