"""Per cent of the traced prefill window with nothing running on the device."""

from ..readers import idle_share


def read(ctx):
    return idle_share(ctx, "prefill")
