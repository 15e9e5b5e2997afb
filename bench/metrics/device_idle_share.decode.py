"""Per cent of the traced decode window with nothing running on the device."""

from ..readers import idle_share


def read(ctx):
    return idle_share(ctx, "generate")
