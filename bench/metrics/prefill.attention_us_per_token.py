"""Microseconds of the attention layers a prompt token: the stream's time
between the events of the program's span ``prefill/attention`` (each
layer's norm, projections, B4 and residual add), the card's waits for the
host inside it included."""

from ..spans import us_per_token


def read(ctx):
    return us_per_token(ctx, "prefill/attention")
