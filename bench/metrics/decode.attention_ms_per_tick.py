"""Milliseconds of the attention layers a decode step: the stream's time
between the events of the program's span ``decode/attention`` (each
layer's norm, projections, cache write, decode attention over the buffer
and residual add), the card's waits for the host inside it included."""

from ..spans import ms_per_tick


def read(ctx):
    return ms_per_tick(ctx, "decode/attention")
