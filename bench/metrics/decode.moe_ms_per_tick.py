"""Milliseconds of the MoE layers a decode step: the stream's time between
the events of the program's span ``decode/ffn``, the card's waits for the
host inside it included."""

from ..spans import ms_per_tick


def read(ctx):
    return ms_per_tick(ctx, "decode/ffn")
