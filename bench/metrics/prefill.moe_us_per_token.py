"""Microseconds of the MoE layers a prompt token: the stream's time between
the events of the program's span ``prefill/ffn`` (each layer's norm,
router, dispatch, experts, combine and residual add), the card's waits for
the host inside it included."""

from ..spans import us_per_token


def read(ctx):
    return us_per_token(ctx, "prefill/ffn")
