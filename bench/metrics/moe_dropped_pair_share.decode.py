"""Per cent of the decode steps' routed (token, expert) pairs dropped at
capacity: the counters ``decode/moe.pairs_kept`` and ``.pairs_routed``."""

from ..spans import dropped_pair_share


def read(ctx):
    return dropped_pair_share(ctx, "decode", "generate")
