"""Per cent of the prefills' routed (token, expert) pairs dropped at
capacity: the counters ``prefill/moe.pairs_kept`` and ``.pairs_routed``."""

from ..spans import dropped_pair_share


def read(ctx):
    return dropped_pair_share(ctx, "prefill", "prefill")
