"""The one generator of the benchmark's traffic, read from a mix's data file.

A mix (``bench/traffic/<name>.json``) gives the rows a batch carries
(``rows``), the prompt lengths (``prompt``: ``[lo, hi]`` for lengths
spread uniformly over that range, or one length), and ``strata``: the
range is cut into that many equal strata and each cycle of batches takes
the middle length of every stratum once, in an order drawn from the seed.
So every seed runs the same set of lengths and only their order and the
tokens change with it, and a window of a few cycles sees the range
evenly.  Token ids are uniform over the vocabulary.  What a mix's entry
does with the batches (``driver``, ``max_len`` and the driver's own keys)
is the driver's.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np
import torch

from .weights import derive


def stratum_lengths(mix: dict) -> List[int]:
    """The lengths of one cycle, in stratum order."""
    prompt = mix["prompt"]
    if isinstance(prompt, int):
        return [prompt]
    lo, hi = prompt
    n = mix.get("strata", 1)
    return [int(lo + (k + 0.5) * (hi - lo) / n) for k in range(n)]


def lengths(mix: dict, seed: int) -> Iterator[int]:
    """Batch lengths, cycle after cycle, each cycle in its own order."""
    rng = np.random.default_rng(derive(seed, "lengths"))
    cycle = stratum_lengths(mix)
    while True:
        for i in rng.permutation(len(cycle)):
            yield cycle[i]


class Prompts:
    """Token batches of a mix from ``seed``, drawn on ``device``."""

    def __init__(self, mix: dict, vocab: int, seed: int, device):
        self.rows, self.vocab = mix["rows"], vocab
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(derive(seed, "tokens"))
        self.device = device

    def batch(self, length: int) -> torch.Tensor:
        return torch.randint(0, self.vocab, (self.rows, length),
                             generator=self.gen, device=self.device)
