"""Driver ``prefill``: batches of prompts through the program's prefill
step, back to back (a closed loop).

Each batch is ``make_prefill_step(model, max_len)`` on ``rows`` prompts of
one length, then the argmax of the last position's logits, copied to the
host: the batch is done when its greedy tokens are there.  The window runs
whole batches until ``seconds`` have passed.  Set-up warms each length of
the mix once.  The judge reads the tokens and logits of every batch of the
window's first cycle, and the cache of one of them, drawn from the seed.
"""

from __future__ import annotations

import time

import numpy as np

from .. import traffic
from ..reference import judge
from ..weights import derive


def setup(cell) -> dict:
    model, params = cell.model_and_weights()
    mix = cell.traffic
    step = cell.program.make_prefill_step(model, mix["max_len"])
    prompts = traffic.Prompts(mix, cell.arch["vocab"], cell.seed,
                              cell.device)
    warm = traffic.Prompts(mix, cell.arch["vocab"], cell.seed + 1,
                           cell.device)
    for length in sorted(traffic.stratum_lengths(mix), reverse=True):
        logits, _ = step(params, {"tokens": warm.batch(length)})
        logits.argmax(-1).cpu()
    cycle = len(traffic.stratum_lengths(mix))
    keep = int(np.random.default_rng(derive(cell.seed, "keep"))
               .integers(cycle))
    return {"model": model, "params": params, "step": step,
            "prompts": prompts, "lengths": traffic.lengths(mix, cell.seed),
            "cycle": cycle, "keep": keep}


def window(cell, s: dict, tracer) -> dict:
    params, step, prompts = s["params"], s["step"], s["prompts"]
    batches, judged, cache_kept = [], [], None
    with tracer.span("bench.window"):
        t0 = time.perf_counter()
        while True:
            tokens = prompts.batch(next(s["lengths"]))
            with tracer.span("bench.prefill.step"):
                logits, cache = step(params, {"tokens": tokens})
            with tracer.span("bench.prefill.tokens_to_host"):
                logits.argmax(-1).cpu()
            t1 = time.perf_counter()
            batches.append(tuple(tokens.shape))
            done = t1 - t0 >= cell.seconds
            if len(batches) <= s["cycle"]:
                judged.append((tokens, logits.clone()))
            # the drawn batch's cache; the last one's in a window shorter
            # than that
            if len(batches) - 1 == s["keep"] or (done and cache_kept is None):
                cache_kept = cache
            del logits, cache
            if done:
                break
    rows = sum(b for b, _ in batches)
    return {"entry": "prefill", "seconds": t1 - t0, "batches": batches,
            "attempted": rows, "failed": 0,
            "tokens": sum(b * n for b, n in batches), "judged": judged,
            "kept": min(s["keep"], len(judged) - 1), "cache": cache_kept}


def end_to_end(record: dict) -> dict:
    return {"prefill_tokens_per_s": record["tokens"] / record["seconds"]}


def cache_views(cache) -> dict:
    """A prefill's cache as :mod:`bench.reference.judge` reads it: the
    keys and values of attention layer ``i``, Mamba2 block ``i``'s conv
    tail and state."""
    out = {}
    if hasattr(cache, "k"):
        out["kv"] = lambda i: (cache.k[i], cache.v[i])
    if hasattr(cache, "state"):
        out["ssm"] = lambda i: (cache.conv[i], cache.state[i])
    return out


def judge_numbers(cell, s: dict, record: dict):
    return judge.prefill(cell.stated, cell.family, s["params"],
                         record["judged"], record["kept"],
                         cache_views(record["cache"]))


def control_numbers(cell, s: dict, record: dict, prec):
    """The control in the program's place: the reference in ``prec`` on
    the judged batches, judged as the program's outputs are."""
    arch, kept = cell.stated, record["kept"]
    batches, cache = [], None
    for j, (tokens, _) in enumerate(record["judged"]):
        obs = judge.observe(arch, cell.family, s["params"], tokens, prec,
                            cache=j == kept)
        batches.append((tokens, obs["logits"]))
        if j == kept:
            cache = obs
    return judge.prefill(arch, cell.family, s["params"], batches, kept,
                         cache)
