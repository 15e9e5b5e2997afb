"""Driver ``generate``: greedy decoding of a batch of rows in lockstep, as
offline batch generation runs it (a closed loop).

Set-up prefills ``rows`` prompts of ``prompt`` tokens into one cache
``max_len`` long, ``prefill_rows`` rows a call of the program's prefill
step (each call's cache copied into the batch's, whose layout the
program's ``init_cache`` gives), then warms the serve step with
``warm_steps`` steps.  The window runs ``make_serve_step`` and feeds each
step's greedy tokens to the next; each step's tokens are copied to the
host as a stream delivers them.  When the cache is full, the next batch of
prompts is prefilled inside the window, and its time counts.  The last
batch in flight at the window's close is judged: its prompts, every token
served to it, the logits of its first and last steps, and its cache.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import traffic
from ..reference import judge
from ..tracing import Tracer


def _prefill_batch(cell, s: dict) -> dict:
    """A new batch: prompts, the program's prefill into one cache, and the
    first greedy tokens."""
    mix = cell.traffic
    rows, group = mix["rows"], mix["prefill_rows"]
    prompts = s["prompts"].batch(mix["prompt"])
    cache = s["model"].init_cache(rows, mix["max_len"], device=cell.device)
    first = []
    for lo in range(0, rows, group):
        logits, part = s["prefill"](s["params"],
                                    {"tokens": prompts[lo:lo + group]})
        first.append(logits.argmax(-1).to(torch.int32))
        for whole, block in zip(cache, part):
            if torch.is_tensor(whole):
                dim = next(d for d, (a, b) in enumerate(
                    zip(whole.shape, block.shape)) if a != b)
                whole.narrow(dim, lo, block.shape[dim]).copy_(block)
        del logits, part
    cache = cache._replace(pos=mix["prompt"])
    tok = torch.cat(first)[:, None]
    return {"prompts": prompts, "cache": cache, "tok": tok,
            "served": [tok.cpu()], "logits": {}}


def setup(cell) -> dict:
    model, params = cell.model_and_weights()
    mix = cell.traffic
    s = {"model": model, "params": params,
         "prefill": cell.program.make_prefill_step(model, mix["max_len"]),
         "serve": cell.program.make_serve_step(model),
         "prompts": traffic.Prompts(mix, cell.arch["vocab"], cell.seed,
                                    cell.device)}
    s["batch"] = _prefill_batch(cell, s)
    for _ in range(mix["warm_steps"]):
        _step(s, Tracer(False))
    return s


def _step(s: dict, tracer) -> float:
    """One serve step of the batch in flight; returns when its tokens
    reached the host."""
    b = s["batch"]
    with tracer.span("bench.generate.step"):
        tok, logits, cache = s["serve"](s["params"], b["cache"], b["tok"])
    with tracer.span("bench.generate.tokens_to_host"):
        host = tok.cpu()
    b["tok"], b["cache"] = tok, cache
    b["served"].append(host)
    j = len(b["served"]) - 1          # the served index of these logits
    if not b["logits"]:
        b["logits"][j] = logits
    b["last"] = (j, logits)
    return time.perf_counter()


def window(cell, s: dict, tracer) -> dict:
    mix = cell.traffic
    rows = mix["rows"]
    gaps, steps, refills = [], [], 0
    with tracer.span("bench.window"):
        t0 = last = time.perf_counter()
        while True:
            b = s["batch"]
            if b["cache"].pos >= mix["max_len"]:
                with tracer.span("bench.generate.refill"):
                    s["batch"] = None
                    del b
                    s["batch"] = _prefill_batch(cell, s)
                refills += 1
                t = time.perf_counter()
            else:
                steps.append((rows, b["cache"].pos + 1))
                t = _step(s, tracer)
            gaps.append(t - last)
            last = t
            # a new batch takes one step at least, so its logits are judged
            if t - t0 >= cell.seconds and "last" in s["batch"]:
                break
    served = rows * len(gaps)
    return {"entry": "generate", "seconds": last - t0, "steps": steps,
            "refills": refills, "gaps": np.repeat(np.array(gaps), rows),
            "attempted": served, "failed": 0, "tokens": served}


def end_to_end(record: dict) -> dict:
    return {"decode_tokens_per_s": record["tokens"] / record["seconds"],
            "decode_gap_p95_ms": float(np.percentile(record["gaps"], 95))
            * 1e3}


def _judged(cell, s: dict):
    """The last batch: its fed sequence, served tokens and layout."""
    mix = cell.traffic
    b = s["batch"]
    j, logits = b["last"]
    b["logits"][j] = logits
    served = torch.cat(b["served"], dim=1).to(cell.device)   # (R, n + 1)
    fed = torch.cat([b["prompts"], served[:, :-1].long()], dim=1)
    return b, fed, served, layout(mix, fed.shape[1], fed.device)


def layout(mix: dict, length: int, device=None):
    """Which call of the program routed each position together, and its
    place there: a prefill call's rows, then each decode step's row
    tokens (the groups the MoE capacity counts over)."""
    rows, group, P = mix["rows"], mix["prefill_rows"], mix["prompt"]
    r = torch.arange(rows, device=device)[:, None]
    p = torch.arange(length, device=device)[None, :]
    n_pre = -(-rows // group)
    in_prompt = p < P
    g = torch.where(in_prompt, r // group, n_pre + p - P)
    order = torch.where(in_prompt, (r % group) * P + p, r)
    return g, order


def observed(cell, s: dict) -> dict:
    b = s["batch"]
    cache = b["cache"]
    return {"kv": lambda i: (cache.k[i], cache.v[i]),
            "logits": b["logits"]}


def judge_numbers(cell, s: dict, record: dict):
    b, fed, served, lay = _judged(cell, s)
    obs = observed(cell, s)
    return judge.generate(cell.stated, cell.family, s["params"],
                          fed, served, lay, obs)


def control_numbers(cell, s: dict, record: dict, prec):
    """The control in the program's place: the reference in ``prec`` over
    the same prompts and fed tokens; at each position the token it puts
    first is judged, and its logits at the served indices kept."""
    b, fed, served, lay = _judged(cell, s)
    keep = tuple(b["logits"])
    obs = judge.observe(cell.stated, cell.family, s["params"], fed,
                        prec, layout=lay, positions=served.shape[1],
                        keep=keep)
    return judge.generate(cell.stated, cell.family, s["params"], fed,
                          obs["greedy"], lay, obs)
