#!/usr/bin/env python3
"""How far gemma3-12b's decode moves when only the order of its rounding
changes, beside how far the ring-banked decode lies from it, on the card.

    python3 scripts/ring_spread.py [--layers 48] [--seed 0] [--steps 8]

Builds gemma3-12b at full width (``--layers`` cuts its depth), writes one
random bf16 K/V history of 1,100 positions into a ``KVCache`` of 1,152
rows, a copy of it and a ``GroupedKVCache`` (the ring of 1,024 has
wrapped), then runs ``--steps`` decode steps: ``decode_step`` (the decode
einsum over the whole buffer), ``decode_step`` with ``block_k=2048`` on the
copy (the same function, its attention reduced in one online-softmax
block) and ``grouped_decode_step``, each fed the first's argmax.  Prints one
JSON line: per step, the largest absolute logit difference of the second
and of the third from the first, and how far each lies past the bound of
the JAX package's ``tests/test_perf_variants.py`` (atol 0.05, rtol 0.02;
<= 0 is within it).
"""

import argparse
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(1, HERE)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.models import get_model
    from repro_torch.models import transformer as tfm

    if not torch.cuda.is_available():
        raise SystemExit("this script needs a CUDA device")

    def diff(a, b):
        return {"max_abs": float((a.float() - b.float()).abs().max()),
                "bound_excess": cs.bound_excess(a, b, *cs.VARIANT_TOL)}

    cfg = get_arch("gemma3_12b")
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    params = get_model(cfg).init(gen, device="cuda")
    B, max_len, history = 2, 1152, 1100
    full, ring = cs.ring_history(torch, cfg, gen, B, max_len, history)
    other = tfm.KVCache(full.k.clone(), full.v.clone(), history)
    tok = torch.randint(2, cfg.vocab - 1, (B, 1), generator=gen,
                        device="cuda", dtype=torch.int32)
    steps = []
    for _ in range(args.steps):
        a, full = tfm.decode_step(cfg, params, full, tok)
        b, other = tfm.decode_step(cfg, params, other, tok, block_k=2048)
        c, ring = tfm.grouped_decode_step(cfg, params, ring, tok)
        steps.append({"dense_reordered": diff(a, b), "ring": diff(a, c)})
        tok = a.argmax(-1).to(torch.int32)[:, None]
    print(json.dumps({"arch": cfg.name, "layers": cfg.n_layers,
                      "seed": args.seed, "card": torch.cuda.get_device_name(0),
                      "logit_std": float(a.float().std()), "steps": steps}))


if __name__ == "__main__":
    main()
