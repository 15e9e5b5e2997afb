"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Runs the continuous-batching server against synthetic requests and reports
throughput; ``--smoke`` uses the reduced config (CPU-sized).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
        --smoke --device cpu --requests 8 --max-batch 4

Any family that ``models.get_model`` builds serves: the dense transformers
and the MoE family (its expert buffer filled by the ``moe_dispatch``
kernel on the card).

The server starts on the trivial single-bank artifact, the KV-pool banking
problem is solved in the launcher, and the page pool and token-record table
hot-swap to the solved layout before the next decode tick.  The flags that
need the planning plane (plan store, solve fabric, telemetry, verification,
tenants, joint planning, tracing, metrics) are not in this launcher yet.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model, the cache and the record table "
                         "live (default cuda; fails without a card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..configs import get_arch
    from ..core.artifact import compile_trivial
    from ..core.polytope import MemorySpec
    from ..models import get_model
    from ..runtime.server import Request, Server, page_solution

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    model = get_model(cfg)

    fallback = compile_trivial(
        MemorySpec("kv_pool", dims=(args.max_len,), word_bits=16, ports=1))
    server = Server(model, max_batch=args.max_batch, max_len=args.max_len,
                    kv_plan=fallback, device=args.device, seed=args.seed)
    print("serving from:", server.pager.artifact.describe())
    t_solve = time.perf_counter()
    solved = page_solution(cfg, max_len=args.max_len,
                           page=min(16, args.max_len // 4),
                           readers=args.max_batch)
    print(f"solved KV-pool plan in "
          f"{(time.perf_counter() - t_solve) * 1e3:.2f} ms")
    if solved.layout != server.pager.artifact.layout:
        server._swap_to(solved)
        server.swaps += 1
    print(f"page pool: {server.pager.slots} slots x "
          f"{server.pager.pages_per_slot} pages x "
          f"{server.pager.page_size} tokens")

    rng = np.random.default_rng(args.seed)
    for uid in range(args.requests):
        prompt = rng.integers(2, cfg.vocab - 1,
                              size=int(rng.integers(3, 8))).astype(np.int32)
        server.submit(Request(uid=uid, prompt=prompt, max_new=args.max_new))
    t0 = time.perf_counter()
    server.run(max_ticks=5000)
    if server.device.type == "cuda":
        torch.cuda.synchronize(server.device)
    dt = time.perf_counter() - t0
    total_tokens = args.requests * args.max_new
    if server.swaps:
        print(f"hot-swapped to solved layout after tick <= {server.ticks}: "
              f"{server.pager.artifact.describe()}")
    where = (torch.cuda.get_device_name(server.device)
             if server.device.type == "cuda" else "the host CPU")
    print(f"served {args.requests} requests ({total_tokens} tokens) in "
          f"{server.ticks} ticks, {dt:.1f}s "
          f"({total_tokens/dt:.1f} tok/s on {where})")
    return server


if __name__ == "__main__":
    main()
