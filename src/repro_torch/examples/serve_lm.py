"""Batched serving demo: continuous batching with KV-cache slots.

The KV-pool banking problem goes through the async service front door:
submit returns a ticket, the server's first ticks run from the ticket's
trivial fallback artifact, and the page pool hot-swaps to the solved
banking scheme between decode ticks.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu

On a card every tick gathers and scatters the token-record table through
the banked kernels, and the swap repacks it through the banked row
scatter.
"""

import argparse

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.models import get_model
from repro_torch.runtime.server import Request, Server, page_ticket


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    cfg = get_arch("qwen2_7b").reduced()

    # submit the banking problem FIRST: the solver runs in the background
    # while the model is built -- nothing blocks on the ~1s cold solve
    ticket = page_ticket(cfg, max_len=64, page=16, readers=4)
    model = get_model(cfg)

    server = Server(model, max_batch=4, max_len=64, kv_plan=ticket,
                    device=args.device)
    print("first-tick KV layout (pages = banks):",
          server.pager.artifact.describe())
    print(f"page pool: {server.pager.slots} slots x "
          f"{server.pager.pages_per_slot} pages x "
          f"{server.pager.page_size} tokens")

    rng = np.random.default_rng(0)
    for uid in range(6):  # more requests than slots -> continuous batching
        prompt = rng.integers(2, cfg.vocab - 1, size=rng.integers(3, 8))
        server.submit(Request(uid=uid, prompt=prompt.astype(np.int32),
                              max_new=8))
    server.run(max_ticks=200)
    if server.swaps:
        print("hot-swapped to the solved layout mid-serve:",
              server.pager.artifact.describe())
    print(f"served 6 requests in {server.ticks} decode ticks "
          f"(max_batch=4 slots, {server.swaps} layout swap(s))")
    assert not server.queue and not server.active


if __name__ == "__main__":
    main()
