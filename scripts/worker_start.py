#!/usr/bin/env python3
"""Seconds from ``spawn_local_workers`` to the worker's join on the fabric,
for the JAX package's solve worker or the port's, on this host's CPU.

    PYTHONPATH=src python scripts/worker_start.py repro_torch [--runs 5]
    PYTHONPATH=src python scripts/worker_start.py repro

Each run opens a fabric, spawns one worker, waits for it to attach, and
tears both down; the line printed holds every run and their median.
"""

import argparse
import importlib
import statistics
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("package", choices=("repro", "repro_torch"))
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    core = importlib.import_module(args.package + ".core")
    times = []
    for _ in range(args.runs):
        fabric = core.SolveFabric()
        t = time.perf_counter()
        procs = core.spawn_local_workers(fabric.address, 1)
        try:
            if not fabric.wait_for_workers(1, timeout=120):
                raise SystemExit("the worker did not attach in 120 s")
            times.append(time.perf_counter() - t)
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.wait(10)
            fabric.shutdown()
    print(args.package, "worker start seconds:", times,
          "median", statistics.median(times))


if __name__ == "__main__":
    main()
