"""Readings that set a cell's limits: the program's judged numbers on many
seeds, and its control's on some of them.

    python3 bench/control.py --workload NAME --seeds 1-12 \\
        --control-seeds 1-3 --seconds S [--out FILE]

runs, in one process, for each seed: the cell's set-up and a window of
``S`` seconds, then the judge on the program's outputs and, for a control
seed, the control in the program's place: the plain reference computed
with float8 products (the precision below the configurations' bfloat16),
judged the same way.  One JSON line a reading, on standard output and in
``FILE``.  The benchmark's own runs never run it.
"""

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != ROOT / "bench"]

    import torch

    from bench import harness
    from bench.reference.common import Precision
    from bench.tracing import Tracer

    out = open(args.out, "a") if args.out else None
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        cell = harness.Cell(args.workload, seed, args.seconds)
        drv = cell.driver()
        t0 = time.monotonic()
        state = drv.setup(cell)
        record = drv.window(cell, state, Tracer(False))
        torch.cuda.synchronize()
        e2e = drv.end_to_end(record)
        gc.collect()
        torch.cuda.empty_cache()
        sides = []
        if seed in args.seeds:
            sides.append(("program", lambda: drv.judge_numbers(
                cell, state, record)))
        if seed in args.control_seeds:
            sides.append(("control", lambda: drv.control_numbers(
                cell, state, record, Precision(fp8=True))))
        for side, numbers in sides:
            t1 = time.monotonic()
            line = {"workload": args.workload, "seed": seed, "side": side,
                    "numbers": dict(numbers()), "end_to_end": e2e,
                    "run_s": t1 - t0, "judge_s": time.monotonic() - t1}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
        del state, record
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
