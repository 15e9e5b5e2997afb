"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  It runs on the machine it is started on and
needs as many CUDA devices as the cell asks for; it exits with a code
other than 0, and prints no result, where they are missing, where the
program cannot be imported, or where JAX or the JAX package was loaded.
The last line of standard output is the result's JSON; the last lines of
standard error are the judged numbers beside their limits.
"""

import time

STARTED = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the program inside the checkout, at fixed paths
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    # the package by its name, not this script's folder on the path
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != ROOT / "bench"]

    from bench import harness

    import torch

    cell = harness.Cell(args.workload, args.seed, args.seconds)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" found", file=sys.stderr)
        return 2
    result = harness.run(cell, bool(args.trace), STARTED)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the process loaded {', '.join(bad)}: no result",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    print("\n".join(harness.check_lines(result["checks"])), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
