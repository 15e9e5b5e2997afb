#!/usr/bin/env python3
"""Times the banked kernels B1-B3 of one checkout at the server's shapes
(``chip_smoke.banked_cases``), each beside the PyTorch call that does the
same work on the already resolved rows, in ``chip_smoke.interleaved_rounds``.

    python3 scripts/banked_times.py [--tree DIR] [--label L]

``--tree`` is the root of the checkout whose ``src/repro_torch`` is timed
(default: the one holding this script), so two checkouts -- a change and
its parent unpacked beside it -- can be timed in turn within one run on
one card (parent, change, change, parent); the cases and the timing are
always this checkout's.  The B2 flush is the one ``chip_smoke.py``'s first
served model (qwen2-7b) makes first at its default seed.  The tree's
``banked.cu`` is compiled anew, alone.  Prints the card's name and power
limit and how long ``nvcc`` took, then one ``banked_*`` line a case, as
``chip_smoke.py`` does.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    sys.path.insert(1, HERE)
    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        sys.exit("banked_times: no CUDA device")
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.kernels import banked_gather as bg
    from repro_torch.runtime.server import page_solution

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.build(["banked"], force=True)
    art = page_solution(None, 1024, 16, 8)
    cs.say("banked_times", label=args.label, tree=args.tree, card=card,
           source=bg.kernel_source(art),
           build_seconds=_build.build_seconds["banked"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    flat, table = cs.random_table(torch, art, 8, torch.int32, gen)
    flush = cs.admit_flush(cs.serve_prompts(get_arch("qwen2_7b"), 0)[:8])
    for case in cs.banked_cases(torch, art, flat, table, gen, rng, flush):
        cs.check(case["err"] == 0.0, f"{case['phase']}: the kernel differs "
                 f"from its plain version by {case['err']}")
        cs.interleaved_rounds(torch, case["phase"], case["kernel"],
                              case["library"], case["library_name"],
                              label=args.label, **case["fields"])


if __name__ == "__main__":
    main()
