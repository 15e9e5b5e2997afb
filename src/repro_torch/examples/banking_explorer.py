"""Compare all four systems (baseline / spatial / merlin / ours) on any of
the paper's benchmark access patterns.

    PYTHONPATH=src python -m repro_torch.examples.banking_explorer sobel
    PYTHONPATH=src python -m repro_torch.examples.banking_explorer spmv --top 5

Framework-free: the banking core alone, no device.
"""

import argparse

from repro_torch.core import baselines, problems


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("pattern", nargs="?", default="sobel",
                    choices=problems.STENCILS + problems.APPS + ["md_grid"])
    ap.add_argument("--top", type=int, default=3)
    args = ap.parse_args(argv)

    prog = problems.build(args.pattern)
    memname = list(prog.memories)[0]
    mem = prog.memories[memname]
    print(f"pattern={args.pattern} memory={memname} dims={mem.dims} "
          f"ports={mem.ports}\n")

    for sysname in ("baseline", "spatial", "merlin", "ours"):
        rep = baselines.SYSTEMS[sysname](prog, memname)
        b = rep.best
        r = b.resources.total
        print(f"[{sysname:9s}] LUT={r.lut:7.0f} FF={r.ff:7.0f} "
              f"BRAM={r.bram:3d} DSP={r.dsp:2d}  {b.describe().split(' |')[0]}"
              f"  ({rep.solve_seconds*1e3:.0f} ms, "
              f"{rep.num_candidates} candidates)")
        if sysname == "ours":
            print("\n  runner-up schemes:")
            for s in rep.solutions[1:args.top + 1]:
                print("   ", s.describe())


if __name__ == "__main__":
    main()
