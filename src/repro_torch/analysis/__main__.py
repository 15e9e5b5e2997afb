"""Audit banking artifacts from the command line.

Sweep an existing plan store, re-checking every persisted certificate
against its plan (missing certificates are reported, not failed --
stores written before verification was armed have none):

    PYTHONPATH=src python -m repro_torch.analysis PATH/TO/STORE

Certify every baseline system's chosen scheme over the Sec-4 problems
(the CI fast step):

    PYTHONPATH=src python -m repro_torch.analysis --baselines [--fast]

Exit status is non-zero iff any check FAILED.
"""

from __future__ import annotations

import argparse
import sys


def _sweep_store(path: str) -> int:
    from ..core.store import DirectoryStore
    from .certify import certificate_matches_plan, check_certificate

    store = DirectoryStore(path)
    verified = missing = failed = 0
    for plan in store.plans():
        cert = store.get_certificate(plan.signature, plan.scorer_name)
        tag = f"{plan.signature} scorer={plan.scorer_name}"
        if cert is None:
            missing += 1
            print(f"missing  {tag}")
            continue
        ok, reason = check_certificate(cert)
        if ok and not certificate_matches_plan(cert, plan):
            ok, reason = False, "certificate does not match plan scheme"
        if ok:
            verified += 1
            print(f"verified {tag}")
        else:
            failed += 1
            print(f"FAILED   {tag}: {reason}")
    print(f"swept: {verified} verified, {missing} missing, "
          f"{failed} failed")
    return 1 if failed else 0


def _certify_baselines(fast: bool) -> int:
    from ..core import baselines, problems
    from ..core.controller import unroll
    from .certify import certify_plan
    from .lint import lint_program

    apps = ["denoise", "sobel"] if fast \
        else list(problems.STENCILS) + list(problems.APPS)
    failures = 0
    for app in apps:
        prog = problems.build(app)
        memname = list(prog.memories)[0]
        report = lint_program(prog, memname)
        if not report.ok:
            failures += 1
            print(f"FAILED   {app}: lint errors\n{report.describe()}")
            continue
        iters = unroll(prog).iterators
        for name, fn in sorted(baselines.SYSTEMS.items()):
            plan = fn(prog, memname)
            res = certify_plan(plan, iters, scorer=name)
            if res.ok:
                print(f"verified {app}/{name}: "
                      f"{res.pairs_checked} pairs in "
                      f"{res.seconds * 1e3:.1f} ms")
            else:
                failures += 1
                why = (res.counterexample.describe()
                       if res.counterexample else res.reason)
                print(f"FAILED   {app}/{name}: {why}")
    print(f"baselines: {failures} failures")
    return 1 if failures else 0


def main() -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="independently verify banking plans and certificates")
    ap.add_argument("store", nargs="?", default=None,
                    help="plan store directory to sweep (re-checks every "
                         "persisted certificate against its plan)")
    ap.add_argument("--baselines", action="store_true",
                    help="lint + certify every core/baselines.py system's "
                         "chosen scheme over the Sec-4 problems")
    ap.add_argument("--fast", action="store_true",
                    help="with --baselines: two representative problems "
                         "instead of the full suite")
    args = ap.parse_args()
    if args.baselines:
        sys.exit(_certify_baselines(args.fast))
    if args.store is None:
        ap.error("give a plan store path or --baselines")
    sys.exit(_sweep_store(args.store))


if __name__ == "__main__":
    main()
