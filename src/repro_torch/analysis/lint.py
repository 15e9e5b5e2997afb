"""Program lint: catch banking problems no solver can fix, before solving.

Four families of diagnostics, severity-graded:

* ``degenerate-counter`` -- zero/negative trip counts, zero steps,
  nonsensical ``par``: the unroller would silently produce an empty or
  repeated lane space.
* ``oob-access`` / ``unbounded-access`` -- interval arithmetic over each
  affine access against the ``MemorySpec`` dims; a provable
  out-of-bounds index is an error, an unprovable one (data-dependent
  counter, ``Sym`` offset) is informational.
* ``sym-collision`` -- the same raw ``Sym`` key used from *distinct*
  call sites: under lockstep lanes the unroller keeps raw keys as-is,
  so two semantically different runtime values cancel in access deltas
  and the conflict analysis is unsound.
* ``port-oversubscription`` -- more than ``ports`` concurrent accesses
  with literally identical address expressions land on one bank under
  EVERY geometry; an error when writes are involved (duplication can
  only serve reads).

``lint_program`` is what ``PlanService.submit(..., verify=...)`` runs
before a solve is even queued.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..core.controller import Counter, Ctrl, Program, unroll
from ..core.grouping import build_groups
from ..core.polytope import Affine

__all__ = ["Diagnostic", "LintError", "LintReport", "lint_program"]

SEVERITIES = ("error", "warning", "info")


class LintError(ValueError):
    """A Program failed the pre-solve lint gate (error-severity findings).

    Raised by ``PlanService.submit(..., verify=...)`` before the solve
    queues; ``.report`` carries the full :class:`LintReport`.
    """

    def __init__(self, report: "LintReport"):
        super().__init__("program fails lint:\n" + report.describe())
        self.report = report


@dataclass(frozen=True)
class Diagnostic:
    severity: str
    code: str
    message: str
    where: str = ""

    def describe(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        return f"{self.severity}: {self.code}{loc}: {self.message}"


@dataclass
class LintReport:
    diagnostics: List[Diagnostic]

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "warning"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def describe(self) -> str:
        if not self.diagnostics:
            return "lint: clean"
        return "\n".join(d.describe() for d in self.diagnostics)


def _counter_range(c: Counter) -> Optional[Tuple[int, int]]:
    """Inclusive value range of a static counter, None when unknowable."""
    if not c.static or c.count is None or c.count <= 0:
        return None
    last = c.start + c.step * (c.count - 1)
    return (min(c.start, last), max(c.start, last))


def _expr_bounds(expr: Affine, env: Dict[str, Counter]):
    """Interval of an affine access expression, None when unbounded."""
    if expr.syms:
        return None
    lo = hi = expr.const
    for name, coeff in expr.terms:
        c = env.get(name)
        rng = _counter_range(c) if c is not None else None
        if rng is None:
            return None
        vmin, vmax = rng
        if coeff >= 0:
            lo += coeff * vmin
            hi += coeff * vmax
        else:
            lo += coeff * vmax
            hi += coeff * vmin
    return lo, hi


def _lint_counters(ctrl: Ctrl, out: List[Diagnostic]) -> None:
    for c in ctrl.counters:
        where = f"{ctrl.name}.{c.name}"
        if c.count is not None and c.count <= 0:
            out.append(Diagnostic(
                "error", "degenerate-counter",
                f"trip count {c.count} produces no iterations", where))
        if c.step == 0 and (c.count is None or c.count > 1):
            out.append(Diagnostic(
                "error", "degenerate-counter",
                "step 0 repeats one value every iteration", where))
        if c.par < 1:
            out.append(Diagnostic(
                "error", "degenerate-counter",
                f"par {c.par} is not a positive lane count", where))
        elif c.count is not None and 0 < c.count < c.par:
            out.append(Diagnostic(
                "warning", "degenerate-counter",
                f"par {c.par} exceeds trip count {c.count}: "
                f"some lanes never run", where))


def _lint_bounds(ctrl: Ctrl, env: Dict[str, Counter], program: Program,
                 memory: Optional[str], out: List[Diagnostic]) -> None:
    env = dict(env)
    for c in ctrl.counters:
        env[c.name] = c
    for decl in ctrl.accesses:
        if memory is not None and decl.memory != memory:
            continue
        mem = program.memories.get(decl.memory)
        if mem is None:
            out.append(Diagnostic(
                "error", "oob-access",
                f"access targets undeclared memory {decl.memory!r}",
                f"{ctrl.name}.{decl.label or decl.memory}"))
            continue
        if len(decl.exprs) != len(mem.dims):
            out.append(Diagnostic(
                "error", "oob-access",
                f"{len(decl.exprs)} index exprs for "
                f"{len(mem.dims)}-d memory {mem.name!r}",
                f"{ctrl.name}.{decl.label or mem.name}"))
            continue
        for d, (expr, dim) in enumerate(zip(decl.exprs, mem.dims)):
            where = f"{ctrl.name}.{decl.label or mem.name}[dim{d}]"
            bounds = _expr_bounds(expr, env)
            if bounds is None:
                out.append(Diagnostic(
                    "info", "unbounded-access",
                    f"index range not statically bounded vs dim {dim} "
                    f"(data-dependent counter or Sym offset)", where))
                continue
            lo, hi = bounds
            if lo < 0 or hi >= dim:
                out.append(Diagnostic(
                    "error", "oob-access",
                    f"index range [{lo}, {hi}] escapes [0, {dim})",
                    where))
    for child in ctrl.children:
        _lint_bounds(child, env, program, memory, out)


def _lint_syms(program: Program, out: List[Diagnostic]) -> None:
    sites: Dict[str, List[str]] = {}
    for ctrl in program.root.subtree():
        keys = set()
        for decl in ctrl.accesses:
            for expr in decl.exprs:
                for key, _ in expr.syms:
                    if "@" not in key:       # qualified keys are per-site
                        keys.add(key)
        for key in keys:
            sites.setdefault(key, []).append(ctrl.name)
    for key, ctrls in sorted(sites.items()):
        if len(ctrls) > 1:
            out.append(Diagnostic(
                "error", "sym-collision",
                f"Sym {key!r} appears in distinct call sites "
                f"{sorted(set(ctrls))}: under lockstep unrolling the "
                f"instances cancel in deltas as if equal -- qualify the "
                f"keys per site", key))


def _lint_ports(program: Program, memory: Optional[str],
                out: List[Diagnostic]) -> None:
    try:
        up = unroll(program)
    except Exception as e:                    # surfaced, not raised
        out.append(Diagnostic("error", "unroll-failure",
                              f"program does not unroll: {e!r}"))
        return
    names = [memory] if memory is not None else sorted(program.memories)
    for name in names:
        mem = program.memories.get(name)
        if mem is None:
            continue
        for gi, group in enumerate(build_groups(up, name)):
            buckets: Dict[Tuple, List] = {}
            for a in group:
                buckets.setdefault(tuple(a.exprs), []).append(a)
            for exprs, accs in buckets.items():
                if len(accs) <= mem.ports:
                    continue
                labels = sorted(a.label or f"access{a.uid}" for a in accs)
                writes = any(a.is_write for a in accs)
                sev = "error" if writes else "warning"
                fix = ("no banking or duplication separates them"
                       if writes else
                       "only array duplication can serve them")
                out.append(Diagnostic(
                    sev, "port-oversubscription",
                    f"{len(accs)} concurrent accesses {labels} on "
                    f"{name!r} share one address expression "
                    f"(> {mem.ports} ports): {fix}",
                    f"group{gi}"))


def lint_program(program: Program,
                 memory: Optional[str] = None) -> LintReport:
    """Lint a :class:`Program` (optionally scoped to one memory)."""
    out: List[Diagnostic] = []
    for ctrl in program.root.subtree():
        _lint_counters(ctrl, out)
    _lint_bounds(program.root, {}, program, memory, out)
    _lint_syms(program, out)
    _lint_ports(program, memory, out)
    order = {s: i for i, s in enumerate(SEVERITIES)}
    out.sort(key=lambda d: (order.get(d.severity, 9), d.code, d.where))
    return LintReport(out)
