"""Joint whole-model planning: co-select schemes under a shared budget.

Every memory used to take its locally-best scheme -- a model's KV pools,
MoE dispatch buffers, and SSM chunk state each greedily argmin'ing with
no global accounting.  The paper's headline wins (40.3% fewer logic
resources, 54.9% fewer BRAMs) come from choosing partitioning schemes
that share resources *across* arrays, so this module plans the whole
model at once:

* a :class:`JointRequest` bundles one ``Program``'s memories plus a
  global :class:`ResourceBudget` (banks / bank volume / LUT-FF-BRAM-DSP,
  the axes of :class:`~repro_torch.core.resources.SchemeResources`);
* per-memory candidate spaces enumerate exactly as today, but instead of
  each memory's argmin a reducer keeps a small **Pareto frontier** per
  memory (predicted cost x resource axes, :func:`pareto_frontier`) with
  the trivial single-bank scheme *always* on it, so a feasible
  co-selection always exists;
* :func:`co_select` is an exact branch-and-bound DP over the kept
  frontiers: one scheme per memory, minimum total predicted cost,
  subject to the budget -- exhaustive for the frontier sizes we keep,
  with admissible per-axis/per-cost lower bounds pruning the product
  space.  Selection is a pure function of the frontiers (deterministic
  traversal, deterministic tie-breaks), so it is invariant to the order
  member solves happen to land in;
* the result persists as a :class:`JointPlan` -- member signatures +
  chosen schemes + budget -- through the ``PlanStore``'s ``joint/``
  sidecar, JSON round-trip like any ``BankingPlan``.

The service front door is :meth:`repro_torch.core.service.PlanService
.submit_joint` -> :class:`~repro_torch.core.service.JointTicket`: a ticket
*graph* whose per-memory solves fan out through the existing pool /
fabric executors and re-co-select progressively as members land.  The
runtime closes the loop with a coherent multi-pool hot-swap
(``runtime/server.py``): all of a model's pools promote to the jointly
selected layouts atomically between decode ticks.
"""

from __future__ import annotations

import hashlib
import json
import time
from dataclasses import asdict, dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .controller import Program
from .polytope import AccessGroup, Iterator, MemorySpec
from .solver import BankingSolution, SolverOptions

JOINT_FORMAT = "joint-plan/v1"
JOINT_SIGNATURE_PREFIX = "jp1-"

# The budget axes, in the order every use-vector tuple follows.
BUDGET_AXES = ("banks", "volume", "lut", "ff", "bram", "dsp")


# ---------------------------------------------------------------------------
# Budget currency
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ResourceUse:
    """One scheme's (or selection's) draw on the shared budget axes.

    ``banks`` counts physical banks (duplicates included), ``volume`` the
    total words of bank storage they hold; the rest come straight off
    ``SchemeResources.total``.
    """

    banks: int = 0
    volume: int = 0
    lut: float = 0.0
    ff: float = 0.0
    bram: int = 0
    dsp: int = 0

    def __add__(self, o: "ResourceUse") -> "ResourceUse":
        return ResourceUse(self.banks + o.banks, self.volume + o.volume,
                           self.lut + o.lut, self.ff + o.ff,
                           self.bram + o.bram, self.dsp + o.dsp)

    def axis(self, name: str) -> float:
        return getattr(self, name)

    def as_tuple(self) -> Tuple[float, ...]:
        return tuple(self.axis(a) for a in BUDGET_AXES)

    def as_dict(self) -> Dict[str, float]:
        return {a: self.axis(a) for a in BUDGET_AXES}

    @staticmethod
    def of_solution(sol: BankingSolution) -> "ResourceUse":
        banks = int(sol.num_banks) * max(1, int(sol.duplicates))
        r = sol.resources.total if sol.resources is not None else None
        return ResourceUse(
            banks=banks,
            volume=banks * int(sol.bank_volume),
            lut=float(r.lut) if r else 0.0,
            ff=float(r.ff) if r else 0.0,
            bram=int(r.bram) if r else banks,
            dsp=int(r.dsp) if r else 0,
        )

    @staticmethod
    def from_json(d: dict) -> "ResourceUse":
        return ResourceUse(**{a: d.get(a, 0) for a in BUDGET_AXES})


@dataclass(frozen=True)
class ResourceBudget:
    """Global caps on the shared axes; ``None`` leaves an axis unbounded.

    An all-``None`` budget (``ResourceBudget()``) is *slack*: every
    selection fits, and joint co-selection degenerates to each memory's
    independent argmin.
    """

    banks: Optional[int] = None
    volume: Optional[int] = None
    lut: Optional[float] = None
    ff: Optional[float] = None
    bram: Optional[int] = None
    dsp: Optional[int] = None

    @property
    def bounded(self) -> bool:
        return any(getattr(self, a) is not None for a in BUDGET_AXES)

    def admits(self, use: ResourceUse) -> bool:
        for a in BUDGET_AXES:
            cap = getattr(self, a)
            if cap is not None and use.axis(a) > cap:
                return False
        return True

    def headroom(self, use: ResourceUse) -> Dict[str, float]:
        """Remaining slack per bounded axis (negative = over)."""
        return {a: getattr(self, a) - use.axis(a)
                for a in BUDGET_AXES if getattr(self, a) is not None}

    def as_dict(self) -> Dict[str, Optional[float]]:
        return {a: getattr(self, a) for a in BUDGET_AXES}

    @staticmethod
    def from_json(d: Optional[dict]) -> Optional["ResourceBudget"]:
        if d is None:
            return None
        return ResourceBudget(**{a: d.get(a) for a in BUDGET_AXES})


# ---------------------------------------------------------------------------
# The trivial member: one bank, always feasible
# ---------------------------------------------------------------------------


def trivial_solution(mem: MemorySpec, groups: List[AccessGroup],
                     iterators: Dict[str, Iterator],
                     opts: Optional[SolverOptions] = None) -> BankingSolution:
    """The single-bank scheme as a scored, resource-estimated solution.

    ``FlatGeometry(N=1, B=1)`` serializes concurrent accesses instead of
    banking them -- never refused, never needs a solver -- which is what
    guarantees every frontier holds at least one member and an
    over-constrained budget degrades to all-trivial instead of raising.
    Mirrors :func:`repro_torch.core.artifact.compile_trivial`'s geometry
    exactly, so the compiled fallback artifact and this solution describe
    the same layout.
    """
    from .geometry import FlatGeometry
    from .solver import _attach_flat

    opts = opts or SolverOptions()
    nd = len(mem.dims)
    alpha = tuple(1 if i == 0 else 0 for i in range(nd))
    geo = FlatGeometry(N=1, B=1, alpha=alpha, P=(1,) * nd)
    ports_needed = max((len(g) for g in groups), default=1)
    sol = _attach_flat(groups, mem, geo, (1,) * nd, iterators,
                       required_ports=ports_needed, opts=opts,
                       note="trivial single-bank fallback")
    if sol.resources is not None:
        sol.score = sol.resources.total.weighted()
    return sol


def is_trivial(sol: BankingSolution) -> bool:
    return (sol.kind == "flat" and sol.geometry.N == 1
            and sol.geometry.B == 1 and sol.duplicates <= 1)


# ---------------------------------------------------------------------------
# Per-memory Pareto frontiers
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FrontierPoint:
    """One kept scheme for one memory: predicted cost x budget draw."""

    solution: BankingSolution
    use: ResourceUse
    score: float
    trivial: bool = False

    def key(self) -> tuple:
        """Deterministic identity for tie-breaks and change detection."""
        g = self.solution.geometry
        geo = ((g.N, g.B, g.alpha) if self.solution.kind == "flat"
               else (g.Ns, g.Bs, g.alphas))
        return (self.solution.kind, geo, self.solution.duplicates,
                self.trivial)


def _dominates(a: FrontierPoint, b: FrontierPoint) -> bool:
    """a dominates b: no worse on cost and every axis, better somewhere."""
    if a.score > b.score:
        return False
    at, bt = a.use.as_tuple(), b.use.as_tuple()
    if any(x > y for x, y in zip(at, bt)):
        return False
    return a.score < b.score or any(x < y for x, y in zip(at, bt))


# A selection is only ever charged a trivial member when nothing else
# fits: the single-bank scheme *serializes* concurrent accesses, so its
# predicted cost is not comparable to the solver's conflict-free schemes.
# Frontier points for it carry this additive penalty (plus a multiple of
# the frontier's worst real score), which keeps sums finite and ordered:
# any selection avoiding trivials beats any selection using one.
TRIVIAL_PENALTY = 1e9


def pareto_frontier(solutions: Sequence[BankingSolution], *,
                    trivial: BankingSolution,
                    cap: int = 8) -> List[FrontierPoint]:
    """The kept frontier for one memory: Pareto-optimal (cost x axes)
    points, truncated to ``cap``, with the trivial scheme always last
    (at :data:`TRIVIAL_PENALTY`-inflated cost, so co-selection only
    falls back to it under budget pressure).

    Truncation keeps the lowest-cost points plus each axis's minimum-use
    point, so a tight budget still sees the cheapest-per-axis options.
    Points are sorted best-cost-first; deterministic given the solutions.
    """
    pts = []
    for s in solutions:
        if s is None:
            continue
        pts.append(FrontierPoint(solution=s, use=ResourceUse.of_solution(s),
                                 score=float(s.score)))
    front = [p for p in pts
             if not any(_dominates(q, p) for q in pts if q is not p)]
    # dedupe identical schemes (duplicate geometry from merged shards)
    seen = set()
    front = [p for p in front
             if (k := p.key()) not in seen and not seen.add(k)]
    front.sort(key=lambda p: (p.score, p.use.as_tuple()))
    if len(front) > max(1, cap - 1):
        keep = list(front[:max(1, cap - 1)])
        kept = {p.key() for p in keep}
        for axis in BUDGET_AXES:   # cheapest-per-axis survivors
            low = min(front, key=lambda p: (p.use.axis(axis), p.score))
            if low.key() not in kept:
                keep.append(low)
                kept.add(low.key())
        keep.sort(key=lambda p: (p.score, p.use.as_tuple()))
        front = keep
    worst = max((p.score for p in front), default=0.0)
    tp = FrontierPoint(solution=trivial,
                       use=ResourceUse.of_solution(trivial),
                       score=(max(float(trivial.score), worst) * 1e3
                              + TRIVIAL_PENALTY),
                       trivial=True)
    return front + [tp]


# ---------------------------------------------------------------------------
# Exact co-selection over frontiers
# ---------------------------------------------------------------------------


@dataclass
class JointSelection:
    """One scheme per memory plus the totals the budget judged."""

    picks: Dict[str, FrontierPoint]
    total_use: ResourceUse
    total_score: float
    feasible: bool     # False: even all-trivial exceeds the budget

    def key(self) -> tuple:
        return tuple((name, p.key()) for name, p in sorted(self.picks.items()))


def co_select(frontiers: Dict[str, List[FrontierPoint]],
              budget: Optional[ResourceBudget],
              stats_out: Optional[dict] = None) -> JointSelection:
    """Pick one frontier point per memory minimizing total predicted
    cost subject to ``budget`` -- exact for the kept frontier sizes.

    Branch-and-bound over memories in sorted-name order: partial
    selections prune on (a) an admissible per-axis lower bound (each
    remaining memory must draw at least its frontier's per-axis minimum)
    and (b) an admissible cost lower bound.  With a slack (or ``None``)
    budget this degenerates to each memory's independent argmin.  If no
    selection fits -- the budget is under even the all-trivial draw --
    the all-trivial selection is returned with ``feasible=False``:
    co-selection never raises for want of resources.

    ``stats_out`` (a dict, when given) receives the search effort --
    ``nodes`` visited and ``pruned`` (bound + admissibility cuts) -- so
    a co-select trace span can say how hard the search worked.
    """
    if stats_out is not None:
        stats_out["nodes"] = 0
        stats_out["pruned"] = 0
    names = sorted(frontiers)
    if not names:
        return JointSelection({}, ResourceUse(), 0.0, True)
    budget = budget or ResourceBudget()
    fronts = [sorted(frontiers[n], key=lambda p: (p.score, p.use.as_tuple(),
                                                  p.trivial))
              for n in names]
    if not budget.bounded:     # slack: independent argmin per memory
        picks = {}
        for name, f in zip(names, fronts):
            real = [p for p in f if not p.trivial]
            picks[name] = real[0] if real else f[0]
        use = ResourceUse()
        for p in picks.values():
            use = use + p.use
        if stats_out is not None:
            stats_out["nodes"] = len(names)
        return JointSelection(picks, use,
                              sum(p.score for p in picks.values()), True)
    # admissible suffix lower bounds: min score and per-axis min use of
    # every memory still to be decided
    n = len(names)
    suf_score = [0.0] * (n + 1)
    suf_use = [ResourceUse()] * (n + 1)
    for i in range(n - 1, -1, -1):
        suf_score[i] = suf_score[i + 1] + min(p.score for p in fronts[i])
        mins = {a: min(p.use.axis(a) for p in fronts[i])
                for a in BUDGET_AXES}
        suf_use[i] = suf_use[i + 1] + ResourceUse(**mins)
    best: List[Optional[Tuple[float, List[FrontierPoint]]]] = [None]

    def admissible(use: ResourceUse, i: int) -> bool:
        floor = use + suf_use[i]
        return budget.admits(ResourceUse(
            banks=int(floor.banks), volume=int(floor.volume),
            lut=floor.lut, ff=floor.ff,
            bram=int(floor.bram), dsp=int(floor.dsp)))

    def dfs(i: int, use: ResourceUse, score: float,
            picks: List[FrontierPoint]) -> None:
        if stats_out is not None:
            stats_out["nodes"] += 1
        if best[0] is not None and score + suf_score[i] >= best[0][0]:
            if stats_out is not None:
                stats_out["pruned"] += 1
            return
        if not admissible(use, i):
            if stats_out is not None:
                stats_out["pruned"] += 1
            return
        if i == n:
            best[0] = (score, list(picks))
            return
        for p in fronts[i]:
            picks.append(p)
            dfs(i + 1, use + p.use, score + p.score, picks)
            picks.pop()

    dfs(0, ResourceUse(), 0.0, [])
    if best[0] is None:
        # infeasible even at the floor: honest all-trivial fallback
        picks = {}
        for name, f in zip(names, fronts):
            trivials = [p for p in f if p.trivial]
            picks[name] = trivials[0] if trivials else f[-1]
        use = ResourceUse()
        for p in picks.values():
            use = use + p.use
        return JointSelection(picks, use,
                              sum(p.score for p in picks.values()), False)
    score, chosen = best[0]
    picks = dict(zip(names, chosen))
    use = ResourceUse()
    for p in picks.values():
        use = use + p.use
    return JointSelection(picks, use, score, True)


# ---------------------------------------------------------------------------
# Requests and signatures
# ---------------------------------------------------------------------------


@dataclass
class JointRequest:
    """One whole-model planning problem: a program's memories + budget."""

    program: Program
    memories: Optional[Sequence[str]] = None   # None = every program memory
    budget: Optional[ResourceBudget] = None
    opts: Optional[SolverOptions] = None
    scorer: object = None                      # ScorerLike
    use_cache: bool = True
    frontier_cap: int = 8

    def memory_names(self) -> List[str]:
        names = (list(self.memories) if self.memories is not None
                 else list(self.program.memories))
        missing = [m for m in names if m not in self.program.memories]
        if missing:
            raise KeyError(f"unknown memories {missing!r}; program has "
                           f"{sorted(self.program.memories)}")
        return names


def joint_signature(member_signatures: Dict[str, str], scorer_name: str,
                    budget: Optional[ResourceBudget]) -> str:
    """Stable content hash of a joint problem: the member signatures
    (which already hash each memory's access structure + options), the
    scorer, and the budget.  The ``jp1-`` prefix keeps joint entries
    disjoint from per-memory ``bp*`` plans in any shared directory."""
    payload = {
        "members": sorted(member_signatures.items()),
        "scorer": scorer_name,
        "budget": budget.as_dict() if budget is not None else None,
    }
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return (JOINT_SIGNATURE_PREFIX
            + hashlib.sha256(blob.encode()).hexdigest()[:32])


# ---------------------------------------------------------------------------
# The durable joint plan
# ---------------------------------------------------------------------------


@dataclass
class JointMember:
    """One memory's slice of a joint plan: provenance + chosen scheme."""

    memory: str
    signature: str
    status: str                  # solved | cached | cached-disk | error
    chosen: Optional[BankingSolution]
    trivial: bool = False
    certified: bool = False
    certificate: Optional[dict] = None   # ConflictCertificate JSON
    score: float = 0.0           # the scheme's raw (unpenalized) score
    use: ResourceUse = field(default_factory=ResourceUse)
    error: str = ""

    def to_json(self) -> dict:
        from .planner import _solution_to_json

        return {
            "memory": self.memory,
            "signature": self.signature,
            "status": self.status,
            "chosen": (_solution_to_json(self.chosen)
                       if self.chosen is not None else None),
            "trivial": self.trivial,
            "certified": self.certified,
            "certificate": self.certificate,
            "score": self.score,
            "use": self.use.as_dict(),
            "error": self.error,
        }

    @staticmethod
    def from_json(d: dict, opts: SolverOptions) -> "JointMember":
        from .planner import _solution_from_json

        chosen = (_solution_from_json(d["chosen"], opts)
                  if d.get("chosen") else None)
        return JointMember(
            memory=d["memory"], signature=d["signature"],
            status=d.get("status", "solved"), chosen=chosen,
            trivial=d.get("trivial", False),
            certified=d.get("certified", False),
            certificate=d.get("certificate"),
            score=d.get("score", 0.0),
            use=ResourceUse.from_json(d.get("use", {})),
            error=d.get("error", ""),
        )


@dataclass
class JointPlan:
    """A durable whole-model banking decision.

    Member signatures pin the exact per-memory problems this selection
    answers; ``feasible`` records whether the budget admitted any
    selection (False = the all-trivial honest fallback was returned).
    """

    signature: str
    members: Dict[str, JointMember]
    budget: Optional[ResourceBudget] = None
    feasible: bool = True
    scorer_name: str = "proxy"
    status: str = "solved"       # solved | cached | cached-disk
    solve_seconds: float = 0.0
    created_at: float = 0.0
    opts: SolverOptions = field(default_factory=SolverOptions)

    @property
    def total_use(self) -> ResourceUse:
        use = ResourceUse()
        for m in self.members.values():
            use = use + m.use
        return use

    @property
    def total_score(self) -> float:
        return sum(m.score for m in self.members.values())

    def selection(self) -> Dict[str, BankingSolution]:
        return {name: m.chosen for name, m in self.members.items()
                if m.chosen is not None}

    def fits(self) -> bool:
        return self.budget is None or self.budget.admits(self.total_use)

    def as_dict(self) -> dict:
        """Budget-accounting view (no solution graphs): totals, budget,
        and one row per member -- what benches and reports consume."""
        return {
            "signature": self.signature,
            "feasible": self.feasible,
            "fits": self.fits(),
            "budget": (self.budget.as_dict()
                       if self.budget is not None else None),
            "total_use": self.total_use.as_dict(),
            "total_score": self.total_score,
            "members": {
                name: {"status": m.status, "trivial": m.trivial,
                       "certified": m.certified, "score": m.score,
                       "use": m.use.as_dict()}
                for name, m in sorted(self.members.items())
            },
        }

    def to_json(self) -> dict:
        return {
            "format": JOINT_FORMAT,
            "signature": self.signature,
            "budget": (self.budget.as_dict()
                       if self.budget is not None else None),
            "feasible": self.feasible,
            "scorer_name": self.scorer_name,
            "status": self.status,
            "solve_seconds": self.solve_seconds,
            "created_at": self.created_at,
            "opts": asdict(self.opts),
            "members": {name: m.to_json()
                        for name, m in self.members.items()},
        }

    @staticmethod
    def from_json(d: dict) -> "JointPlan":
        if d.get("format") != JOINT_FORMAT:
            raise ValueError(f"not a joint plan: format={d.get('format')!r}")
        opts_d = dict(d.get("opts") or {})
        for k in ("b_candidates", "duplication_factors"):
            if k in opts_d:
                opts_d[k] = tuple(opts_d[k])
        opts = SolverOptions(**opts_d)
        return JointPlan(
            signature=d["signature"],
            members={name: JointMember.from_json(m, opts)
                     for name, m in d.get("members", {}).items()},
            budget=ResourceBudget.from_json(d.get("budget")),
            feasible=d.get("feasible", True),
            scorer_name=d.get("scorer_name", "proxy"),
            status=d.get("status", "solved"),
            solve_seconds=d.get("solve_seconds", 0.0),
            created_at=d.get("created_at", 0.0),
            opts=opts,
        )


# ---------------------------------------------------------------------------
# Convenience: independent totals (what joint planning is compared to)
# ---------------------------------------------------------------------------


def independent_use(plans: Dict[str, object]) -> ResourceUse:
    """Summed budget draw of per-memory plans' independent argmins --
    the baseline a budget-constrained joint selection beats."""
    use = ResourceUse()
    for plan in plans.values():
        best = getattr(plan, "best", None)
        if best is not None:
            use = use + ResourceUse.of_solution(best)
    return use


ScorerFn = Callable[[BankingSolution], float]


def score_solutions(sols: Sequence[BankingSolution],
                    scorer_fn: Optional[ScorerFn]) -> None:
    """(Re)score in place with the member scorer, proxy fallback --
    frontier points must carry comparable scores across memories."""
    for s in sols:
        if scorer_fn is not None:
            s.score = float(scorer_fn(s))
        elif s.resources is not None:
            s.score = s.resources.total.weighted()


def now() -> float:
    return time.time()


__all__ = [
    "BUDGET_AXES",
    "TRIVIAL_PENALTY",
    "FrontierPoint",
    "JointMember",
    "JointPlan",
    "JointRequest",
    "JointSelection",
    "ResourceBudget",
    "ResourceUse",
    "co_select",
    "independent_use",
    "is_trivial",
    "joint_signature",
    "pareto_frontier",
    "trivial_solution",
]
