"""Plan-oriented front door for the banking system.

The original free-function API re-ran the full
unroll -> group -> solve -> rank pipeline on every call -- including in the
serving hot path, where every decode tick poses the *same* KV-pool banking
problem.  This module makes memory configuration a reusable, durable
artifact instead of an inline computation:

* ``BankingPlanner.plan`` keys each problem by a **canonical program
  signature** -- a stable content hash of the unrolled access polytopes
  (post-grouping), the memory spec, and the solver options -- so
  structurally identical programs hit a cache instead of re-solving.
* A ``BankingPlan`` carries the chosen scheme plus provenance (candidates
  considered, scorer used, solve time) and serializes to/from JSON, so
  benchmark runs and servers can warm-start from plans on disk
  (``cache_dir=...`` / ``warm_start``).  Deserialization rebuilds the
  Sec-3.4 resolution graphs, so a loaded plan drives the CUDA
  banked-gather kernel exactly like a freshly solved one.
* Scorers are resolved through a **registry** (``"proxy"``, ``"ml"``, or
  any callable registered with ``register_scorer``) instead of ad-hoc
  ``scorer=`` callable threading.
* ``BankingPlanner.plan_all`` solves independent memories concurrently on
  a thread pool with a per-memory timeout.

Since the service redesign, ``BankingPlanner.plan`` is itself a thin
``service.submit(...).result()`` over the planner's inline
:class:`repro_torch.core.service.PlanService` -- the synchronous and asynchronous
front doors share one code path (prepare -> lookup -> solve), and
durability is delegated to a pluggable :class:`repro_torch.core.store.PlanStore`
(``cache_dir=`` is sugar for a cross-process ``DirectoryStore``).
"""

from __future__ import annotations

import copy
import hashlib
import json
import threading
import time
from dataclasses import asdict, dataclass, field, replace
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple, Union

from .artifact import CompiledBankingPlan, compile_plan
from .controller import Program, unroll
from .grouping import build_groups
from .store import PlanStore, as_store
from .polytope import AccessGroup, Affine, Iterator, MemorySpec
from .resources import ResourceEstimate, SchemeResources
from .solver import (
    BankingSolution,
    SolverOptions,
    _flat_in_bits,
    solve,
)
from .transforms import (
    Cost,
    build_flat_resolution,
    build_multidim_resolution,
    cost as graph_cost,
    count_raw_ops,
)

SIGNATURE_VERSION = 1

ScorerLike = Union[str, Callable[[BankingSolution], float], None]


# ---------------------------------------------------------------------------
# Scorer registry
# ---------------------------------------------------------------------------

_SCORER_FACTORIES: Dict[str, Callable[[], Optional[Callable]]] = {}
_SCORER_LOCK = threading.Lock()


def register_scorer(name: str,
                    factory: Callable[[], Optional[Callable]]) -> None:
    """Register ``factory`` under ``name``.

    ``factory`` is called (once per resolution) to produce a
    ``BankingSolution -> float`` callable, or ``None`` for the built-in
    weighted-resource proxy ranking.
    """
    with _SCORER_LOCK:
        _SCORER_FACTORIES[name] = factory


def registered_scorers() -> Tuple[str, ...]:
    return tuple(sorted(_SCORER_FACTORIES))


def scorer_key(spec: ScorerLike) -> str:
    """Cache-key name for a scorer spec, with NO factory side effects.

    Unregistered callables are keyed by name *and* object identity so two
    different lambdas never alias each other's cached rankings; raises
    ``ValueError`` for unknown registry names.
    """
    if spec is None:
        spec = "proxy"
    if callable(spec):
        name = getattr(spec, "__name__", None) or type(spec).__name__
        return f"custom:{name}:{id(spec):x}"
    if spec not in _SCORER_FACTORIES:
        raise ValueError(
            f"unknown scorer {spec!r}; registered scorers: "
            f"{', '.join(registered_scorers())}"
        )
    return spec


def resolve_scorer(spec: ScorerLike) -> Tuple[str, Optional[Callable]]:
    """Resolve a scorer spec to ``(name, callable-or-None)``.

    ``None`` means the proxy; a callable passes through; a string looks up
    the registry (invoking its factory) and raises ``ValueError`` for
    unknown names.
    """
    name = scorer_key(spec)
    if callable(spec):
        return name, spec
    if spec is None:
        spec = "proxy"
    return name, _SCORER_FACTORIES[spec]()


_ML_SCORER_PATH: Optional[Path] = None


def set_ml_scorer_path(path: Optional[Union[str, Path]]) -> None:
    """Where the trained ``"ml"`` scorer pipeline persists as JSON.

    ``BankingPlanner(cache_dir=...)`` points this next to the plan cache
    (``cache_dir/ml_scorer.json``) so one process's training warm-starts
    every later one; ``None`` disables persistence.  Switching to a
    *different* path drops the cached scorer, so the next ``"ml"``
    resolution loads (or trains for) the new location instead of serving
    the first-loaded pipeline forever.
    """
    global _ML_SCORER_PATH
    with _ML_TRAIN_LOCK:
        new = Path(path) if path is not None else None
        if new != _ML_SCORER_PATH:
            _ml_scorer_factory.__dict__.pop("_cached", None)
            _ml_scorer_factory.__dict__.pop("_cached_mtime", None)
        _ML_SCORER_PATH = new


def _ml_scorer_factory() -> Callable:
    """The Sec-3.5 ML cost model: load a persisted pipeline when present,
    otherwise train on a small synthetic corpus (heavy: one GBT pipeline
    per resource) and persist it next to the plan cache.

    Cached for the process lifetime -- but a persisted file whose mtime
    advanced past the load (another process refreshed ``ml_scorer.json``
    from measured telemetry) is reloaded, so refits propagate without a
    restart.  The lock is held end-to-end so concurrent planners share one
    model instead of each training their own.
    """
    with _ML_TRAIN_LOCK:
        cached = _ml_scorer_factory.__dict__.get("_cached")
        if cached is not None and _ML_SCORER_PATH is not None:
            known = _ml_scorer_factory.__dict__.get("_cached_mtime")
            try:
                disk = _ML_SCORER_PATH.stat().st_mtime_ns
            except OSError:
                disk = None
            if known is not None and disk is not None and disk > known:
                cached = None   # file refreshed on disk: reload below
        if cached is not None:
            return cached
        if _ML_SCORER_PATH is not None and _ML_SCORER_PATH.exists():
            from .cost_model import MLScorer

            try:
                scorer = MLScorer.from_json(
                    json.loads(_ML_SCORER_PATH.read_text()))
                mtime = _ML_SCORER_PATH.stat().st_mtime_ns
            except (ValueError, KeyError, TypeError, json.JSONDecodeError,
                    OSError):
                pass  # damaged/unreadable pipeline file: retrain below
            else:
                _ml_scorer_factory.__dict__["_cached"] = scorer
                _ml_scorer_factory.__dict__["_cached_mtime"] = mtime
                return scorer
        scorer = _train_ml_scorer()
        if _ML_SCORER_PATH is not None:
            try:
                _ML_SCORER_PATH.parent.mkdir(parents=True, exist_ok=True)
                tmp = _ML_SCORER_PATH.with_suffix(".json.tmp")
                tmp.write_text(json.dumps(scorer.to_json()))
                tmp.replace(_ML_SCORER_PATH)
                _ml_scorer_factory.__dict__["_cached_mtime"] = \
                    _ML_SCORER_PATH.stat().st_mtime_ns
            except OSError:
                pass  # persistence is best-effort; the in-memory cache holds
        return scorer


def _train_ml_scorer() -> Callable:
    import numpy as np

    from .cost_model import MLScorer, ResourcePipeline
    from .dataset import corpus_programs, synthetic_pnr
    from .features import extract_features

    opts = SolverOptions(max_solutions=8, n_budget=8, allow_duplication=False)
    rows, labels = [], {"lut": [], "ff": [], "bram": []}
    for _name, prog in corpus_programs(seed=0)[:6]:
        up = unroll(prog)
        for memname, mem in prog.memories.items():
            groups = build_groups(up, memname)
            for s in solve(mem, groups, up.iterators, opts)[:8]:
                rows.append(extract_features(s, groups))
                lab = synthetic_pnr(s)
                for k in labels:
                    labels[k].append(lab[k])
    X = np.asarray(rows)
    pipes = {
        k: ResourcePipeline(gbt_params=dict(n_estimators=40)).fit(
            X, np.asarray(v))
        for k, v in labels.items()
    }
    scorer = MLScorer(pipes)
    _ml_scorer_factory.__dict__["_cached"] = scorer
    return scorer


_ML_TRAIN_LOCK = threading.Lock()

register_scorer("proxy", lambda: None)
register_scorer("ml", _ml_scorer_factory)


def rank_solutions(
    sols: List[BankingSolution],
    scorer: Optional[Callable[[BankingSolution], float]] = None,
) -> List[BankingSolution]:
    """Order candidate schemes best-first.

    ``scorer`` is normally the ML cost model (core.cost_model.MLScorer);
    without one we fall back to the weighted resource proxy -- this fallback
    is exactly the 'first-order rules' behaviour the paper improves upon.
    """
    for s in sols:
        if scorer is not None:
            s.score = float(scorer(s))
        elif s.resources is not None:
            s.score = s.resources.total.weighted()
    return sorted(sols, key=lambda s: s.score)


# ---------------------------------------------------------------------------
# Canonical program signatures
# ---------------------------------------------------------------------------


def _affine_payload(e: Affine) -> list:
    return [list(map(list, e.terms)), list(map(list, e.syms)), e.const]


def _groups_payload(groups: List[AccessGroup]) -> list:
    return [
        [
            {
                "exprs": [_affine_payload(e) for e in a.exprs],
                "write": a.is_write,
                "cycle": a.sched_cycle,
            }
            for a in g
        ]
        for g in groups
    ]


def _iterators_payload(groups: List[AccessGroup],
                       iters: Dict[str, Iterator]) -> list:
    used = set()
    for g in groups:
        for a in g:
            for e in a.exprs:
                used.update(e.iterator_names)
    return [
        [it.name, it.start, it.step, it.count]
        for name in sorted(used)
        if (it := iters.get(name)) is not None
    ]


def _problem_payload(mem: MemorySpec, groups: List[AccessGroup],
                     iters: Dict[str, Iterator]) -> dict:
    return {
        "v": SIGNATURE_VERSION,
        "memory": [list(mem.dims), mem.word_bits, mem.ports],
        "groups": _groups_payload(groups),
        "iterators": _iterators_payload(groups, iters),
    }


def _hash_payload(prefix: str, payload: dict) -> str:
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"),
                      default=list)
    return prefix + hashlib.sha256(blob.encode()).hexdigest()[:32]


def canonical_signature(mem: MemorySpec, groups: List[AccessGroup],
                        iters: Dict[str, Iterator],
                        opts: SolverOptions) -> str:
    """Stable content hash of one banking problem.

    Hashes exactly the inputs ``solve`` consumes -- the unrolled,
    concurrency-grouped access polytopes, the memory spec (minus its name:
    identity is structural), the iterator domains the accesses reference,
    and the solver options -- so structurally identical programs collide by
    construction.  The prefix encodes ``SIGNATURE_VERSION``, which is what
    ``DirectoryStore.sweep()`` keys stale-entry garbage collection on.
    """
    payload = _problem_payload(mem, groups, iters)
    payload["opts"] = asdict(opts)
    return _hash_payload(f"bp{SIGNATURE_VERSION}-", payload)


def family_signature(mem: MemorySpec, groups: List[AccessGroup],
                     iters: Dict[str, Iterator]) -> str:
    """Signature of the problem *family*: the access structure without the
    solver options.  Two submits whose canonical signatures differ only in
    options share a family -- any member's scheme is a valid (if possibly
    suboptimal) scheme for the others, which is what lets the service's
    stale-while-revalidate policy answer from a stored near-match while
    the exact solve runs in the background."""
    return _hash_payload(f"bf{SIGNATURE_VERSION}-",
                         _problem_payload(mem, groups, iters))


def program_signature(program: Program, memory: str,
                      opts: Optional[SolverOptions] = None) -> str:
    """Convenience wrapper: signature of ``(program, memory)`` as posed."""
    up = unroll(program)
    groups = build_groups(up, memory)
    return canonical_signature(program.memories[memory], groups,
                               up.iterators, opts or SolverOptions())


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------


@dataclass
class PlanRequest:
    """One banking problem posed to the planner."""

    program: Program
    memory: str
    opts: Optional[SolverOptions] = None
    scorer: ScorerLike = None      # None -> planner default
    use_cache: bool = True


@dataclass
class BankingPlan:
    """A durable banking decision: chosen scheme + provenance.

    ``solutions`` and ``groups`` are retained in-memory for fresh solves
    (and memory-cache hits) but are not serialized; a plan loaded from disk
    carries only the chosen scheme.
    """

    memory: str
    signature: str
    best: Optional[BankingSolution]
    solve_seconds: float = 0.0
    num_candidates: int = 0
    scorer_name: str = "proxy"
    status: str = "solved"   # solved | cached | cached-disk | timeout | error
    created_at: float = 0.0
    opts: SolverOptions = field(default_factory=SolverOptions)
    solutions: List[BankingSolution] = field(default_factory=list)
    groups: List[AccessGroup] = field(default_factory=list)
    error: str = ""
    family: str = ""         # options-free problem-family signature

    # -- compilation ---------------------------------------------------------
    def compile(self, backend: str = "torch") -> "CompiledBankingPlan":
        """Lower the chosen scheme to an executable CompiledBankingPlan.

        Plans produced by a planner route through that planner's compile
        cache (keyed by plan signature + backend, persisted alongside the
        JSON plan cache); detached plans compile standalone.
        """
        owner = getattr(self, "_planner", None)
        if owner is not None:
            return owner.compile(self, backend=backend)
        return compile_plan(self, backend=backend)

    # -- tabulation ------------------------------------------------------------
    def table_row(self) -> Dict[str, float]:
        """One benchmark-table row for the chosen scheme, including the
        budget axes joint planning accounts in (physical banks x
        duplicates, total bank volume)."""
        b = self.best
        r = b.resources.total if b is not None and b.resources else None
        banks = (b.num_banks * max(1, b.duplicates)) if b else 0
        return {
            "memory": self.memory,
            "lut": r.lut if r else float("nan"),
            "ff": r.ff if r else float("nan"),
            "bram": r.bram if r else 0,
            "dsp": r.dsp if r else 0,
            "banks": banks,
            "volume": banks * (b.bank_volume if b else 0),
            "seconds": self.solve_seconds,
        }

    def as_dict(self) -> dict:
        """Budget-accounting view of the chosen scheme: provenance plus
        the full :class:`~repro_torch.core.resources.SchemeResources`
        breakdown, so budget sums and the joint bench never reach into
        ``core/`` internals."""
        def est(e: Optional[ResourceEstimate]) -> Optional[dict]:
            if e is None:
                return None
            return {"lut": e.lut, "ff": e.ff, "bram": e.bram, "dsp": e.dsp}

        b = self.best
        res = b.resources if b is not None else None
        banks = (b.num_banks * max(1, b.duplicates)) if b else 0
        return {
            "memory": self.memory,
            "signature": self.signature,
            "status": self.status,
            "scorer": self.scorer_name,
            "seconds": self.solve_seconds,
            "score": float(b.score) if b is not None else None,
            "kind": b.kind if b is not None else None,
            "banks": banks,
            "bank_volume": b.bank_volume if b is not None else 0,
            "volume": banks * (b.bank_volume if b else 0),
            "duplicates": b.duplicates if b is not None else 0,
            "resources": None if res is None else {
                "total": est(res.total),
                "crossbar": est(res.crossbar),
                "resolution": est(res.resolution),
                "storage": est(res.storage),
            },
            "error": self.error,
        }

    # -- serialization -------------------------------------------------------
    def to_json(self) -> dict:
        return {
            "format": "banking-plan/v1",
            "memory": self.memory,
            "signature": self.signature,
            "solve_seconds": self.solve_seconds,
            "num_candidates": self.num_candidates,
            "scorer_name": self.scorer_name,
            "status": self.status,
            "created_at": self.created_at,
            "opts": asdict(self.opts),
            "best": _solution_to_json(self.best) if self.best else None,
            "error": self.error,
            "family": self.family,
        }

    @staticmethod
    def from_json(d: dict) -> "BankingPlan":
        if d.get("format") != "banking-plan/v1":
            raise ValueError(f"not a banking plan: format={d.get('format')!r}")
        opts_d = dict(d.get("opts") or {})
        for k in ("b_candidates", "duplication_factors"):
            if k in opts_d:
                opts_d[k] = tuple(opts_d[k])
        opts = SolverOptions(**opts_d)
        best = _solution_from_json(d["best"], opts) if d.get("best") else None
        return BankingPlan(
            memory=d["memory"],
            signature=d["signature"],
            best=best,
            solve_seconds=d.get("solve_seconds", 0.0),
            num_candidates=d.get("num_candidates", 0),
            scorer_name=d.get("scorer_name", "proxy"),
            status=d.get("status", "solved"),
            created_at=d.get("created_at", 0.0),
            opts=opts,
            error=d.get("error", ""),
            family=d.get("family", ""),
        )

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(path.suffix + ".tmp")
        tmp.write_text(json.dumps(self.to_json(), indent=1, sort_keys=True))
        tmp.replace(path)
        return path

    @staticmethod
    def load(path) -> "BankingPlan":
        return BankingPlan.from_json(json.loads(Path(path).read_text()))


# -- BankingSolution <-> JSON ------------------------------------------------


def _solution_to_json(sol: BankingSolution) -> dict:
    from .geometry import FlatGeometry, MultiDimGeometry  # noqa: F401

    g = sol.geometry
    if sol.kind == "flat":
        geo = {"N": g.N, "B": g.B, "alpha": list(g.alpha), "P": list(g.P)}
    else:
        geo = {"Ns": list(g.Ns), "Bs": list(g.Bs), "alphas": list(g.alphas)}
    res = None
    if sol.resources is not None:
        res = {
            part: asdict(getattr(sol.resources, part))
            for part in ("total", "crossbar", "resolution", "storage")
        }
    return {
        "memory": {"name": sol.memory.name, "dims": list(sol.memory.dims),
                   "word_bits": sol.memory.word_bits,
                   "ports": sol.memory.ports},
        "kind": sol.kind,
        "geometry": geo,
        "P": list(sol.P),
        "pad": list(sol.pad),
        "required_ports": sol.required_ports,
        "num_banks": sol.num_banks,
        "bank_volume": sol.bank_volume,
        "fan_outs": list(sol.fan_outs),
        "max_fan_in": sol.max_fan_in,
        "duplicates": sol.duplicates,
        "raw_ops": dict(sol.raw_ops),
        "score": sol.score,
        "note": sol.note,
        "resources": res,
    }


def _solution_from_json(d: dict, opts: SolverOptions) -> BankingSolution:
    """Rebuild a solution, including its Sec-3.4 resolution graphs, so the
    loaded plan is directly usable by the banked-gather kernel."""
    from .geometry import FlatGeometry, MultiDimGeometry

    m = d["memory"]
    mem = MemorySpec(m["name"], dims=tuple(m["dims"]),
                     word_bits=m["word_bits"], ports=m["ports"])
    level = opts.transform_level
    P = tuple(d["P"])
    if d["kind"] == "flat":
        gd = d["geometry"]
        geo = FlatGeometry(N=gd["N"], B=gd["B"], alpha=tuple(gd["alpha"]),
                           P=P)
        in_bits = _flat_in_bits(mem, geo.alpha)
        ba, bo = build_flat_resolution(geo.N, geo.B, geo.alpha, P, mem.dims,
                                       in_bits, level=level)
        graphs = [ba]
    else:
        gd = d["geometry"]
        geo = MultiDimGeometry(Ns=tuple(gd["Ns"]), Bs=tuple(gd["Bs"]),
                               alphas=tuple(gd["alphas"]))
        in_bits = max(_flat_in_bits(mem, geo.alphas), 8)
        ba, bo = build_multidim_resolution(geo.Ns, geo.Bs, geo.alphas,
                                           mem.dims, in_bits, level=level)
        graphs = list(ba)
    arith = Cost()
    for node in graphs + [bo]:
        arith = arith + graph_cost(node, in_bits)
    raw = {"mul": 0, "div": 0, "mod": 0}
    for node in graphs + [bo]:
        r = count_raw_ops(node)
        raw = {k: raw[k] + r[k] for k in raw}
    resources = None
    if d.get("resources"):
        parts = {
            part: ResourceEstimate(**d["resources"][part])
            for part in ("total", "crossbar", "resolution", "storage")
        }
        resources = SchemeResources(**parts)
    return BankingSolution(
        memory=mem,
        kind=d["kind"],
        geometry=geo,
        P=P,
        pad=tuple(d["pad"]),
        required_ports=d["required_ports"],
        num_banks=d["num_banks"],
        bank_volume=d["bank_volume"],
        fan_outs=tuple(d["fan_outs"]),
        max_fan_in=d["max_fan_in"],
        duplicates=d.get("duplicates", 1),
        resolution_ba=ba,
        resolution_bo=bo,
        arith_cost=arith,
        raw_ops=raw,
        resources=resources,
        score=d.get("score", float("inf")),
        note=d.get("note", ""),
    )


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------


@dataclass
class PlannerStats:
    hits: int = 0
    disk_hits: int = 0
    misses: int = 0
    solves: int = 0
    compiles: int = 0
    compile_hits: int = 0
    compile_disk_hits: int = 0


@dataclass
class PreparedRequest:
    """A ``PlanRequest`` after the cheap synchronous half of planning:
    unroll + grouping + signatures, ready for a cache probe or a solve.

    ``PlanService.submit`` runs this part inline (so tickets carry real
    signatures and errors surface synchronously) and hands the prepared
    request to a worker for the expensive half.
    """

    request: PlanRequest
    mem: MemorySpec
    groups: List[AccessGroup]
    iterators: Dict[str, Iterator]
    opts: SolverOptions
    scorer_spec: ScorerLike
    scorer_name: str
    signature: str
    family: str

    @property
    def memory(self) -> str:
        return self.request.memory


class BankingPlanner:
    """Plan-oriented entry point: signature-keyed cache over the solver.

    Parameters
    ----------
    opts : default ``SolverOptions`` for requests that don't carry their own
    scorer : default scorer spec (registry name or callable)
    cache_dir : sugar for ``store=DirectoryStore(cache_dir)`` -- the legacy
        directory-of-JSON-plans layout, now shareable across processes
    store : a ``PlanStore`` consulted on in-memory misses; solved plans and
        compiled artifacts are persisted there
    max_workers : thread-pool width for ``plan_all`` and the inline service
    """

    def __init__(self, *, opts: Optional[SolverOptions] = None,
                 scorer: ScorerLike = "proxy",
                 cache_dir: Optional[Union[str, Path]] = None,
                 store: Optional[Union[PlanStore, str, Path]] = None,
                 max_workers: Optional[int] = None):
        from .store import DirectoryStore

        self.opts = opts or SolverOptions()
        self.scorer = scorer
        self.store = as_store(store)
        if self.store is None and cache_dir is not None:
            self.store = DirectoryStore(cache_dir)
        # legacy attribute: the directory plans persist in, when any
        self.cache_dir = (self.store.path
                          if isinstance(self.store, DirectoryStore) else
                          (Path(cache_dir) if cache_dir is not None else None))
        self.max_workers = max_workers
        self.stats = PlannerStats()
        self._cache: Dict[str, BankingPlan] = {}
        self._compiled: Dict[str, CompiledBankingPlan] = {}
        # strong refs to callable scorers keyed by their cache name: keeps
        # the id() embedded in the key unique for the cache's lifetime
        # (a GC'd lambda's address could otherwise be reused by a new one)
        self._scorer_pins: Dict[str, object] = {}
        self._lock = threading.Lock()
        self._service = None
        # measured-cost hub (see PlanService.enable_telemetry): when set,
        # every artifact compile() hands out is instrumented for timing
        self.telemetry = None
        if self.cache_dir is not None:
            # trained "ml" pipelines persist next to the plan cache.
            # First planner with a cache_dir wins: a later throwaway
            # planner must not silently redirect where the process-wide
            # scorer persists (set_ml_scorer_path overrides explicitly).
            with _ML_TRAIN_LOCK:
                global _ML_SCORER_PATH
                if _ML_SCORER_PATH is None:
                    _ML_SCORER_PATH = self.cache_dir / "ml_scorer.json"

    # -- the inline service ----------------------------------------------------
    @property
    def service(self):
        """The planner's inline :class:`PlanService` -- ``plan()`` is a
        thin ``service.submit(...).result()`` so the blocking and async
        front doors share one prepare -> lookup -> solve code path."""
        if self._service is None:
            from .service import PlanService
            # constructing a service claims the planner's slot under the
            # planner lock (first one wins; a racing loser is discarded)
            PlanService(planner=self, workers=self.max_workers or 8)
        return self._service

    # -- cache plumbing ------------------------------------------------------
    def _cache_key(self, signature: str, scorer_name: str) -> str:
        return f"{signature}/{scorer_name}"

    def _adopt(self, plan: BankingPlan) -> BankingPlan:
        """Attach the planner backref so plan.compile() hits our caches."""
        plan._planner = self
        return plan

    def _hit_copy(self, hit: BankingPlan, memory: str,
                  status: str) -> BankingPlan:
        """Cache-hit view: own lists (so caller mutations can't poison the
        cache) relabeled for the requesting memory.  Signatures are
        structural, so the underlying solutions may carry the name of the
        memory that first posed this problem."""
        out = copy.copy(hit)
        out.status = status
        out.memory = memory
        out.solutions = list(hit.solutions)
        out.groups = list(hit.groups)
        return self._adopt(out)

    def warm_start(self, source: Union[str, Path, PlanStore]) -> int:
        """Preload plans -- and their compiled artifacts -- from a store,
        a directory, or a single JSON file into the in-memory caches.
        Returns the number of plans + artifacts loaded; a warm-started
        planner skips both re-solving and re-lowering."""
        if not isinstance(source, PlanStore):
            path = Path(source)
            if not path.is_dir():
                if path.name.endswith(".compiled.json"):
                    try:
                        art = CompiledBankingPlan.load(path)
                    except (ValueError, KeyError, json.JSONDecodeError,
                            OSError):
                        return 0
                    with self._lock:
                        self._compiled[self._compile_key(
                            art.signature, art.scorer_name,
                            art.backend)] = art
                    return 1
                try:
                    plan = BankingPlan.load(path)
                except (ValueError, KeyError, json.JSONDecodeError, OSError):
                    return 0
                with self._lock:
                    self._cache[self._cache_key(plan.signature,
                                                plan.scorer_name)] = plan
                return 1
            source = as_store(path)
        n = 0
        for plan in source.plans():
            with self._lock:
                self._cache[self._cache_key(plan.signature,
                                            plan.scorer_name)] = plan
            n += 1
        for art in source.artifacts():
            with self._lock:
                self._compiled[self._compile_key(
                    art.signature, art.scorer_name, art.backend)] = art
            n += 1
        return n

    def clear_cache(self) -> None:
        with self._lock:
            self._cache.clear()
            self._compiled.clear()
            self._scorer_pins.clear()

    # -- compilation ---------------------------------------------------------
    def _compile_key(self, signature: str, scorer_name: str,
                     backend: str) -> str:
        return f"{signature}/{scorer_name}/{backend}"

    def compile(self, plan: BankingPlan,
                backend: str = "torch") -> CompiledBankingPlan:
        """Lower ``plan`` to a CompiledBankingPlan through the compile
        cache.

        Artifacts are keyed by (plan signature, scorer, backend) and
        persist in the plan store (for a ``DirectoryStore``, as
        ``<sig>.<scorer>.<backend>.compiled.json`` beside the JSON plans),
        so a warm-started planner skips re-lowering the resolution
        circuits as well as re-solving."""
        key = self._compile_key(plan.signature, plan.scorer_name, backend)
        with self._lock:
            hit = self._compiled.get(key)
        if hit is not None:
            self.stats.compile_hits += 1
            return self._maybe_instrument(hit)
        if self.store is not None:
            art = self.store.get_artifact(plan.signature, plan.scorer_name,
                                          backend)
            if art is not None:
                with self._lock:
                    self._compiled[key] = art
                self.stats.compile_disk_hits += 1
                return self._maybe_instrument(art)
        art = compile_plan(plan, backend=backend)
        art.scorer_name = plan.scorer_name
        self.stats.compiles += 1
        with self._lock:
            self._compiled[key] = art
        if self.store is not None:
            self.store.put_artifact(art)
        return self._maybe_instrument(art)

    def _maybe_instrument(self, art: CompiledBankingPlan
                          ) -> CompiledBankingPlan:
        """Attach the telemetry hub's timing sink to an artifact we hand
        out (no-op without an enabled hub)."""
        if self.telemetry is not None:
            self.telemetry.instrument(art)
        return art

    def evict(self, signature: str, scorer_name: str) -> None:
        """Forget a (signature, scorer) plan everywhere we cache it: the
        in-memory plan cache, the compile cache, and the plan store --
        demotion's eviction of a measured loser.  The next submit for the
        signature cold-solves."""
        with self._lock:
            self._cache.pop(self._cache_key(signature, scorer_name), None)
            prefix = f"{signature}/{scorer_name}/"
            for key in [k for k in self._compiled
                        if k.startswith(prefix)]:
                self._compiled.pop(key, None)
        if self.store is not None:
            self.store.delete(signature, scorer_name)

    # -- planning ------------------------------------------------------------
    def signature(self, program: Program, memory: str,
                  opts: Optional[SolverOptions] = None) -> str:
        return program_signature(program, memory, opts or self.opts)

    def prepare(self, request: Union[PlanRequest, Program],
                memory: Optional[str] = None, *,
                opts: Optional[SolverOptions] = None,
                scorer: ScorerLike = None,
                use_cache: bool = True) -> PreparedRequest:
        """The cheap synchronous half of planning: normalize the request,
        unroll + group the program, and compute signatures.  Raises for
        unknown memories and unregistered scorers -- submit-time errors
        must surface to the caller, not inside a worker thread."""
        if isinstance(request, PlanRequest):
            req = request
        else:
            if memory is None:
                raise TypeError("plan(program, memory) requires a memory name")
            req = PlanRequest(program=request, memory=memory, opts=opts,
                              scorer=scorer, use_cache=use_cache)
        opts = req.opts or self.opts
        spec = req.scorer if req.scorer is not None else self.scorer
        # key only; the factory (e.g. "ml" lazy training) runs on miss
        scorer_name = scorer_key(spec)
        if callable(spec):
            with self._lock:
                self._scorer_pins[scorer_name] = spec
        up = unroll(req.program)
        groups = build_groups(up, req.memory)
        mem = req.program.memories[req.memory]
        return PreparedRequest(
            request=req, mem=mem, groups=groups, iterators=up.iterators,
            opts=opts, scorer_spec=spec, scorer_name=scorer_name,
            signature=canonical_signature(mem, groups, up.iterators, opts),
            family=family_signature(mem, groups, up.iterators),
        )

    def lookup(self, prep: PreparedRequest) -> Optional[BankingPlan]:
        """Cache probe for a prepared request: the in-memory cache first,
        then the plan store.  Returns a relabeled hit copy or ``None``."""
        key = self._cache_key(prep.signature, prep.scorer_name)
        with self._lock:
            hit = self._cache.get(key)
        if hit is not None:
            self.stats.hits += 1
            return self._hit_copy(hit, prep.memory, "cached")
        if self.store is not None:
            plan = self.store.get(prep.signature, prep.scorer_name)
            if plan is not None:
                with self._lock:
                    self._cache[key] = plan
                self.stats.disk_hits += 1
                return self._hit_copy(plan, prep.memory, "cached-disk")
        return None

    def build_space(self, prep: PreparedRequest):
        """Enumerate the pruned candidate space for a prepared request.

        The single cold-solve chokepoint: the service's sharded workers,
        the blocking ``plan()``, and direct ``solve_prepared`` calls all
        start a solve here -- one place to instrument (or gate, in
        tests) every path that is about to do solver work.
        """
        from .candidates import CandidateSpace

        return CandidateSpace(prep.mem, prep.groups, prep.iterators,
                              prep.opts)

    def complete_solve(self, prep: PreparedRequest, solutions:
                       List[BankingSolution], solve_seconds: float,
                       scorer_fn: Optional[Callable] = None,
                       verify: Optional[Callable] = None
                       ) -> BankingPlan:
        """Rank merged solutions, build the plan, cache, persist.

        The back half of every solve: the sharded service reducer and
        the in-thread ``solve_prepared`` both end here.  ``verify`` is
        the service's certify-before-cache hook: called with
        ``(plan, prep)`` before anything is cached or persisted, and a
        raise (``repro_torch.analysis.CertificationError``) aborts both --
        an uncertified scheme never enters the cache or the store."""
        if scorer_fn is None:
            _, scorer_fn = resolve_scorer(prep.scorer_spec)
        ranked = rank_solutions(solutions, scorer_fn)
        self.stats.solves += 1
        plan = BankingPlan(
            memory=prep.memory,
            signature=prep.signature,
            best=ranked[0] if ranked else None,
            solve_seconds=solve_seconds,
            num_candidates=len(solutions),
            scorer_name=prep.scorer_name,
            status="solved",
            created_at=time.time(),
            opts=prep.opts,
            solutions=ranked,
            groups=prep.groups,
            family=prep.family,
        )
        if verify is not None:
            verify(plan, prep)
        with self._lock:
            self._cache[self._cache_key(prep.signature,
                                        prep.scorer_name)] = plan
        if self.store is not None:
            self.store.put(plan)
        return self._adopt(plan)

    def solve_prepared(self, prep: PreparedRequest) -> BankingPlan:
        """The expensive half, in-thread: enumerate -> evaluate (one
        shard) -> reduce -> rank -> persist."""
        from .candidates import solve_space

        self.stats.misses += 1
        _, scorer_fn = resolve_scorer(prep.scorer_spec)
        t0 = time.perf_counter()
        space = self.build_space(prep)
        sols = solve_space(space, scorer=scorer_fn)
        dt = time.perf_counter() - t0
        return self.complete_solve(prep, sols, dt, scorer_fn)

    def plan_prepared(self, prep: PreparedRequest) -> BankingPlan:
        """lookup-or-solve for an already-prepared request (worker path)."""
        if prep.request.use_cache:
            hit = self.lookup(prep)
            if hit is not None:
                return hit
        return self.solve_prepared(prep)

    def find_family(self, family: str, *,
                    exclude_signature: str = "") -> Optional[BankingPlan]:
        """Newest known plan of the same problem family (any solver
        options): in-memory cache first, then the store.  This is the
        near-match feeding stale-while-revalidate submits."""
        if not family:
            return None
        with self._lock:
            cands = [p for p in self._cache.values()
                     if p.family == family and p.best is not None
                     and p.signature != exclude_signature]
        if cands:
            return max(cands, key=lambda p: p.created_at)
        if self.store is not None:
            return self.store.find_family(
                family, exclude_signature=exclude_signature)
        return None

    def plan(self, request: Union[PlanRequest, Program],
             memory: Optional[str] = None, *,
             opts: Optional[SolverOptions] = None,
             scorer: ScorerLike = None,
             use_cache: bool = True) -> BankingPlan:
        """Plan one memory: cache hit or unroll->group->solve->rank.

        A thin ``submit(...).result()`` over the inline service: cache
        hits resolve synchronously inside ``submit``; misses run on the
        service's worker pool while this thread blocks on the ticket."""
        prep = self.prepare(request, memory, opts=opts, scorer=scorer,
                            use_cache=use_cache)
        return self.service.submit_prepared(prep).result()

    def plan_all(self, program: Program, *,
                 opts: Optional[SolverOptions] = None,
                 scorer: ScorerLike = None,
                 timeout: Optional[float] = None,
                 max_workers: Optional[int] = None,
                 budget=None) -> Dict[str, BankingPlan]:
        """Plan every memory of ``program`` concurrently.

        Rides the service's joint ticket graph: one
        :meth:`PlanService.submit_joint` fans the member solves across
        the service's own worker pool (or fabric).  ``budget=None``
        keeps the historical independent selection -- each memory's plan
        carries its own argmin scheme.  With a
        :class:`~repro_torch.core.jointplan.ResourceBudget`, each returned
        plan's ``best`` is instead the **jointly co-selected** scheme
        for that memory (possibly a cheaper point off its Pareto
        frontier, or the trivial single-bank fallback under pressure);
        the full :class:`~repro_torch.core.jointplan.JointPlan` is available
        via ``submit_joint`` directly.

        Each memory gets its own ``timeout`` budget (measured from when
        its result is collected, so memories queued behind a full pool
        are not charged for earlier solves); a memory that exceeds it
        yields a plan with ``status='timeout'`` and ``best=None`` (its
        solve keeps running in the background and will populate the
        cache for the next request).  ``max_workers`` is accepted for
        compatibility; the service pool sizes the fan-out.
        """
        del max_workers   # the service's worker pool drains the graph
        names = list(program.memories)
        out: Dict[str, BankingPlan] = {}
        try:
            joint = self.service.submit_joint(program, opts=opts,
                                              scorer=scorer, budget=budget)
        except Exception as e:   # prepare-time refusal: honest per-memory
            return {name: BankingPlan(
                memory=name, signature="", best=None,
                status="error", created_at=time.time(),
                opts=opts or self.opts, error=repr(e)) for name in names}
        for name in names:
            ticket = joint.members.get(name)
            if ticket is None:   # store-answered joint: members in plan
                continue
            try:
                out[name] = ticket.result(timeout=timeout)
            except TimeoutError:
                out[name] = BankingPlan(
                    memory=name, signature="", best=None,
                    status="timeout", created_at=time.time(),
                    opts=opts or self.opts,
                    error=f"exceeded {timeout}s budget")
            except Exception as e:  # solver bug: report, don't kill batch
                out[name] = BankingPlan(
                    memory=name, signature="", best=None,
                    status="error", created_at=time.time(),
                    opts=opts or self.opts, error=repr(e))
        if budget is not None or not out:
            # co-selected schemes replace the independent argmins; a
            # member that timed out here keeps its honest timeout plan
            # (the joint selection holds its trivial stand-in)
            if joint.wait(timeout=timeout):
                jplan = joint.result()
                for name, m in jplan.members.items():
                    p = out.get(name)
                    if p is None:
                        out[name] = BankingPlan(
                            memory=name, signature=m.signature,
                            best=m.chosen, status=jplan.status,
                            scorer_name=jplan.scorer_name,
                            created_at=jplan.created_at,
                            opts=opts or self.opts, error=m.error)
                    elif budget is not None \
                            and p.status not in ("timeout", "error") \
                            and m.chosen is not None:
                        out[name] = replace(p, best=m.chosen)
        return out


# ---------------------------------------------------------------------------
# Process-wide default planner (shims, serving, sharding)
# ---------------------------------------------------------------------------

_DEFAULT_PLANNER: Optional[BankingPlanner] = None
_DEFAULT_LOCK = threading.Lock()


def default_planner() -> BankingPlanner:
    """The shared in-memory-cached planner used by the default service,
    the serving hot path, and the sharding bridge."""
    global _DEFAULT_PLANNER
    with _DEFAULT_LOCK:
        if _DEFAULT_PLANNER is None:
            _DEFAULT_PLANNER = BankingPlanner()
        return _DEFAULT_PLANNER


__all__ = [
    "BankingPlan",
    "BankingPlanner",
    "CompiledBankingPlan",
    "PlanRequest",
    "PlannerStats",
    "PreparedRequest",
    "canonical_signature",
    "compile_plan",
    "default_planner",
    "family_signature",
    "program_signature",
    "rank_solutions",
    "register_scorer",
    "registered_scorers",
    "resolve_scorer",
    "set_ml_scorer_path",
]
