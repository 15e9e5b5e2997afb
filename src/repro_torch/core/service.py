"""PlanService: the asynchronous front door of the banking system.

The paper's pitch is that partitioning is *fast enough to sit inside a
compiler loop* -- but "fast" still means hundreds of milliseconds for a
cold solve, which is an eternity on a serving hot path.  Every consumer
used to eat that cost inline by calling ``BankingPlanner.plan()``.  This
module turns the front door into **submit -> ticket -> compile ->
execute**:

* :meth:`PlanService.submit` runs only the cheap half of planning inline
  (unroll + grouping + signatures + cache probe) and returns a
  :class:`PlanTicket`.  Warm caches and warm :class:`~repro_torch.core.store`
  stores resolve the ticket *before* it is returned -- zero solver work,
  no thread hop.
* Misses are queued (priority-ordered) and drained by a small daemon
  worker pool into the shared :class:`BankingPlanner` -- one code path
  for sync and async planning; ``BankingPlanner.plan`` is itself
  ``service.submit_prepared(...).result()``.
* ``ticket.fallback()`` returns an *immediately usable* compiled artifact
  (the trivial single-bank scheme, or a stored same-family near-match)
  so a caller can pack tables and serve traffic NOW and atomically
  hot-swap to ``ticket.artifact()`` when the solve lands -- the pattern
  ``runtime/server.py`` uses between decode ticks.
* :class:`StaleWhileRevalidate`: when a submit's canonical signature
  misses but the store holds a plan of the same problem *family* (same
  memory + access polytopes, drifted solver options), the ticket serves
  that near-match as its provisional artifact while the exact solve runs
  speculatively in the background.
* Cold solves are **sharded**: the claiming worker enumerates the
  problem's :class:`~repro_torch.core.candidates.CandidateSpace`, splits it
  into up to ``shard_budget`` :class:`SolveShard` s, and fans them back
  across this same worker pool.  A
  :class:`~repro_torch.core.candidates.SolutionReducer` merges the shard
  streams; ``ticket.best_so_far()`` exposes its ranked best
  incrementally, so consumers (the serving runtime's hot swap) can
  promote to the current best scheme *before* the full search drains --
  and ``ticket.result()`` still returns exactly the scheme the
  monolithic search would have chosen.  With no explicit
  ``shard_budget`` the fan-out is sized **adaptively** from the
  enumerated space, so small problems skip fan-out overhead.
* The shard executor is **selectable** (``executor="pool" | "fabric"``,
  per-service or per-ticket): ``"fabric"`` drives the same work
  units over a :class:`~repro_torch.core.fabric.SolveFabric` of remote
  worker processes -- one reducer, many hosts -- with the reducer's cut
  bounds broadcast live so remote shards prune like local ones.  A
  fabric with no attached workers falls back to the pool.

Tickets deduplicate in-flight work: two submits of the same
(signature, scorer) share one solve.

The front door is **multi-tenant** (:mod:`repro_torch.runtime.tenancy`):
``PlanService(tenants=TenantRegistry(...))`` + ``submit(...,
tenant="name")`` gives each consumer a QoS class (priority band,
fair-share weight, in-flight/deferral quotas, shard and fabric-lease
caps), an :class:`~repro_torch.runtime.tenancy.AdmissionController` that
defers -- honestly, fallback still served -- or sheds over-quota cold
solves, weighted fair-share queue draining so a noisy tenant cannot
starve the rest, and an exact per-tenant stats slice
(``stats.for_tenant(name)``).
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from ..runtime.tenancy import (
    DEFAULT_TENANT,
    AdmissionController,
    AdmissionError,
    FairShareQueue,
    TenantRegistry,
)
from .artifact import CompiledBankingPlan, compile_solution, compile_trivial
from .candidates import SolutionReducer, SolveShard, evaluate
from .planner import (
    BankingPlan,
    BankingPlanner,
    PlanRequest,
    PreparedRequest,
    ScorerLike,
    default_planner,
    resolve_scorer,
)
from .jointplan import (
    FrontierPoint,
    JointMember,
    JointPlan,
    JointRequest,
    JointSelection,
    ResourceBudget,
    co_select,
    joint_signature,
    pareto_frontier,
    trivial_solution,
)
from .polytope import MemorySpec
from .solver import BankingSolution, SolverOptions
from .store import PlanStore, as_store
from .tracing import NULL_SPAN, new_trace_id


@dataclass
class StaleWhileRevalidate:
    """Policy for answering submits from a stored near-match.

    ``enabled``: serve a same-family plan (same memory + access structure,
    drifted solver options/scorer) as the ticket's provisional artifact
    while the exact solve runs in the background.
    ``max_age``: ignore near-matches older than this many seconds
    (``None`` = any age).
    """

    enabled: bool = True
    max_age: Optional[float] = None

    def pick(self, planner: BankingPlanner,
             prep: PreparedRequest) -> Optional[BankingPlan]:
        if not self.enabled:
            return None
        plan = planner.find_family(prep.family,
                                   exclude_signature=prep.signature)
        if plan is None:
            return None
        if (self.max_age is not None
                and time.time() - plan.created_at > self.max_age):
            return None
        return plan


class PlanTicket:
    """Future-like handle for one submitted banking problem.

    States: ``queued`` -> ``solving`` -> ``done`` | ``error``; a ticket
    answered synchronously (cache/store hit) is born ``done``; one with a
    stale near-match attached is ``revalidating`` until its exact solve
    lands.  ``fallback()`` always returns immediately with an executable
    artifact -- the stored near-match when one exists, else the trivial
    single-bank scheme -- so callers can execute *now* and hot-swap when
    ``done()`` flips.
    """

    def __init__(self, *, service: "PlanService", prep: PreparedRequest,
                 priority: int = 0, shard_budget: Optional[int] = None,
                 executor: Optional[str] = None, verify: str = "off",
                 tenant: str = DEFAULT_TENANT):
        self._service = service
        self._prep = prep
        self.memory = prep.memory
        self.signature = prep.signature
        self.family = prep.family
        self.scorer_name = prep.scorer_name
        self.priority = priority
        self.shard_budget = shard_budget
        self.executor = executor     # None = the service default
        self.verify = verify         # resolved verification mode
        self.tenant = tenant         # resolved tenant name
        self.deferred = False        # parked by admission control
        self.submitted_at = time.time()
        self.resolved_at: Optional[float] = None
        self.status = "queued"
        # observability: the per-ticket trace (None when tracing is
        # off) and the honest latency attribution --
        # queue_ms / deferred_ms accumulate wall time the ticket spent
        # waiting for a worker / parked by admission, measured from
        # monotonic timestamps whether or not spans record them
        self.trace_id: Optional[str] = None
        self._root_span = None
        self.queue_ms = 0.0
        self.deferred_ms = 0.0
        self._queued_at: Optional[float] = None
        self._deferred_at: Optional[float] = None
        self._admitted = False       # holds one admission in-flight slot
        self._event = threading.Event()
        self._plan: Optional[BankingPlan] = None
        self._error: Optional[BaseException] = None
        self._stale: Optional[BankingPlan] = None
        self._fallbacks: Dict[str, CompiledBankingPlan] = {}
        self._reducer: Optional[SolutionReducer] = None
        self._best_arts: Dict[Tuple[int, str], CompiledBankingPlan] = {}
        self._final_version = 0
        self._claimed = False
        self._callbacks: List[Callable[["PlanTicket"], None]] = []
        self._lock = threading.Lock()

    # -- completion ------------------------------------------------------------
    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> BankingPlan:
        """The solved plan; blocks up to ``timeout`` seconds.  Raises
        ``TimeoutError`` on expiry and re-raises solver exceptions."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"plan {self.signature} not solved within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._plan

    def artifact(self, timeout: Optional[float] = None,
                 backend: str = "torch") -> CompiledBankingPlan:
        """The *solved* compiled artifact (blocks like ``result``)."""
        return self._service.planner.compile(self.result(timeout),
                                             backend=backend)

    # -- progressive results -------------------------------------------------------
    def best_so_far(self) -> Optional[BankingSolution]:
        """The best-ranked scheme the sharded search has admitted so far.

        ``None`` until the first valid candidate lands; never regresses
        in score as shards stream in; equal to ``result().best`` once
        the ticket resolves.  A ticket whose search *failed* keeps
        serving the partial best the dead search had found.  Consumers
        that can re-layout cheaply (the serving runtime's page pool)
        promote to it between ticks instead of waiting for the full
        search to drain.
        """
        if self._event.is_set() and self._error is None \
                and self._plan is not None:
            return self._plan.best
        red = self._reducer
        return red.best() if red is not None else None

    def best_version(self) -> int:
        """Monotone counter: bumps each time ``best_so_far`` improves.
        Poll it to promote only when the best actually changed."""
        red = self._reducer
        return red.version if red is not None else self._final_version

    def _release_reducer(self) -> None:
        """Drop the search machinery once the plan holds the answer --
        the reducer pins the whole candidate space, conflict caches, and
        every admitted solution, which a resolved ticket no longer
        needs."""
        red = self._reducer
        if red is not None:
            self._final_version = red.version
            self._reducer = None
        with self._lock:
            self._best_arts.clear()

    def best_so_far_artifact(self, backend: str = "torch"
                             ) -> Optional[CompiledBankingPlan]:
        """Compiled artifact of the current best-so-far scheme (the
        solved artifact once done; a failed search's partial best, like
        ``best_so_far``).  Lowering is cached per best-version, so
        polling between ticks re-lowers only on improvement."""
        if self.done() and self._error is None:
            if self._plan is None or self._plan.best is None:
                return None
            return self._service.planner.compile(self._plan,
                                                 backend=backend)
        red = self._reducer
        if red is None:
            return None
        sol, version = red.best_with_version()
        if sol is None:
            return None
        key = (version, backend)
        with self._lock:
            art = self._best_arts.get(key)
        if art is not None:
            return art
        art = compile_solution(sol, signature=self.signature,
                               backend=backend,
                               scorer_name=self.scorer_name)
        hub = self._service.telemetry
        if hub is not None:
            hub.instrument(art)
        with self._lock:
            # keep only the newest version per backend: stale lowers
            # are dead weight once the best has moved on
            for k in [k for k in self._best_arts if k[1] == backend]:
                del self._best_arts[k]
            self._best_arts[key] = art
        return art

    # -- immediate execution -----------------------------------------------------
    @property
    def stale_plan(self) -> Optional[BankingPlan]:
        """The same-family near-match serving as provisional answer."""
        return self._stale

    def fallback(self, backend: str = "torch") -> CompiledBankingPlan:
        """An executable artifact available *now*, without the solver.

        Prefers the already-solved plan (free once ``done()``), then the
        stale same-family near-match, then the trivial single-bank
        scheme.  Use it to serve immediately; hot-swap to ``artifact()``
        when the ticket resolves.
        """
        if self.done() and self._error is None \
                and self._plan is not None and self._plan.best is not None:
            return self._service.planner.compile(self._plan, backend=backend)
        if self._stale is not None:
            return self._service.planner.compile(self._stale, backend=backend)
        with self._lock:
            art = self._fallbacks.get(backend)
            if art is None:
                art = self._service.trivial_artifact(self._prep.mem,
                                                     backend=backend)
                self._fallbacks[backend] = art
        return art

    # -- resolution (service-internal) -------------------------------------------
    def _claim(self) -> bool:
        """Exactly one queue entry may solve this ticket (a priority
        upgrade re-enqueues the same ticket; later pops are no-ops)."""
        with self._lock:
            if self._claimed or self._event.is_set():
                return False
            self._claimed = True
            self.status = "solving"
            return True

    def _resolve(self, plan: BankingPlan) -> None:
        self._plan = plan
        self.status = "done"
        self.resolved_at = time.time()
        self._event.set()
        self._fire_callbacks()

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self.status = "error"
        self.resolved_at = time.time()
        self._event.set()
        self._fire_callbacks()

    # -- completion callbacks ------------------------------------------------------
    def add_done_callback(self, fn: Callable[["PlanTicket"], None]) -> None:
        """Call ``fn(ticket)`` when this ticket resolves or fails.

        Fires on the resolving thread; a ticket that is already done
        fires immediately on the caller's.  This is how a joint ticket
        graph re-co-selects as member solves land -- callbacks must not
        block (or re-enter the service's submit path)."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def _fire_callbacks(self) -> None:
        with self._lock:
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:
            try:
                fn(self)
            except Exception:   # a consumer's bug must not kill the solve
                pass

    def as_dict(self) -> Dict[str, object]:
        """JSON-serializable ticket summary with honest latency
        attribution: ``queue_ms`` is time spent waiting for a worker,
        ``deferred_ms`` time parked by admission control -- both
        sourced from the same monotonic timestamps the trace spans
        record, so admission latency is attributable instead of folded
        into solve time."""
        now = time.time()
        resolved = self.resolved_at
        return {
            "memory": self.memory,
            "signature": self.signature,
            "scorer": self.scorer_name,
            "status": self.status,
            "tenant": self.tenant,
            "priority": self.priority,
            "deferred": self.deferred,
            "trace_id": self.trace_id,
            "submitted_at": self.submitted_at,
            "resolved_at": resolved,
            "latency_ms": round(((resolved if resolved is not None
                                  else now) - self.submitted_at) * 1e3, 3),
            "queue_ms": round(self.queue_ms, 3),
            "deferred_ms": round(self.deferred_ms, 3),
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"<PlanTicket {self.memory} {self.signature[:16]}... "
                f"{self.status}>")


class JointTicket:
    """Future-like handle for one whole-model joint planning problem.

    A ticket *graph*: one member :class:`PlanTicket` per memory, fanned
    out through the service's normal executors (pool or fabric, one
    tenant unit), plus a co-selection layer on top.  ``selection()``
    re-co-selects progressively as member solves land and best-so-far
    schemes improve -- ``best_so_far`` semantics lifted to the group --
    and ``best_version()`` bumps only when the *joint* selection
    actually changes, so pollers (the serving runtime's coherent
    multi-pool swap) re-lower only on improvement.  Once every member is
    terminal the final co-selection certifies each selected non-trivial
    scheme, persists as a :class:`~repro_torch.core.jointplan.JointPlan`, and
    ``result()`` returns it.

    One member's failure (solver error, certifier refusal, admission
    shed) never poisons the group: that memory degrades to the trivial
    single-bank scheme and co-selection continues over the rest.
    """

    def __init__(self, *, service: "PlanService", request: JointRequest,
                 preps: Dict[str, PreparedRequest], signature: str,
                 scorer_name: str, verify: str = "off",
                 tenant: str = DEFAULT_TENANT):
        self._service = service
        self.request = request
        self.signature = signature
        self.scorer_name = scorer_name
        self.verify = verify
        self.tenant = tenant
        self.budget = request.budget
        self.frontier_cap = max(2, int(request.frontier_cap))
        self.submitted_at = time.time()
        self.resolved_at: Optional[float] = None
        self.status = "queued"
        self.trace_id: Optional[str] = None
        self.members: Dict[str, PlanTicket] = {}
        self._preps = preps
        self._event = threading.Event()
        self._plan: Optional[JointPlan] = None
        self._error: Optional[BaseException] = None
        self._pending = 0
        self._finalized = False
        self._version = 0
        self._stamp: Optional[tuple] = None
        self._selection: Optional[JointSelection] = None
        self._sel_key: Optional[tuple] = None
        self._trivials: Dict[str, BankingSolution] = {}
        self._arts: Dict[Tuple[int, str], Dict[str, CompiledBankingPlan]] = {}
        self._certified: Dict[Tuple[str, tuple], Optional[dict]] = {}
        self._lock = threading.Lock()

    # -- completion ------------------------------------------------------------
    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> JointPlan:
        """The final joint plan; blocks up to ``timeout`` seconds."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"joint plan {self.signature} not solved within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._plan

    # -- wiring (service-internal) ----------------------------------------------
    def _register(self, name: str, ticket: PlanTicket) -> None:
        self.members[name] = ticket
        self._pending += 1

    def _arm(self) -> None:
        """Subscribe to every member's completion.  Called once, after
        all members are registered; a member that is already done (sync
        cache hit, shed) fires its callback immediately on this
        thread."""
        self.status = "solving"
        for name, t in self.members.items():
            t.add_done_callback(lambda _t, n=name: self._member_done(n))

    def _resolve_cached(self, plan: JointPlan) -> None:
        """Born-done path: the store already held this joint plan."""
        self._plan = plan
        self._finalized = True
        self.status = "done"
        self.resolved_at = time.time()
        self._event.set()

    def _member_done(self, name: str) -> None:
        with self._lock:
            self._pending -= 1
            last = self._pending == 0 and not self._finalized
            if last:
                self._finalized = True
        if last:
            try:
                self._finalize()
            except BaseException as e:
                self._error = e
                self.status = "error"
                self.resolved_at = time.time()
                self._event.set()
                tr = self._service.tracer
                if tr is not None and self.trace_id is not None:
                    tr.finish(self.trace_id, status="error",
                              anomaly="error")

    # -- frontiers -------------------------------------------------------------
    def _trivial_for(self, name: str) -> BankingSolution:
        with self._lock:
            sol = self._trivials.get(name)
        if sol is None:
            prep = self._preps[name]
            sol = trivial_solution(prep.mem, prep.groups, prep.iterators,
                                   prep.opts)
            with self._lock:
                self._trivials[name] = sol
        return sol

    def _frontier_for(self, name: str) -> "List[FrontierPoint]":
        """The member's current frontier: its full solved frontier once
        done, its best-so-far singleton while solving, trivial-only
        after a failure -- always non-empty."""
        t = self.members[name]
        sols: List[BankingSolution] = []
        if t.done():
            if t._error is None and t._plan is not None:
                # a disk-hydrated plan carries only its best scheme;
                # fresh and memory-cached plans keep the whole ranking
                sols = list(t._plan.solutions) or (
                    [t._plan.best] if t._plan.best is not None else [])
        else:
            best = t.best_so_far()
            if best is not None:
                sols = [best]
        return pareto_frontier(sols, trivial=self._trivial_for(name),
                               cap=self.frontier_cap)

    # -- progressive co-selection ------------------------------------------------
    def selection(self) -> JointSelection:
        """The current joint co-selection over whatever each member has
        produced so far (recomputed only when some member's state
        changed).  Pure function of member frontiers + budget, so the
        answer is invariant to the order solves happen to land in."""
        if self._event.is_set() and self._plan is not None:
            return self._final_selection()
        stamp = tuple((n, t.status, t.done(), t.best_version())
                      for n, t in sorted(self.members.items()))
        with self._lock:
            if stamp == self._stamp and self._selection is not None:
                return self._selection
        tr = self._service.tracer
        cs_stats = {} if tr is not None else None
        t_sel = time.perf_counter()
        frontiers = {n: self._frontier_for(n) for n in self.members}
        sel = co_select(frontiers, self.budget, stats_out=cs_stats)
        if tr is not None and self.trace_id is not None:
            tr.record(self.trace_id, "co-select", t_sel,
                      time.perf_counter(), progressive=True,
                      **(cs_stats or {}))
        with self._lock:
            if sel.key() != self._sel_key:
                self._version += 1
                self._sel_key = sel.key()
                self._service.stats.bump("joint_reselects",
                                         tenant=self.tenant)
            self._stamp = stamp
            self._selection = sel
        return sel

    def _final_selection(self) -> JointSelection:
        picks = {}
        for name, m in self._plan.members.items():
            sol = m.chosen if m.chosen is not None \
                else self._trivial_for(name)
            picks[name] = FrontierPoint(
                solution=sol, use=m.use, score=m.score, trivial=m.trivial)
        return JointSelection(picks=picks, total_use=self._plan.total_use,
                              total_score=self._plan.total_score,
                              feasible=self._plan.feasible)

    def best_version(self) -> int:
        """Monotone counter: bumps each time the joint selection
        changes.  Poll it to re-lower/promote only on improvement."""
        if not self._event.is_set():
            self.selection()
        with self._lock:
            return self._version

    # -- artifacts ---------------------------------------------------------------
    def artifacts(self, backend: str = "torch"
                  ) -> Dict[str, CompiledBankingPlan]:
        """Compiled artifacts of the current joint selection, one per
        memory -- lowered and cached per selection version, so polling
        between decode ticks re-lowers only when the selection moved."""
        sel = self.selection()
        with self._lock:
            version = self._version
            cached = self._arts.get((version, backend))
        if cached is not None:
            return dict(cached)
        arts: Dict[str, CompiledBankingPlan] = {}
        for name, pick in sel.picks.items():
            prep = self._preps[name]
            if pick.trivial:
                arts[name] = self._service.trivial_artifact(prep.mem,
                                                            backend=backend)
            else:
                art = compile_solution(pick.solution,
                                       signature=prep.signature,
                                       backend=backend,
                                       scorer_name=self.scorer_name)
                hub = self._service.telemetry
                if hub is not None:
                    hub.instrument(art)
                arts[name] = art
        with self._lock:
            # keep only the newest version per backend
            for k in [k for k in self._arts if k[1] == backend]:
                del self._arts[k]
            self._arts[(version, backend)] = arts
        return dict(arts)

    def fallback(self, backend: str = "torch"
                 ) -> Dict[str, CompiledBankingPlan]:
        """Immediately executable artifacts for every member (each
        member ticket's own fallback discipline) -- serve now, swap to
        ``artifacts()`` as the joint selection lands."""
        return {name: t.fallback(backend)
                for name, t in self.members.items()}

    # -- finalization ------------------------------------------------------------
    def _certify_pick(self, name: str, pick: "FrontierPoint"
                      ) -> Tuple[bool, Optional[dict]]:
        """Certify one selected scheme (cached per scheme); returns
        (ok, certificate-JSON)."""
        key = (name, pick.key())
        with self._lock:
            if key in self._certified:
                cert = self._certified[key]
                return cert is not None, cert
        from ..analysis.certify import certify_solution
        prep = self._preps[name]
        res = certify_solution(pick.solution, prep.groups, prep.iterators,
                               signature=prep.signature,
                               scorer=self.scorer_name)
        cert = (res.certificate.to_json()
                if res.ok and res.certificate is not None else None)
        with self._lock:
            self._certified[key] = cert
        return res.ok, cert

    def _finalize(self) -> None:
        """Every member is terminal: run the final co-selection, certify
        each selected scheme, persist, resolve.

        A certifier refusal evicts just that scheme from its member's
        frontier and re-co-selects -- the group never fails for one bad
        member, it degrades that member (ultimately to trivial, which
        needs no certificate because it serializes instead of banking).
        """
        service = self._service
        tr = service.tracer
        tid = self.trace_id if tr is not None else None
        frontiers = {n: self._frontier_for(n) for n in self.members}
        certs: Dict[str, Optional[dict]] = {}
        while True:
            cs_stats = {} if tr is not None else None
            t_sel = time.perf_counter()
            sel = co_select(frontiers, self.budget, stats_out=cs_stats)
            if tid is not None:
                tr.record(tid, "co-select", t_sel, time.perf_counter(),
                          final=True, **(cs_stats or {}))
            if self.verify == "off":
                break
            evicted = False
            for name, pick in sorted(sel.picks.items()):
                if pick.trivial:
                    continue
                ok, cert = self._certify_pick(name, pick)
                if ok:
                    certs[name] = cert
                else:
                    frontiers[name] = [p for p in frontiers[name]
                                       if p.key() != pick.key()]
                    service.stats.bump("joint_cert_evictions",
                                       tenant=self.tenant)
                    evicted = True
            if not evicted:
                break
        members: Dict[str, JointMember] = {}
        for name, pick in sel.picks.items():
            t = self.members[name]
            if t.done() and t._error is None and t._plan is not None:
                status, error = t._plan.status, t._plan.error
            else:
                status = "error"
                error = repr(t._error) if t._error is not None else ""
            cert = None if pick.trivial else certs.get(name)
            members[name] = JointMember(
                memory=name, signature=t.signature, status=status,
                chosen=pick.solution, trivial=pick.trivial,
                certified=cert is not None, certificate=cert,
                score=float(pick.solution.score), use=pick.use,
                error=error)
        plan = JointPlan(
            signature=self.signature, members=members, budget=self.budget,
            feasible=sel.feasible, scorer_name=self.scorer_name,
            status="solved", solve_seconds=time.time() - self.submitted_at,
            created_at=time.time(),
            opts=next(iter(self._preps.values())).opts)
        store = service.planner.store
        if store is not None and self.request.use_cache:
            store.put_joint(plan)
        service.stats.bump("joint_solved", tenant=self.tenant)
        if not sel.feasible:
            service.stats.bump("joint_infeasible", tenant=self.tenant)
        with self._lock:
            if sel.key() != self._sel_key:
                self._version += 1
                self._sel_key = sel.key()
            self._selection = sel
        self._plan = plan
        self.status = "done"
        self.resolved_at = time.time()
        self._event.set()
        if tid is not None:
            tr.finish(tid, status="ok",
                      anomaly=None if sel.feasible else "infeasible")

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"<JointTicket {self.signature[:16]}... "
                f"{len(self.members)} members {self.status}>")


@dataclass
class ServiceStats:
    submits: int = 0
    sync_hits: int = 0       # tickets born done (cache/store answered)
    deduped: int = 0         # submits merged onto an in-flight ticket
    queued: int = 0
    solved: int = 0
    errors: int = 0
    deferred: int = 0        # over-quota submits parked by admission
    shed: int = 0            # submits refused outright (backlog full)
    revalidations: int = 0   # tickets served a stale near-match
    shards_spawned: int = 0  # SolveShards fanned across the worker pool
    shards_completed: int = 0
    best_promotions: int = 0  # times a ticket's best-so-far improved
    dedup_hits: int = 0      # duplicate schemes dropped by the reducers
    adaptive_budgets: int = 0  # cold solves whose fan-out was auto-sized
    fabric_solves: int = 0   # cold solves run on the remote fabric
    fabric_fallbacks: int = 0  # fabric requested but no workers: pool ran
    fabric_leases: int = 0   # work units leased to remote workers
    fabric_requeues: int = 0  # leases requeued after worker death/timeout
    fabric_cut_broadcasts: int = 0  # cut snapshots pushed mid-flight
    fabric_workers_lost: int = 0
    fabric_heartbeats: int = 0  # liveness frames from remote workers
    observations: int = 0    # measured gather/scatter/tick timings logged
    refreshes: int = 0       # ml_scorer.json refits from measured pairs
    demotions: int = 0       # stored plans evicted for measured slowness
    certified: int = 0       # schemes independently certified before caching
    cert_failures: int = 0   # solver outputs refused by the certifier
    cert_rejected: int = 0   # fabric result batches rejected + requeued
    lint_errors: int = 0     # submits refused by the pre-solve lint pass
    joint_submits: int = 0   # whole-model submit_joint calls
    joint_sync_hits: int = 0  # joint tickets answered from the store
    joint_solved: int = 0    # joint tickets resolved with a selection
    joint_reselects: int = 0  # progressive co-selections as members landed
    joint_infeasible: int = 0  # budgets under even the all-trivial floor
    joint_cert_evictions: int = 0  # selected schemes refused + re-selected
    # per-tenant slices (global counters include every slice; a slice
    # never has its own sub-slices)
    tenants: Dict[str, "ServiceStats"] = field(default_factory=dict,
                                               repr=False, compare=False)
    # the MetricsRegistry mirror (enable_tracing wires it): every bump
    # ALSO lands as plan_<name>{tenant=...} through the same single
    # write path, so the registry subsumes this arithmetic without
    # breaking the exact per-tenant reconciliation
    metrics: Optional[object] = field(default=None, repr=False,
                                      compare=False)

    def bump(self, name: str, n: int = 1,
             tenant: Optional[str] = None) -> None:
        """Add ``n`` to counter ``name`` here AND on the tenant's slice.

        The single write path is what makes ``for_tenant`` slices
        reconcile *exactly* with the global counters: every global
        increment lands on exactly one slice (``tenant=None`` =
        the default tenant).  With a :class:`MetricsRegistry` attached
        the same increment mirrors there as ``plan_<name>`` with a
        ``tenant`` label -- one write, three consistent views.
        """
        setattr(self, name, getattr(self, name) + n)
        if self.tenants is not None:   # a slice doesn't slice further
            slice_ = self.for_tenant(tenant or DEFAULT_TENANT)
            setattr(slice_, name, getattr(slice_, name) + n)
        if self.metrics is not None:
            self.metrics.inc("plan_" + name, n,
                             tenant=tenant or DEFAULT_TENANT)

    def for_tenant(self, name: str) -> "ServiceStats":
        """The tenant's counter slice (created on first touch)."""
        stats = self.tenants.get(name)
        if stats is None:
            stats = ServiceStats(tenants=None)
            self.tenants[name] = stats
        return stats

    def as_dict(self, include_tenants: bool = True) -> Dict[str, object]:
        """Counters as a JSON-serializable dict; per-tenant slices nest
        under ``"tenants"`` (omitted when empty)."""
        out: Dict[str, object] = {
            k: v for k, v in vars(self).items() if isinstance(v, int)}
        if include_tenants and self.tenants:
            out["tenants"] = {
                name: s.as_dict(include_tenants=False)
                for name, s in sorted(self.tenants.items())}
        return out


@dataclass
class _SolveState:
    """Book-keeping for one in-flight sharded solve: the reducer shared
    by its shard jobs, plus completion/error accounting.  The worker
    that finishes the last shard finalizes the plan and resolves the
    ticket."""

    prep: PreparedRequest
    ticket: "PlanTicket"
    reducer: SolutionReducer
    scorer_fn: object
    started: float
    remaining: int
    failed: bool = False
    lock: threading.Lock = field(default_factory=threading.Lock)

    def shard_finished(self) -> bool:
        """True for exactly the caller that completed the last shard."""
        with self.lock:
            self.remaining -= 1
            return self.remaining == 0 and not self.failed

    def fail(self, exc: BaseException) -> bool:
        """Record the first failure; returns True for that first caller."""
        with self.lock:
            first = not self.failed
            self.failed = True
        if first:
            self.reducer.cancel()   # stop sibling shards early
        return first


@dataclass
class _ShardJob:
    state: _SolveState
    shard: SolveShard


_SENTINEL = None

EXECUTORS = ("pool", "fabric")

# Static-verification modes (repro_torch.analysis):
#   "off"   -- trust the solver (the historical behavior);
#   "store" -- lint programs before queueing, certify solver output
#              before it is cached/persisted, persist the certificate
#              beside the plan, re-verify store entries on hydrate;
#   "all"   -- "store" plus certification of every solution batch a
#              fabric worker streams back (bad batches are rejected and
#              their units requeued away from the sender).
VERIFY_MODES = ("off", "store", "all")


class PlanService:
    """submit/await planning: a priority queue of banking problems drained
    by daemon workers into one shared :class:`BankingPlanner`.

    Parameters
    ----------
    planner : the planner to answer through (default: a fresh one)
    store : plan store for a fresh planner (``PlanStore`` or directory
        path); ignored when ``planner`` is given
    workers : worker-pool width (threads spawn lazily on first miss)
    revalidate : the :class:`StaleWhileRevalidate` policy (pass
        ``StaleWhileRevalidate(enabled=False)`` to disable)
    shard_budget : shards per cold solve (per-submit override via
        ``submit(..., shard_budget=...)``); 1 disables sharding and the
        default ``None`` sizes the fan-out *adaptively* from each
        problem's enumerated candidate space
        (:meth:`CandidateSpace.suggested_shards`), so small spaces skip
        fan-out overhead entirely
    executor : where cold solves run -- ``"pool"`` (this process's
        worker threads) or ``"fabric"`` (remote shard workers attached
        to ``fabric``); per-submit override via
        ``submit(..., executor=...)``
    fabric : the :class:`~repro_torch.core.fabric.SolveFabric` backing the
        ``"fabric"`` executor (attach one later via
        :meth:`attach_fabric`); a fabric with no live workers falls
        back to the pool
    tenants : the :class:`~repro_torch.runtime.tenancy.TenantRegistry` naming
        this service's consumers and their QoS classes.  Submits tag
        themselves with ``submit(..., tenant="name")``: the tenant's
        QoS band offsets the ticket priority, its quotas gate admission
        (over-quota cold solves defer -- fallback still served -- and a
        full deferral backlog sheds with an honest
        :class:`~repro_torch.runtime.tenancy.AdmissionError`), its weight
        drives fair-share queue draining, and its shard/lease caps
        bound solver fan-out.  ``stats.for_tenant(name)`` is the
        tenant's exact counter slice.  Default: a fresh permissive
        registry (untagged submits behave exactly as before tenancy).
    """

    def __init__(self, planner: Optional[BankingPlanner] = None, *,
                 store: Optional[Union[PlanStore, str]] = None,
                 workers: int = 2,
                 revalidate: Optional[StaleWhileRevalidate] = None,
                 shard_budget: Optional[int] = None,
                 executor: str = "pool",
                 fabric=None,
                 verify: str = "off",
                 tenants: Optional[TenantRegistry] = None):
        if executor not in EXECUTORS:
            raise ValueError(
                f"unknown executor {executor!r}; one of {EXECUTORS}")
        if verify not in VERIFY_MODES:
            raise ValueError(
                f"unknown verify mode {verify!r}; one of {VERIFY_MODES}")
        if planner is None:
            planner = BankingPlanner(store=as_store(store))
        self.planner = planner
        self.verify = verify
        if verify != "off" and planner.store is not None \
                and hasattr(planner.store, "verify_hydrated"):
            # an armed service refuses to serve uncertified disk entries
            planner.store.verify_hydrated = True
        # claim the planner's inline-service slot when it's free, so
        # planner.plan() (= submit().result()) shares this queue/workers
        with planner._lock:
            if planner._service is None:
                planner._service = self
        self.revalidate = (revalidate if revalidate is not None
                           else StaleWhileRevalidate())
        self.stats = ServiceStats()
        self.tenants = tenants if tenants is not None else TenantRegistry()
        self._admission = AdmissionController(self.tenants)
        # always the fair-share queue, even single-tenant: equal-band
        # entries drain in submit order (seq tie-break), and tenant
        # weights only matter once a registry defines contending ones
        self._queue = FairShareQueue(self.tenants)
        self._seq = itertools.count()
        self._inflight: Dict[Tuple[str, str], PlanTicket] = {}
        self._trivial: Dict[Tuple, CompiledBankingPlan] = {}
        self._threads = []
        # queued + claimed-but-unfinished items; counted at enqueue time
        # (not from qsize()) so worker sizing can't race a fast pop
        self._outstanding = 0
        self._demand = threading.Lock()
        self._max_workers = max(1, int(workers))
        # None = adaptive: sized per problem from its candidate space
        self.shard_budget = (max(1, int(shard_budget))
                             if shard_budget is not None else None)
        self.executor = executor
        self._fabric = fabric
        self._shutdown = False
        self._lock = threading.Lock()
        self.telemetry = None   # ServiceTelemetry hub (enable_telemetry)
        # observability plane (enable_tracing): all hooks are guarded by
        # `tracer is None`, so an un-traced service pays one attr load
        self.tracer = None
        self.metrics = None
        self.recorder = None

    def attach_fabric(self, fabric) -> None:
        """Attach (or replace) the remote solve fabric backing the
        ``"fabric"`` executor."""
        self._fabric = fabric

    def enable_telemetry(self, config=None, log=None):
        """Turn on the measured-cost feedback loop.

        Builds a :class:`~repro_torch.core.telemetry.ServiceTelemetry` hub wired
        to this service and its planner: artifacts the planner compiles
        get timing hooks, answered plans are registered for demotion
        watch, observations flush into the store's ``telemetry/`` sidecar,
        and ``scorer="measured"`` submits rank on this service's own log.
        Returns the hub (idempotent: repeated calls return the same one).
        """
        if self.telemetry is None:
            from .telemetry import ServiceTelemetry
            hub = ServiceTelemetry(service=self, planner=self.planner,
                                   config=config, log=log)
            self.telemetry = hub
            self.planner.telemetry = hub
        return self.telemetry

    def enable_tracing(self, *, capacity: int = 64,
                       slo_ms: Optional[float] = None,
                       trace_dir: Optional[str] = None):
        """Turn on the observability plane (idempotent).

        Builds one :class:`~repro_torch.core.tracing.MetricsRegistry` (every
        ``stats.bump`` mirrors into it as ``plan_<counter>`` with a
        ``tenant`` label), one :class:`~repro_torch.core.tracing.Tracer`
        (each submit gets a ``trace_id`` whose spans cover
        prepare -> lookup -> admission -> queue-wait -> solve -> certify,
        stitched with remote fabric worker spans over the wire), and
        one :class:`~repro_torch.core.tracing.FlightRecorder` keeping the
        last ``capacity`` completed ticket traces -- dumped as Chrome
        ``trace_event`` JSON on demand or on anomaly (latency over
        ``slo_ms``, a certificate rejection, a telemetry demotion;
        anomaly dumps land in ``trace_dir`` when given).  Returns the
        tracer.
        """
        if self.tracer is None:
            from .tracing import FlightRecorder, MetricsRegistry, Tracer
            self.metrics = MetricsRegistry()
            self.recorder = FlightRecorder(capacity=capacity,
                                           slo_ms=slo_ms,
                                           trace_dir=trace_dir,
                                           metrics=self.metrics)
            self.tracer = Tracer(recorder=self.recorder,
                                 metrics=self.metrics)
            self.stats.metrics = self.metrics
            # queue depth / pops and admission backlog gauges
            self._queue.metrics = self.metrics
            self._admission.metrics = self.metrics
        return self.tracer

    # -- the front door ----------------------------------------------------------
    def submit(self, program, memory: Optional[str] = None, *,
               opts: Optional[SolverOptions] = None,
               scorer: ScorerLike = None,
               use_cache: bool = True,
               priority: int = 0,
               shard_budget: Optional[int] = None,
               executor: Optional[str] = None,
               verify: Optional[str] = None,
               tenant: Optional[str] = None) -> PlanTicket:
        """Pose one banking problem; returns a :class:`PlanTicket`.

        Runs unroll + grouping + signature + cache probe inline (bad
        memories / unknown scorers raise here, warm caches return a
        ticket that is already ``done()``); cold problems are queued for
        the worker pool, which fans each solve across up to
        ``shard_budget`` candidate-space shards (default: the service's,
        itself defaulting to an adaptive per-problem fan-out) -- or, with
        ``executor="fabric"``, across the attached remote solve workers.
        Lower ``priority`` solves first.

        ``verify`` ("off" | "store" | "all", default: the service's
        mode) arms the static verification layer for this submit: the
        program is linted before queueing (lint errors raise
        ``repro_torch.analysis.LintError`` here), solver output is
        independently certified before it is cached or persisted, and
        with "all" every fabric result batch is certified on intake.

        ``tenant`` names the submitting consumer (see the ``tenants``
        registry): its QoS class offsets the priority band, its quotas
        may defer or shed this submit's cold solve (deferral is honest
        -- ``ticket.deferred`` -- and the fallback artifact still serves
        immediately), and its stats slice records the submit.
        """
        tr = self.tracer
        trace_id = new_trace_id() if tr is not None else None
        t_prep = time.perf_counter()
        prep = self.planner.prepare(program, memory, opts=opts,
                                    scorer=scorer, use_cache=use_cache)
        if tr is not None:
            # the ticket doesn't exist yet: the trace does, and the
            # prepare stage is its first span
            tr.record(trace_id, "prepare", t_prep, time.perf_counter(),
                      memory=prep.memory)
        return self.submit_prepared(prep, priority=priority,
                                    shard_budget=shard_budget,
                                    executor=executor, verify=verify,
                                    tenant=tenant, _trace_id=trace_id)

    def submit_request(self, request: PlanRequest, *,
                       priority: int = 0) -> PlanTicket:
        return self.submit_prepared(self.planner.prepare(request),
                                    priority=priority)

    def submit_prepared(self, prep: PreparedRequest, *,
                        priority: int = 0,
                        shard_budget: Optional[int] = None,
                        executor: Optional[str] = None,
                        verify: Optional[str] = None,
                        tenant: Optional[str] = None,
                        _trace_id: Optional[str] = None) -> PlanTicket:
        if executor is not None and executor not in EXECUTORS:
            raise ValueError(
                f"unknown executor {executor!r}; one of {EXECUTORS}")
        if verify is not None and verify not in VERIFY_MODES:
            raise ValueError(
                f"unknown verify mode {verify!r}; one of {VERIFY_MODES}")
        verify = verify if verify is not None else self.verify
        ten = self.tenants.resolve(tenant)
        # the QoS band offsets the caller's priority: an interactive
        # tenant's priority-0 submit still outranks a batch tenant's
        priority = priority + ten.qos.priority
        tr = self.tracer
        trace_id = (_trace_id if _trace_id is not None
                    else (new_trace_id() if tr is not None else None))
        self.stats.bump("submits", tenant=ten.name)
        if verify != "off":
            # lint before anything queues: problems no banking can fix
            # (OOB accesses, colliding Syms, oversubscribed ports) must
            # fail the submit, not burn a solve
            with (tr.span(trace_id, "lint") if tr is not None
                  else NULL_SPAN):
                self._lint_gate(prep, ten.name)
        key = (prep.signature, prep.scorer_name)
        if prep.request.use_cache:
            t_look = time.perf_counter()
            hit = self.planner.lookup(prep)
            if tr is not None:
                tr.record(trace_id, "lookup", t_look, time.perf_counter(),
                          hit=hit is not None)
            if hit is not None:
                self.stats.bump("sync_hits", tenant=ten.name)
                ticket = PlanTicket(service=self, prep=prep,
                                    priority=priority, verify=verify,
                                    tenant=ten.name)
                ticket.trace_id = trace_id
                ticket._resolve(hit)
                if tr is not None:
                    tr.finish(trace_id, status="sync-hit",
                              label=f"ticket {prep.memory}")
                if self.telemetry is not None:
                    self.telemetry.register(prep, hit)
                return ticket
        ticket = PlanTicket(service=self, prep=prep, priority=priority,
                            shard_budget=shard_budget, executor=executor,
                            verify=verify, tenant=ten.name)
        ticket.trace_id = trace_id
        if tr is not None:
            tr.label(trace_id, f"ticket {prep.memory}")
            ticket._root_span = tr.begin(trace_id, "ticket",
                                         memory=prep.memory,
                                         tenant=ten.name,
                                         signature=prep.signature[:16])
        if prep.request.use_cache:
            # atomic check-and-register: concurrent submits of the same
            # (signature, scorer) must share ONE solve
            with self._lock:
                inflight = self._inflight.get(key)
                if inflight is None:
                    self._inflight[key] = ticket
            if inflight is not None:
                self.stats.bump("deduped", tenant=ten.name)
                if tr is not None:
                    # this submit rides the in-flight ticket's solve;
                    # close the newborn trace rather than leak it live
                    tr.end(ticket._root_span,
                           deduped_onto=inflight.trace_id or "")
                    tr.finish(trace_id, status="deduped")
                if priority < inflight.priority:
                    # urgency upgrade; a still-deferred ticket isn't in
                    # the queue yet -- it just keeps the better priority
                    # for when admission releases it
                    inflight.priority = priority
                    if not inflight.deferred:
                        # re-enqueue the same ticket at the new
                        # priority; _claim() makes later pops no-ops
                        self._enqueue((priority, next(self._seq),
                                       inflight._prep, inflight))
                return inflight
            stale = self.revalidate.pick(self.planner, prep)
            if stale is not None:
                ticket._stale = stale
                ticket.status = "revalidating"
                self.stats.bump("revalidations", tenant=ten.name)
        # admission: the cold solve claims one of the tenant's in-flight
        # slots, or parks in its deferral backlog, or -- backlog full --
        # sheds with an honest error (the fallback artifact still works)
        if self._admission.try_acquire(ten.name):
            ticket._admitted = True
        elif self._admission.defer(ten.name, (prep, ticket)):
            ticket.deferred = True
            ticket._deferred_at = time.perf_counter()
            if ticket.status == "queued":
                ticket.status = "deferred"
            self.stats.bump("deferred", tenant=ten.name)
            if tr is not None:
                tr.instant(trace_id, "admission-deferred",
                           tenant=ten.name)
            return ticket
        else:
            self.stats.bump("shed", tenant=ten.name)
            with self._lock:
                if self._inflight.get(key) is ticket:
                    del self._inflight[key]
            ticket._fail(AdmissionError(
                f"tenant {ten.name!r} over quota "
                f"(max_inflight={ten.qos.max_inflight}, "
                f"max_deferred={ten.qos.max_deferred}): submit shed; "
                f"the ticket's fallback artifact is still servable"))
            ticket.status = "shed"
            if tr is not None:
                if ticket._root_span is not None:
                    tr.end(ticket._root_span)
                    ticket._root_span = None
                tr.finish(trace_id, status="shed", anomaly="shed")
            return ticket
        self.stats.bump("queued", tenant=ten.name)
        ticket._queued_at = time.perf_counter()
        self._enqueue((priority, next(self._seq), prep, ticket))
        self._ensure_workers()
        return ticket

    # -- whole-model joint planning ----------------------------------------------
    def submit_joint(self, request, *,
                     memories: Optional[Sequence[str]] = None,
                     budget: Optional[ResourceBudget] = None,
                     opts: Optional[SolverOptions] = None,
                     scorer: ScorerLike = None,
                     use_cache: bool = True,
                     frontier_cap: int = 8,
                     priority: int = 0,
                     shard_budget: Optional[int] = None,
                     executor: Optional[str] = None,
                     verify: Optional[str] = None,
                     tenant: Optional[str] = None) -> JointTicket:
        """Pose one whole-model planning problem; returns a
        :class:`JointTicket`.

        ``request`` is a :class:`~repro_torch.core.jointplan.JointRequest` or
        a bare ``Program`` (then ``memories``/``budget``/``opts``/
        ``scorer`` apply).  Each memory's solve fans out through the
        normal executors exactly like a ``submit`` -- same sharding,
        fabric, stale-while-revalidate, and verification -- but all
        members submit as **one tenant unit** (same tenant, admission
        quotas serialize them honestly; a shed member degrades to its
        trivial scheme instead of failing the group) and the ticket
        co-selects one scheme per memory under the shared ``budget``
        instead of taking each argmin.  A warm ``joint/`` store entry
        answers before any member submits (ticket born ``done``).
        """
        if isinstance(request, JointRequest):
            req = request
        else:
            req = JointRequest(program=request, memories=memories,
                               budget=budget, opts=opts, scorer=scorer,
                               use_cache=use_cache,
                               frontier_cap=frontier_cap)
        names = req.memory_names()
        if not names:
            raise ValueError("joint request names no memories")
        verify = verify if verify is not None else self.verify
        if verify not in VERIFY_MODES:
            raise ValueError(
                f"unknown verify mode {verify!r}; one of {VERIFY_MODES}")
        ten = self.tenants.resolve(tenant)
        tr = self.tracer
        trace_id = new_trace_id() if tr is not None else None
        # member prep is the same cheap inline half as submit(): bad
        # memories and unknown scorers raise here, on the caller
        t_prep = time.perf_counter()
        preps = {name: self.planner.prepare(req.program, name,
                                            opts=req.opts, scorer=req.scorer,
                                            use_cache=req.use_cache)
                 for name in names}
        scorer_name = next(iter(preps.values())).scorer_name
        signature = joint_signature(
            {n: p.signature for n, p in preps.items()}, scorer_name,
            req.budget)
        if tr is not None:
            tr.label(trace_id, f"joint {len(names)} memories")
            tr.record(trace_id, "joint-prepare", t_prep,
                      time.perf_counter(), members=len(names))
        self.stats.bump("joint_submits", tenant=ten.name)
        ticket = JointTicket(service=self, request=req, preps=preps,
                             signature=signature, scorer_name=scorer_name,
                             verify=verify, tenant=ten.name)
        ticket.trace_id = trace_id
        if req.use_cache and self.planner.store is not None:
            cached = self.planner.store.get_joint(signature)
            if cached is not None:
                self.stats.bump("joint_sync_hits", tenant=ten.name)
                ticket._resolve_cached(cached)
                if tr is not None:
                    tr.finish(trace_id, status="sync-hit")
                return ticket
        # fan out the member solves -- one tenant unit; registration
        # completes before arming so a flurry of sync hits cannot
        # finalize a half-registered graph
        for name, prep in preps.items():
            member = self.submit_prepared(
                prep, priority=priority, shard_budget=shard_budget,
                executor=executor, verify=verify, tenant=tenant)
            ticket._register(name, member)
        ticket._arm()
        return ticket

    # -- immediate artifacts -------------------------------------------------------
    def trivial_artifact(self, mem: MemorySpec, *,
                         backend: str = "torch") -> CompiledBankingPlan:
        """Process-cached trivial single-bank artifact for ``mem``."""
        key = (tuple(mem.dims), mem.word_bits, backend)
        with self._lock:
            art = self._trivial.get(key)
        if art is not None:
            return art
        art = compile_trivial(mem, backend=backend)
        with self._lock:
            self._trivial[key] = art
        return art

    # -- static verification (repro_torch.analysis) ------------------------------------
    def _lint_gate(self, prep: PreparedRequest,
                   tenant: str = DEFAULT_TENANT) -> None:
        """Refuse submits whose Program fails the lint pass (raises
        :class:`repro_torch.analysis.LintError` on error-severity findings)."""
        from ..analysis.lint import LintError, lint_program
        report = lint_program(prep.request.program, prep.memory)
        if not report.ok:
            with self._lock:
                self.stats.bump("lint_errors", tenant=tenant)
            raise LintError(report)

    def _make_verifier(self, mode: str, tenant: str = DEFAULT_TENANT,
                       trace_id: Optional[str] = None):
        """The certify-before-cache callback handed to
        ``BankingPlanner.complete_solve`` (``None`` when verification is
        off).  Failed certification bumps ``cert_failures`` and raises
        :class:`repro_torch.analysis.CertificationError` -- the plan is never
        cached or persisted, and the ticket surfaces the counterexample
        through ``result()``.  Success bumps ``certified`` and persists
        the certificate beside the plan when the store keeps them."""
        if mode == "off":
            return None

        def verify(plan: BankingPlan, prep: PreparedRequest) -> None:
            from ..analysis.certify import CertificationError, certify_plan
            tr = self.tracer
            t_cert = time.perf_counter()
            res = certify_plan(plan, prep.iterators,
                               scorer=prep.scorer_name)
            if tr is not None and trace_id is not None:
                tr.record(trace_id, "certify", t_cert,
                          time.perf_counter(), ok=res.ok)
            if not res.ok:
                with self._lock:
                    self.stats.bump("cert_failures", tenant=tenant)
                if tr is not None:
                    tr.note_anomaly("cert-rejection",
                                    detail=plan.signature[:16])
                why = (res.counterexample.describe()
                       if res.counterexample is not None else res.reason)
                raise CertificationError(
                    f"solver output failed independent certification: "
                    f"{why}", res.counterexample)
            with self._lock:
                self.stats.bump("certified", tenant=tenant)
            if res.certificate is not None \
                    and self.planner.store is not None:
                self.planner.store.put_certificate(
                    plan.signature, plan.scorer_name,
                    res.certificate.to_json())

        return verify

    # -- worker pool ----------------------------------------------------------------
    def _enqueue(self, item) -> None:
        """All work lands through here so ``_outstanding`` counts queued
        AND claimed-but-unfinished items -- a worker that already popped
        a long (or gated) solve must not hide demand, or one slow joint
        member would serialize the rest of its graph."""
        with self._demand:
            self._outstanding += 1
        self._queue.put(item)

    def _ensure_workers(self) -> None:
        with self._lock:
            if self._shutdown:
                raise RuntimeError("PlanService is shut down")
            want = min(self._max_workers, max(1, self._outstanding))
            while len(self._threads) < want:
                t = threading.Thread(
                    target=self._worker, daemon=True,
                    name=f"plan-service-{len(self._threads)}")
                self._threads.append(t)
                t.start()

    def _worker(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item[2] is _SENTINEL:
                    return
                _, _, payload, ticket = item
                if isinstance(payload, _ShardJob):
                    self._run_shard(payload, ticket)
                    continue
                if not ticket._claim():
                    continue   # duplicate entry (priority upgrade) or done
                queued_at = ticket._queued_at
                if queued_at is not None:
                    now = time.perf_counter()
                    ticket.queue_ms += (now - queued_at) * 1e3
                    ticket._queued_at = None
                    tr = self.tracer
                    if tr is not None and ticket.trace_id is not None:
                        tr.record(ticket.trace_id, "queue-wait",
                                  queued_at, now, tenant=ticket.tenant)
                try:
                    plan = (self.planner.lookup(payload)
                            if payload.request.use_cache else None)
                    if plan is None:
                        # cold: fan the candidate space across the pool;
                        # the last shard's worker resolves the ticket
                        self._launch_shards(payload, ticket)
                        continue
                except BaseException as e:  # surface through result()
                    self._finish(ticket, payload, error=e)
                else:
                    self._finish(ticket, payload, plan=plan)
            finally:
                if item[2] is not _SENTINEL:
                    with self._demand:
                        self._outstanding -= 1
                self._queue.task_done()

    def _launch_shards(self, prep: PreparedRequest,
                       ticket: PlanTicket) -> None:
        """Enumerate the candidate space and run the solve on the chosen
        executor: enqueue one pool job per shard at the ticket's
        priority, or drive the remote fabric from this worker thread.
        Runs on the claiming worker so scorer resolution (lazy "ml"
        training) stays off the submitter's thread, exactly like the
        old monolithic solve."""
        self.planner.stats.misses += 1
        tr = self.tracer
        tid = ticket.trace_id if tr is not None else None
        t_enum = time.perf_counter()
        space = self.planner.build_space(prep)
        if tid is not None:
            tr.record(tid, "enumerate", t_enum, time.perf_counter(),
                      candidates=len(space))
        _, scorer_fn = resolve_scorer(prep.scorer_spec)
        if self.telemetry is not None:
            # a "measured" scorer ranks on THIS service's observation log
            scorer_fn = self.telemetry.adapt_scorer(prep.scorer_name,
                                                    scorer_fn)
        reducer = SolutionReducer(space, scorer=scorer_fn)
        ticket._reducer = reducer
        executor = (ticket.executor if ticket.executor is not None
                    else self.executor)
        if executor == "fabric":
            fabric = self._fabric
            if fabric is not None and fabric.workers_alive > 0:
                self._run_fabric_solve(prep, ticket, space, reducer,
                                       scorer_fn, fabric)
                return
            with self._lock:     # no fabric / no workers: the pool runs
                self.stats.bump("fabric_fallbacks", tenant=ticket.tenant)
        if ticket.shard_budget is not None:
            budget = ticket.shard_budget
        elif self.shard_budget is not None:
            budget = self.shard_budget
        else:                    # adaptive: sized from the enumeration
            budget = space.suggested_shards(self._max_workers)
            with self._lock:
                self.stats.bump("adaptive_budgets", tenant=ticket.tenant)
        qos_cap = self.tenants.resolve(ticket.tenant).qos.shard_budget
        if qos_cap is not None:
            # a low-QoS tenant's solve may not fan across the whole pool
            budget = min(budget, qos_cap)
        shards = space.shards(max(1, budget))
        state = _SolveState(prep=prep, ticket=ticket, reducer=reducer,
                            scorer_fn=scorer_fn,
                            started=time.perf_counter(),
                            remaining=len(shards))
        if not shards:   # empty candidate space: resolve immediately
            self._finish(ticket, prep, plan=self.planner.complete_solve(
                prep, [], 0.0, scorer_fn,
                verify=self._make_verifier(ticket.verify, ticket.tenant,
                                           trace_id=tid)))
            return
        with self._lock:
            self.stats.bump("shards_spawned", len(shards),
                            tenant=ticket.tenant)
        for shard in shards:
            self._enqueue((ticket.priority, next(self._seq),
                           _ShardJob(state=state, shard=shard), ticket))
        self._ensure_workers()

    def _run_fabric_solve(self, prep: PreparedRequest, ticket: PlanTicket,
                          space, reducer: SolutionReducer, scorer_fn,
                          fabric) -> None:
        """Drive one cold solve over the remote fabric, blocking this
        worker thread until the merged search drains.  Best-so-far
        promotions, server hot-swaps, and the final plan are identical
        to the pool path -- the same reducer merges either way."""
        started = time.perf_counter()
        with self._lock:
            self.stats.bump("fabric_solves", tenant=ticket.tenant)
        verifier = None
        if ticket.verify == "all":
            # certify every solution batch the untrusted workers stream
            # back; bad batches are rejected + requeued by the fabric
            from ..analysis.certify import make_batch_verifier
            verifier = make_batch_verifier(space)
        lease_cap = self.tenants.resolve(ticket.tenant).qos.fabric_lease_cap
        tr = self.tracer
        tid = ticket.trace_id if tr is not None else None
        try:
            t_fab = time.perf_counter()
            report = fabric.solve(space, reducer=reducer,
                                  verifier=verifier, lease_cap=lease_cap,
                                  trace=((tr, tid) if tid is not None
                                         else None))
            t_red = time.perf_counter()
            if tid is not None:
                tr.record(tid, "fabric-solve", t_fab, t_red,
                          leases=report.leases,
                          requeues=report.requeues,
                          workers_lost=report.workers_lost)
            plan = self.planner.complete_solve(
                prep, reducer.finalize(),
                time.perf_counter() - started, scorer_fn,
                verify=self._make_verifier(ticket.verify, ticket.tenant,
                                           trace_id=tid))
            if tid is not None:
                tr.record(tid, "reduce", t_red, time.perf_counter(),
                          promotions=reducer.promotions,
                          dedup_hits=reducer.dedup_hits)
            with self._lock:
                t = ticket.tenant
                self.stats.bump("fabric_leases", report.leases, tenant=t)
                self.stats.bump("fabric_requeues", report.requeues,
                                tenant=t)
                self.stats.bump("fabric_cut_broadcasts",
                                report.cut_broadcasts, tenant=t)
                self.stats.bump("fabric_workers_lost",
                                report.workers_lost, tenant=t)
                self.stats.bump("fabric_heartbeats",
                                getattr(report, "heartbeats", 0), tenant=t)
                self.stats.bump("cert_rejected", report.cert_rejected,
                                tenant=t)
                self.stats.bump("best_promotions", reducer.promotions,
                                tenant=t)
                self.stats.bump("dedup_hits", reducer.dedup_hits, tenant=t)
        except BaseException as e:
            self._finish(ticket, prep, error=e)
        else:
            self._finish(ticket, prep, plan=plan)

    def _run_shard(self, job: _ShardJob, ticket: PlanTicket) -> None:
        state = job.state
        tr = self.tracer
        tid = ticket.trace_id if tr is not None else None
        t_eval = time.perf_counter()
        try:
            for ev in evaluate(job.shard, gate=state.reducer):
                state.reducer.add(ev)
        except BaseException as e:
            if state.fail(e):
                self._finish(ticket, state.prep, error=e)
            return
        finally:
            if tid is not None:
                tr.record(tid, "shard-eval", t_eval, time.perf_counter(),
                          units=len(job.shard))
            with self._lock:
                self.stats.bump("shards_completed", tenant=ticket.tenant)
        if state.shard_finished():
            try:
                red = state.reducer
                t_red = time.perf_counter()
                plan = self.planner.complete_solve(
                    state.prep, red.finalize(),
                    time.perf_counter() - state.started, state.scorer_fn,
                    verify=self._make_verifier(state.ticket.verify,
                                               state.ticket.tenant,
                                               trace_id=tid))
                if tid is not None:
                    tr.record(tid, "reduce", t_red, time.perf_counter(),
                              promotions=red.promotions,
                              dedup_hits=red.dedup_hits)
                with self._lock:
                    self.stats.bump("best_promotions", red.promotions,
                                    tenant=ticket.tenant)
                    self.stats.bump("dedup_hits", red.dedup_hits,
                                    tenant=ticket.tenant)
            except BaseException as e:
                self._finish(ticket, state.prep, error=e)
            else:
                self._finish(ticket, state.prep, plan=plan)

    def _finish(self, ticket: PlanTicket, prep: PreparedRequest, *,
                plan: Optional[BankingPlan] = None,
                error: Optional[BaseException] = None) -> None:
        tr = self.tracer
        if tr is not None and ticket.trace_id is not None:
            if ticket._root_span is not None:
                tr.end(ticket._root_span,
                       status="error" if error is not None else "done")
                ticket._root_span = None
            tr.finish(ticket.trace_id,
                      status="error" if error is not None else "ok",
                      anomaly="error" if error is not None else None)
        if error is not None:
            with self._lock:
                self.stats.bump("errors", tenant=ticket.tenant)
            ticket._fail(error)
            # the reducer stays attached: a failed search's partial best
            # remains servable through best_so_far()
        else:
            with self._lock:
                self.stats.bump("solved", tenant=ticket.tenant)
            ticket._resolve(plan)   # done flips first: best_so_far now
            ticket._release_reducer()  # reads the plan, so drop the search
            if self.telemetry is not None:
                self.telemetry.register(prep, plan)
        with self._lock:
            key = (prep.signature, prep.scorer_name)
            if self._inflight.get(key) is ticket:
                del self._inflight[key]
        if ticket._admitted:
            self._release_admission(ticket.tenant)

    def _release_admission(self, tenant: str) -> None:
        """Free the finished solve's in-flight slot and queue whatever
        the tenant's deferral backlog can now admit (oldest first, at
        each deferred ticket's kept priority)."""
        tr = self.tracer
        for prep2, t2 in self._admission.release(tenant):
            t2.deferred = False
            t2._admitted = True
            if t2.status == "deferred":
                t2.status = "queued"
            deferred_at = t2._deferred_at
            now = time.perf_counter()
            if deferred_at is not None:
                t2.deferred_ms += (now - deferred_at) * 1e3
                t2._deferred_at = None
                if tr is not None and t2.trace_id is not None:
                    tr.record(t2.trace_id, "deferred-wait", deferred_at,
                              now, tenant=t2.tenant)
            t2._queued_at = now
            self.stats.bump("queued", tenant=t2.tenant)
            self._enqueue((t2.priority, next(self._seq), prep2, t2))
            try:
                self._ensure_workers()
            except RuntimeError:
                # shut down mid-release: the entry stays queued; the
                # drained workers' sentinels already passed it by, and
                # callers of a shut-down service hold their own tickets
                pass

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every queued problem has been solved -- deferred
        admissions included -- (or fail the wait after ``timeout``
        seconds).  Returns True when drained."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while self._queue.unfinished_tasks or self._admission.pending():
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.002)
        return True

    def shutdown(self, wait: bool = True) -> None:
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            threads = list(self._threads)
        for _ in threads:
            self._queue.put((float("inf"), next(self._seq), _SENTINEL,
                             _SENTINEL))
        if wait:
            for t in threads:
                t.join(timeout=5.0)

    def __enter__(self) -> "PlanService":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


# ---------------------------------------------------------------------------
# Process-wide default service (serving hot path, sharding bridge)
# ---------------------------------------------------------------------------

_DEFAULT_SERVICE: Optional[PlanService] = None
_DEFAULT_LOCK = threading.Lock()


def default_service() -> PlanService:
    """The shared service over :func:`default_planner` -- what the serving
    runtime and the sharding bridge submit through."""
    global _DEFAULT_SERVICE
    with _DEFAULT_LOCK:
        if _DEFAULT_SERVICE is None:
            _DEFAULT_SERVICE = default_planner().service
        return _DEFAULT_SERVICE


__all__ = [
    "JointTicket",
    "PlanService",
    "PlanTicket",
    "ServiceStats",
    "StaleWhileRevalidate",
    "default_service",
]
