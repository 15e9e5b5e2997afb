"""Shardable candidate-space solver pipeline (paper Sec 3.3-3.5).

The paper's headline win is searching a large (N, B, alpha, P) candidate
space quickly; the monolithic ``solve`` did enumeration, validity
checking, and scheme evaluation in one nested loop, so one cold solve
was one unsplittable unit of work.  This module separates the three:

* :class:`CandidateSpace` **enumerates** pruned candidate descriptors --
  flat (alpha, B, N) tuples, multidimensional Ns-combos, and per-factor
  bank-by-duplication sub-searches -- *without* evaluating any of them.
  Enumeration is cheap (loop headers only) and deterministic; every
  candidate gets a global enumeration index.
* ``space.shards(k)`` **partitions** enumeration into ``k``
  self-contained :class:`SolveShard` s.  A shard carries its candidate
  slice plus the shared conflict-analysis inputs; shards of one space
  share one :class:`~repro_torch.core.geometry.ConflictCache` in-process and
  pickle cleanly for cross-process evaluation (the cache is rebuilt on
  the other side).
* :func:`evaluate` turns a shard into a **SolutionStream**: a generator
  of :class:`EvaluatedCandidate` s, yielding scored
  :class:`~repro_torch.core.solver.BankingSolution` s incrementally instead of
  returning only at the end.
* :class:`SolutionReducer` **merges** streams from any number of shards:
  it keeps a ranked best-so-far (monotone in score -- what
  ``PlanTicket.best_so_far`` serves), dedupes identical schemes, and its
  ``finalize()`` reproduces the monolithic search's truncation budgets
  *exactly*, so the merged result for any shard count equals the
  pre-redesign ``solve`` output (the shard-equivalence property).

Truncation equivalence: the monolithic loops stopped early -- flat and
multidim searches after ``max_solutions`` emitted schemes, duplication
sub-searches after their own sub-budget.  Each contiguous run of
candidates sharing one such budget is a :class:`Section`; the reducer
walks every section in enumeration order, admitting a candidate's batch
iff the emitted count *before* it is below the section cap -- precisely
the monolithic rule.  Shards stop a section early once their own
emissions alone prove the global cap is reached (their later candidates
are provably beyond the cut), and an in-process reducer additionally
publishes the exact cut so concurrent shards skip dead work.
"""

from __future__ import annotations

import itertools
import math
import pickle
import threading
import time
import zlib
from dataclasses import dataclass, field
from functools import reduce
from typing import Callable, Dict, Iterator as TIterator, List, Optional, \
    Sequence, Tuple

import numpy as np

from .geometry import (
    ConflictCache,
    FlatGeometry,
    MultiDimGeometry,
    _max_conflict_clique,
    flat_conflict_edges,
    multidim_conflict_edges,
    propose_P,
)
from .polytope import AccessGroup, Iterator, MemorySpec


@dataclass(frozen=True)
class Candidate:
    """One un-evaluated point of the search space.

    ``index`` is the global enumeration order (the monolithic loop
    order); ``section`` names the truncation budget it falls under.
    Flat and duplication candidates carry (alpha, B, N); multidim
    candidates carry the per-dimension Ns (both blocking variants of one
    Ns-combo evaluate together, mirroring the monolithic inner loop).
    """

    index: int
    section: int
    kind: str                       # "flat" | "multidim"
    alpha: Optional[Tuple[int, ...]] = None
    B: int = 1
    N: int = 0
    Ns: Optional[Tuple[int, ...]] = None


@dataclass(frozen=True)
class Section:
    """A contiguous candidate run sharing one truncation budget.

    ``cap`` bounds emitted solutions (the monolithic early exit);
    ``keep`` additionally bounds *validated* solutions (duplication:
    the sub-search emits up to ``cap`` but only the first ``keep``
    fully-duplicate-valid schemes survive); ``D`` > 1 marks a
    bank-by-duplication section evaluated against its own group split.
    """

    name: str
    start: int
    stop: int
    cap: int
    keep: Optional[int] = None
    D: int = 1


@dataclass
class EvaluatedCandidate:
    """One candidate's evaluation: the attached solutions (in proposal
    order) and, for duplication candidates, whether the geometry is
    conflict-free for every duplicate's subset.  Invalid candidates
    yield an empty batch -- the reducer needs them to advance its
    in-order walk."""

    index: int
    solutions: List = field(default_factory=list)
    valid_mask: Tuple[bool, ...] = ()


class CandidateSpace:
    """Enumerated, pruned candidate descriptors for one banking problem.

    Construction runs only the paper's *pruning* (Sec 3.3): alpha
    normalization, (alpha, B) co-primality, N-ordering heuristics, the
    multidim combo budget, and the duplication applicability gates.  No
    conflict analysis, no resolution lowering -- candidates are tuples.
    """

    def __init__(self, mem: MemorySpec, groups: List[AccessGroup],
                 iters: Dict[str, Iterator], opts=None):
        from .solver import SolverOptions

        self.mem = mem
        self.groups = groups
        self.iters = iters
        self.opts = opts or SolverOptions()
        self.candidates: List[Candidate] = []
        self.sections: List[Section] = []
        # per-section evaluation context: (groups, opts, note, dup subsets)
        self._section_groups: List[List[AccessGroup]] = []
        self._section_opts: List = []
        self._section_subsets: List[Optional[List[AccessGroup]]] = []
        self._cache: Optional[ConflictCache] = None
        self._enumerate()

    # -- shared conflict analysis ------------------------------------------------
    @property
    def cache(self) -> ConflictCache:
        """The conflict cache every in-process shard of this space shares
        (lazily rebuilt after pickling -- caches don't cross processes)."""
        if self._cache is None:
            self._cache = ConflictCache(self.iters)
        return self._cache

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_cache"] = None
        return state

    def __len__(self) -> int:
        return len(self.candidates)

    # -- enumeration -------------------------------------------------------------
    def _add_section(self, name: str, groups, opts, cap: int,
                     keep: Optional[int] = None, D: int = 1,
                     subsets=None) -> int:
        sid = len(self.sections)
        self.sections.append(Section(name=name, start=len(self.candidates),
                                     stop=len(self.candidates), cap=cap,
                                     keep=keep, D=D))
        self._section_groups.append(groups)
        self._section_opts.append(opts)
        self._section_subsets.append(subsets)
        return sid

    def _close_section(self, sid: int) -> None:
        sec = self.sections[sid]
        self.sections[sid] = Section(name=sec.name, start=sec.start,
                                     stop=len(self.candidates), cap=sec.cap,
                                     keep=sec.keep, D=sec.D)

    def _enumerate(self) -> None:
        from .solver import SolverOptions, alpha_candidates, n_candidates

        mem, groups, opts = self.mem, self.groups, self.opts

        def flat_tuples(for_groups, for_opts):
            sizes = [len(g) for g in for_groups]
            for alpha in alpha_candidates(mem, for_groups, for_opts):
                a_gcd = reduce(math.gcd, [abs(x) for x in alpha if x], 0)
                for B in for_opts.b_candidates:
                    if B > 1 and math.gcd(a_gcd, B) != 1:
                        continue  # co-primality pruning (paper Sec 3.3)
                    for N in n_candidates(sizes, mem.ports, for_opts):
                        yield tuple(alpha), B, N

        # flat hyperplane section (always present)
        sid = self._add_section("flat", groups, opts, cap=opts.max_solutions)
        for alpha, B, N in flat_tuples(groups, opts):
            self.candidates.append(Candidate(
                index=len(self.candidates), section=sid, kind="flat",
                alpha=alpha, B=B, N=N))
        self._close_section(sid)

        # multidimensional (orthogonal-lattice) section
        if opts.allow_multidim and mem.n >= 2:
            sid = self._add_section("multidim", groups, opts,
                                    cap=opts.max_solutions)
            for Ns in self._multidim_combos():
                self.candidates.append(Candidate(
                    index=len(self.candidates), section=sid,
                    kind="multidim", Ns=Ns))
            self._close_section(sid)

        # bank-by-duplication sections: one flat sub-search per factor D
        if opts.allow_duplication and groups:
            read_groups = [g for g in groups
                           if not any(a.is_write for a in g)]
            big = max(read_groups, key=len) if read_groups else None
            if big is not None and len(big) >= 4:
                others = [g for g in groups if g is not big]
                for D in opts.duplication_factors:
                    if len(big) < 2 * D:
                        continue
                    subsets = [AccessGroup(list(big)[i::D])
                               for i in range(D)]
                    worst_subset = max(subsets, key=len)
                    sub_groups = others + [worst_subset]
                    sub_opts = SolverOptions(
                        max_solutions=8, n_budget=24,
                        transform_level=opts.transform_level,
                        allow_multidim=False, allow_duplication=False,
                    )
                    sid = self._add_section(
                        f"dup x{D}", sub_groups, sub_opts,
                        cap=sub_opts.max_solutions, keep=2, D=D,
                        subsets=subsets)
                    for alpha, B, N in flat_tuples(sub_groups, sub_opts):
                        self.candidates.append(Candidate(
                            index=len(self.candidates), section=sid,
                            kind="flat", alpha=alpha, B=B, N=N))
                    self._close_section(sid)

    def _multidim_combos(self) -> List[Tuple[int, ...]]:
        """Ns combos in monolithic order, under the combo budget; the
        static product-range filter runs here (it needs no evaluation),
        and *skipped combos still count against the budget* -- exactly
        the monolithic accounting."""
        from .solver import _dim_value_counts

        mem, groups, opts = self.mem, self.groups, self.opts
        ell = max((len(g) for g in groups), default=1)
        cap = max(4 * ell, 8)
        per_dim: List[List[int]] = []
        for d in range(mem.n):
            k = _dim_value_counts(groups, d)
            cands = {1, k}
            cands.add(1 << max(0, (k - 1)).bit_length())
            if k + 1 <= mem.dims[d]:
                cands.add(k + 1)
            per_dim.append(sorted(c for c in cands
                                  if 1 <= c <= max(mem.dims[d], 1)))
        out: List[Tuple[int, ...]] = []
        combos = 0
        for Ns in itertools.product(*per_dim):
            combos += 1
            if combos > opts.multidim_combo_budget:
                break
            prod = int(np.prod(Ns))
            if prod > cap or prod < 2:
                continue
            out.append(tuple(Ns))
        return out

    # -- partitioning ------------------------------------------------------------
    def shards(self, k: int, *, interleave: bool = True) -> List["SolveShard"]:
        """Split enumeration into ``k`` self-contained shards.

        ``interleave=True`` (default) deals candidates round-robin so
        every shard sees early -- typically denser -- regions of the
        space: the right shape for a fixed worker pool.
        ``interleave=False`` cuts contiguous index ranges: the right
        shape for many small work units fed to a pool with early
        termination (see :func:`evaluate_parallel`).
        Every candidate lands in exactly one shard.
        """
        k = max(1, min(int(k), max(1, len(self.candidates))))
        if interleave:
            slices = [self.candidates[i::k] for i in range(k)]
        else:
            n = len(self.candidates)
            bounds = [round(i * n / k) for i in range(k + 1)]
            slices = [self.candidates[bounds[i]:bounds[i + 1]]
                      for i in range(k)]
        return [SolveShard(space=self, candidates=s, shard_index=i,
                           num_shards=k)
                for i, s in enumerate(slices) if s]

    # -- adaptive fan-out --------------------------------------------------------
    def estimated_evaluations(self) -> int:
        """Expected evaluation work, from enumeration counts alone.

        Each section's walk stops once ``cap`` solutions are emitted, and
        a valid flat candidate emits up to two P-proposals -- so a
        section costs at most its full length, and rarely much more than
        a few times its cap.  The estimate is
        ``sum(min(len(section), 4 * cap))``: cheap (no evaluation), and
        the quantity the per-ticket fan-out should be sized from.
        """
        return sum(min(s.stop - s.start, 4 * max(s.cap, 1))
                   for s in self.sections)

    def suggested_shards(self, max_shards: int, *,
                         min_per_shard: int = 48) -> int:
        """Adaptive fan-out: how many shards this space is worth.

        Sized from :meth:`estimated_evaluations` so a shard amortizes its
        dispatch overhead over at least ``min_per_shard`` candidate
        evaluations; small spaces return 1 and skip fan-out entirely.
        """
        est = self.estimated_evaluations()
        return max(1, min(int(max_shards), est // max(1, min_per_shard)))


@dataclass
class SolveShard:
    """A self-contained slice of one candidate space.

    Carries its candidates plus (via ``space``) the shared problem
    inputs -- memory, groups, iterators, options -- so it can be
    evaluated on any worker, in or out of process.  In-process shards
    share the space's :class:`ConflictCache`; a pickled shard rebuilds
    its own on first use.
    """

    space: CandidateSpace
    candidates: List[Candidate]
    shard_index: int = 0
    num_shards: int = 1

    def __len__(self) -> int:
        return len(self.candidates)


# ---------------------------------------------------------------------------
# Evaluation: shard -> SolutionStream
# ---------------------------------------------------------------------------


def _eval_flat(space: CandidateSpace, cand: Candidate,
               cache: ConflictCache) -> EvaluatedCandidate:
    from .solver import _attach_flat

    sec = space.sections[cand.section]
    groups = space._section_groups[cand.section]
    opts = space._section_opts[cand.section]
    mem, iters = space.mem, space.iters
    geo = FlatGeometry(N=cand.N, B=cand.B, alpha=cand.alpha,
                       P=(1,) * mem.n)
    worst = 1
    for g in groups:
        edges = flat_conflict_edges(list(g), geo, cache)
        clique = _max_conflict_clique(len(g), edges)
        worst = max(worst, clique)
        if clique > mem.ports:
            return EvaluatedCandidate(index=cand.index)
    note = f"dup x{sec.D}" if sec.D > 1 else ""
    sols = []
    for P in propose_P(mem, cand.N, cand.B, cand.alpha)[:2]:
        geoP = FlatGeometry(N=cand.N, B=cand.B, alpha=cand.alpha, P=P)
        sols.append(_attach_flat(groups, mem, geoP, P, iters, worst, opts,
                                 duplicates=sec.D, note=note))
    if sec.D <= 1:
        return EvaluatedCandidate(index=cand.index, solutions=sols,
                                  valid_mask=(True,) * len(sols))
    # bank-by-duplication: the SAME geometry must be conflict-free for
    # EVERY duplicate's subset (writes broadcast to all duplicates).  The
    # non-duplicated groups were verified once above -- only the subsets
    # need checking, and validity depends on (N, B, alpha) alone, so one
    # verdict covers every P proposal.
    dup_ok = True
    for sub in space._section_subsets[cand.section]:
        edges = flat_conflict_edges(list(sub), geo, cache)
        if _max_conflict_clique(len(sub), edges) > mem.ports:
            dup_ok = False
            break
    return EvaluatedCandidate(index=cand.index, solutions=sols,
                              valid_mask=(dup_ok,) * len(sols))


def _eval_multidim(space: CandidateSpace, cand: Candidate,
                   cache: ConflictCache) -> EvaluatedCandidate:
    from .solver import _attach_multidim

    mem, groups, iters, opts = (space.mem, space.groups, space.iters,
                                space.opts)
    sols = []
    for Bs in ((1,) * mem.n, (2,) + (1,) * (mem.n - 1)):
        geo = MultiDimGeometry(Ns=cand.Ns, Bs=Bs, alphas=(1,) * mem.n)
        worst = 1
        ok = True
        for g in groups:
            edges = multidim_conflict_edges(list(g), geo, cache)
            clique = _max_conflict_clique(len(g), edges)
            worst = max(worst, clique)
            if clique > mem.ports:
                ok = False
                break
        if ok:
            sols.append(_attach_multidim(groups, mem, geo, iters, worst,
                                         opts))
    return EvaluatedCandidate(index=cand.index, solutions=sols,
                              valid_mask=(True,) * len(sols))


def evaluate(shard: SolveShard,
             gate: Optional["SolutionReducer"] = None
             ) -> TIterator[EvaluatedCandidate]:
    """Evaluate one shard, yielding an :class:`EvaluatedCandidate` per
    candidate in ascending index order -- a *SolutionStream*.

    Two early exits keep sharded work close to the monolithic search's:

    * **local stop**: once this shard alone has emitted a section's full
      ``cap``, the global emission count at that index is >= cap too, so
      all later candidates of the section are provably beyond the final
      cut -- skip them (no yield; the reducer never needs them).
    * **gate stop**: an in-process :class:`SolutionReducer` passed as
      ``gate`` publishes each section's exact cut as its in-order walk
      reaches the cap; candidates past a published cut are skipped.
    """
    space = shard.space
    cache = space.cache
    emitted: Dict[int, int] = {}
    for cand in shard.candidates:
        if gate is not None and gate.cancelled:
            return
        sec = space.sections[cand.section]
        if emitted.get(cand.section, 0) >= sec.cap:
            continue                       # local stop: beyond the cut
        if gate is not None:
            cut = gate.stop_index(cand.section)
            if cut is not None and cand.index > cut:
                continue                   # gate stop: exact cut known
        if cand.kind == "flat":
            ev = _eval_flat(space, cand, cache)
        else:
            ev = _eval_multidim(space, cand, cache)
        if ev.solutions:
            emitted[cand.section] = (emitted.get(cand.section, 0)
                                     + len(ev.solutions))
        yield ev


# ---------------------------------------------------------------------------
# Reduction: merge SolutionStreams, rank best-so-far, finalize
# ---------------------------------------------------------------------------


class _SectionState:
    __slots__ = ("idx", "sec", "next", "count", "kept", "cut", "done")

    def __init__(self, idx: int, sec: Section):
        self.idx = idx
        self.sec = sec
        self.next = sec.start
        self.count = 0
        self.kept = 0
        self.cut: Optional[int] = None
        self.done = sec.start >= sec.stop


class SolutionReducer:
    """Merges evaluation streams from any number of shards.

    Thread-safe ``add()`` accepts :class:`EvaluatedCandidate` s in any
    order; an in-order walk per section admits solutions under the
    monolithic truncation rule (batch admitted iff the section's emitted
    count *before* it is below the cap), dedupes identical schemes,
    scores each admitted solution, and keeps a monotone best-so-far.
    ``finalize()`` returns the admitted list -- for any shard count,
    byte-for-byte the monolithic ``solve`` output order (minus exact
    duplicates, which a stable rank would never prefer anyway).

    The reducer doubles as the evaluation *gate*: once a section's walk
    reaches its cap the exact cut index is published, letting concurrent
    shards skip provably-dead candidates.
    """

    def __init__(self, space: CandidateSpace,
                 scorer: Optional[Callable] = None):
        self.space = space
        self.scorer = scorer
        self._lock = threading.Lock()
        self._results: Dict[int, EvaluatedCandidate] = {}
        self._sections = [_SectionState(i, s)
                          for i, s in enumerate(space.sections)]
        # per-section admitted lists: arrival order may interleave
        # sections, but the final order must be the monolithic one
        # (sections concatenated, index order within each)
        self._admitted: List[List] = [[] for _ in space.sections]
        self._seen: Dict[Tuple, bool] = {}
        self._best = None
        self._best_score = float("inf")
        self._version = 0
        self.promotions = 0
        self.dedup_hits = 0
        self.evaluated = 0
        self._created = time.perf_counter()
        self.first_best_seconds: Optional[float] = None
        self._cancelled = False

    # -- gate protocol (read by evaluate()) --------------------------------------
    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def cancel(self) -> None:
        self._cancelled = True

    def stop_index(self, section: int) -> Optional[int]:
        return self._sections[section].cut

    def cuts(self) -> Dict[int, int]:
        """Snapshot of every published section cut (section index ->
        exact cut index).  A cut is published at most once and never
        moves, so snapshots are monotone -- what the distributed fabric
        broadcasts to in-flight remote workers."""
        with self._lock:
            return {s.idx: s.cut for s in self._sections
                    if s.cut is not None}

    # -- stream intake -----------------------------------------------------------
    def add(self, ev: EvaluatedCandidate) -> None:
        with self._lock:
            self.evaluated += 1
            self._results[ev.index] = ev
            self._advance()

    def _advance(self) -> None:
        for s in self._sections:
            while not s.done:
                ev = self._results.pop(s.next, None)
                if ev is None:
                    break
                if ev.solutions:           # admit: count-before < cap here
                    s.count += len(ev.solutions)
                    for sol, ok in zip(ev.solutions, ev.valid_mask):
                        if not ok:
                            continue
                        if s.sec.keep is not None:
                            if s.kept >= s.sec.keep:
                                continue
                            s.kept += 1
                        self._admit(sol, s)
                    if s.count >= s.sec.cap:
                        s.cut = s.next     # publish the exact cut
                        s.done = True
                s.next += 1
                if s.next >= s.sec.stop:
                    s.done = True

    def _admit(self, sol, s: _SectionState) -> None:
        key = (sol.kind, sol.geometry, sol.duplicates)
        if key in self._seen:
            self.dedup_hits += 1
            return
        self._seen[key] = True
        if self.scorer is not None:
            sol.score = float(self.scorer(sol))
        elif sol.resources is not None:
            sol.score = sol.resources.total.weighted()
        self._admitted[s.idx].append(sol)
        if sol.score < self._best_score:
            self._best = sol
            self._best_score = sol.score
            self._version += 1
            self.promotions += 1
            if self.first_best_seconds is None:
                self.first_best_seconds = (time.perf_counter()
                                           - self._created)

    # -- progressive results -----------------------------------------------------
    def best(self):
        """Best-scored admitted solution so far (never regresses)."""
        return self._best

    def best_with_version(self):
        with self._lock:
            return self._best, self._version

    @property
    def version(self) -> int:
        """Bumps every time best() improves -- consumers poll it to
        promote without re-comparing schemes."""
        return self._version

    def complete(self) -> bool:
        """True once every section's walk is done (cap cut or
        exhausted) -- no further candidate can change the result."""
        with self._lock:
            return all(s.done for s in self._sections)

    def finalize(self) -> List:
        """The merged, truncated, deduped solution list in monolithic
        order.  Call after every shard's stream has drained; sections
        stalled on never-delivered candidates (a shard skipped them past
        a cut) are flushed defensively."""
        with self._lock:
            progress = True
            while progress:
                self._advance()
                progress = False
                for s in self._sections:
                    if not s.done and s.next not in self._results:
                        s.next += 1        # skipped-beyond-cut candidate
                        if s.next >= s.sec.stop:
                            s.done = True
                        progress = True
            self._results.clear()   # beyond-cut leftovers: dead weight
            return [sol for sec in self._admitted for sol in sec]


# ---------------------------------------------------------------------------
# Parallel drivers
# ---------------------------------------------------------------------------


def solve_space(space: CandidateSpace,
                scorer: Optional[Callable] = None,
                reducer: Optional[SolutionReducer] = None) -> List:
    """Single-shard (in-thread) pipeline: enumerate -> evaluate ->
    reduce.  Work-equivalent to the monolithic search thanks to the
    reducer gate publishing each section's cut as it is reached."""
    red = reducer or SolutionReducer(space, scorer=scorer)
    (shard,) = space.shards(1) or [SolveShard(space, [], 0, 1)]
    for ev in evaluate(shard, gate=red):
        red.add(ev)
    return red.finalize()


_POOL_SPACE: Optional[CandidateSpace] = None


def _pool_init(space: CandidateSpace) -> None:
    global _POOL_SPACE
    _POOL_SPACE = space


def _pool_eval(idxs: List[int]) -> List[EvaluatedCandidate]:
    """Evaluate the given candidate indices of the per-process space copy.

    The space (and its conflict cache) persists for the worker process's
    lifetime, so memoized residue analyses carry across work units."""
    return list(evaluate(shard_from_indices(_POOL_SPACE, idxs)))


def evaluate_parallel(space: CandidateSpace, workers: int, *,
                      scorer: Optional[Callable] = None,
                      chunk: int = 24,
                      reducer: Optional[SolutionReducer] = None
                      ) -> SolutionReducer:
    """Evaluate ``space`` across ``workers`` processes, merging into one
    reducer.  Work units are small runs of candidate indices handed out
    in enumeration order, *filtered against the reducer's published
    section cuts at hand-out time*: once a section's cap is provably
    reached, none of its remaining candidates are ever dispatched.
    Total work therefore stays close to the monolithic search's while
    the evaluation wall-clock divides across processes.  Falls back to
    :func:`solve_space` when ``workers <= 1`` or the platform cannot
    fork.
    """
    red = reducer or SolutionReducer(space, scorer=scorer)
    if workers <= 1 or len(space) == 0:
        solve_space(space, reducer=red)
        return red
    import multiprocessing as mp
    from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor, wait
    try:
        ctx = mp.get_context("fork")
    except ValueError:             # no fork (non-POSIX): stay in-process
        solve_space(space, reducer=red)
        return red
    cursor = 0

    def next_chunk() -> List[int]:
        """Next ``chunk`` candidate indices still worth evaluating.
        Racy reads of the section states are safe: a cut only ever
        *appears*, so the filter is merely conservative."""
        nonlocal cursor
        idxs: List[int] = []
        while cursor < len(space) and len(idxs) < chunk:
            cand = space.candidates[cursor]
            st = red._sections[cand.section]
            if not (st.done or (st.cut is not None
                                and cand.index > st.cut)):
                idxs.append(cursor)
            cursor += 1
        return idxs

    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx,
                             initializer=_pool_init,
                             initargs=(space,)) as ex:
        pending = set()
        while True:
            while len(pending) < workers * 2:
                idxs = next_chunk()
                if not idxs:
                    break
                pending.add(ex.submit(_pool_eval, idxs))
            if not pending:
                break
            done, pending = wait(pending, return_when=FIRST_COMPLETED)
            for fut in done:
                for ev in fut.result():
                    red.add(ev)
            if red.complete():
                for fut in pending:
                    fut.cancel()
                break
    return red


# ---------------------------------------------------------------------------
# Wire codecs + remote gate (the distributed work-unit/cut protocol)
# ---------------------------------------------------------------------------
#
# A remote solve ships the candidate space ONCE per worker, then leases
# tiny work units (candidate index lists) against it; scored evaluation
# streams flow back and published section cuts flow out.  The codecs are
# pickle-based (solve workers are trusted peers of the service -- do not
# point them at untrusted networks) with zlib framing for the space,
# which dominates the bytes on the wire.

_WIRE_PROTO = pickle.HIGHEST_PROTOCOL


def space_to_wire(space: CandidateSpace) -> bytes:
    """Encode a candidate space for one-shot shipment to a remote
    worker.  The conflict cache is stripped (``__getstate__``); the
    worker rebuilds its own on first use and keeps it for the solve's
    lifetime, so memoized residue analyses span that worker's leases."""
    return zlib.compress(pickle.dumps(space, protocol=_WIRE_PROTO))


def space_from_wire(blob: bytes) -> CandidateSpace:
    return pickle.loads(zlib.decompress(blob))


def events_to_wire(events: Sequence[EvaluatedCandidate]) -> bytes:
    """Encode a batch of evaluation results (scored solutions attached)
    for the worker -> reducer stream."""
    return pickle.dumps(list(events), protocol=_WIRE_PROTO)


def events_from_wire(blob: bytes) -> List[EvaluatedCandidate]:
    return pickle.loads(blob)


def shard_from_indices(space: CandidateSpace,
                       indices: Sequence[int]) -> SolveShard:
    """Materialize a leased work unit (candidate indices) as a
    :class:`SolveShard` over a locally-held space."""
    return SolveShard(space=space,
                      candidates=[space.candidates[i] for i in indices])


class CutGate:
    """``evaluate()`` gate fed by externally published cuts.

    The remote counterpart of passing the :class:`SolutionReducer`
    itself as the gate: the service broadcasts ``reducer.cuts()``
    snapshots over the wire and the worker merges them here, so an
    in-flight remote shard prunes beyond-cut candidates exactly like a
    local one.  Cuts only ever appear (never move), so lock-free reads
    are merely conservative.
    """

    def __init__(self) -> None:
        self._cuts: Dict[int, int] = {}
        self._cancelled = False

    def update(self, cuts: Dict[int, int]) -> None:
        self._cuts.update(cuts)

    def cancel(self) -> None:
        self._cancelled = True

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def stop_index(self, section: int) -> Optional[int]:
        return self._cuts.get(section)

    def snapshot(self) -> Dict[int, int]:
        return dict(self._cuts)


__all__ = [
    "Candidate",
    "CandidateSpace",
    "CutGate",
    "EvaluatedCandidate",
    "Section",
    "SolutionReducer",
    "SolveShard",
    "evaluate",
    "evaluate_parallel",
    "events_from_wire",
    "events_to_wire",
    "shard_from_indices",
    "solve_space",
    "space_from_wire",
    "space_to_wire",
]
