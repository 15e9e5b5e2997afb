"""Hierarchically-nested state-machine program model (paper Sec 2.4).

Programs are trees of *controllers*.  Outer controllers contain controllers;
inner controllers contain a scheduled dataflow block with memory accesses.
Parallelizing an inner controller vectorizes its accesses; parallelizing an
outer controller unrolls its subtree into lanes, each tagged with an
unroll-ID (UID).  The unroller below reproduces both strategies of Sec 2.4.3:

* FoP (ForkJoin-of-Pipelines): fork-join injected per child stage; all lanes
  of each child begin simultaneously.
* PoF (Pipeline-of-ForkJoins): each lane is a structurally complete clone;
  a single fork-join is injected above, lanes drift freely afterwards.

Iterator-synchronization analysis (Sec 3.2) decides, per iterator and lane
pair, whether the lanes observe the same iterator value each cycle
(*synchronized*; possibly offset by a constant = *partially synchronized*) or
not (*unsynchronized*), in which case the lanes get independent fresh
iterator variables -- the conservative widening the paper applies.

The rule implemented here (the paper's prose example has an FoP/PoF label
inconsistency with its own Fig. 6 definitions; we implement the semantics of
Fig. 6, conservatively):

* lanes below an unroll point stay in lockstep iff every controller in the
  unrolled subtree has static bounds and static initiation timing;
* the unrolled counter itself is shared across lanes iff the strategy is
  stage-synchronized (FoP) or the subtree is static.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional, Sequence, Tuple

from .polytope import Access, Affine, Iterator, MemorySpec


class Sched(Enum):
    SEQUENTIAL = "Sequential"
    PIPELINED = "Pipelined"
    FORKJOIN = "ForkJoin"
    FORK = "Fork"
    STREAM = "Stream"
    INNER = "Inner"


class Unroll(Enum):
    FOP = "ForkJoin-of-Pipelines"  # stage-synchronized lanes
    POF = "Pipeline-of-ForkJoins"  # lane-synchronized start only


@dataclass
class Counter:
    """One level of a multi-level counter chain.

    ``count=None`` marks a data-dependent bound (e.g. ``Q_RNG(x,y,z)``);
    ``start_sym`` marks a data-dependent start value.
    """

    name: str
    start: int = 0
    step: int = 1
    count: Optional[int] = None
    par: int = 1
    start_sym: Optional[str] = None  # uninterpreted start (data-dependent)

    @property
    def static(self) -> bool:
        return self.count is not None and self.start_sym is None


@dataclass
class AccessDecl:
    """A logical access written against the *declared* iterator names."""

    memory: str
    exprs: Tuple[Affine, ...]
    is_write: bool = False
    cycle: int = 0  # schedule slot inside the inner controller
    label: str = ""


@dataclass
class Ctrl:
    name: str
    sched: Sched
    counters: List[Counter] = field(default_factory=list)
    children: List["Ctrl"] = field(default_factory=list)
    accesses: List[AccessDecl] = field(default_factory=list)
    ii: int = 1        # initiation interval (inner controllers)
    latency: int = 1   # datapath latency (inner controllers)

    @property
    def is_inner(self) -> bool:
        return self.sched is Sched.INNER

    def subtree(self) -> List["Ctrl"]:
        out = [self]
        for c in self.children:
            out.extend(c.subtree())
        return out

    def subtree_static(self) -> bool:
        return all(
            cnt.static for node in self.subtree() for cnt in node.counters
        )

    @property
    def width(self) -> int:
        return len(self.children)


@dataclass
class Program:
    root: Ctrl
    memories: Dict[str, MemorySpec]
    unroll_strategy: Unroll = Unroll.FOP


# ---------------------------------------------------------------------------
# Unrolled form
# ---------------------------------------------------------------------------


@dataclass
class UnrolledProgram:
    accesses: List[Access]
    iterators: Dict[str, Iterator]
    # controller path (tuple of ctrl names root->leaf) for each access index
    paths: List[Tuple[str, ...]]
    ctrl_by_name: Dict[str, Ctrl]
    # names of ancestors of each access that are ForkJoin-like due to unroll
    unroll_forks: List[Tuple[str, ...]]


def _qualify(name: str, uid: Tuple[int, ...]) -> str:
    return f"{name}@{'.'.join(map(str, uid))}" if uid else name


def unroll(program: Program) -> UnrolledProgram:
    """Expand all parallelization into per-lane accesses with UIDs."""
    accesses: List[Access] = []
    iterators: Dict[str, Iterator] = {}
    paths: List[Tuple[str, ...]] = []
    forks: List[Tuple[str, ...]] = []
    ctrl_by_name: Dict[str, Ctrl] = {c.name: c for c in program.root.subtree()}
    strategy = program.unroll_strategy

    def visit(
        node: Ctrl,
        uid: Tuple[int, ...],
        subst: Dict[str, Affine],
        path: Tuple[str, ...],
        lockstep: bool,
        fork_ancestors: Tuple[str, ...],
    ) -> None:
        path = path + (node.name,)
        # Expand this controller's counters lane-by-lane.
        lane_spaces = [range(c.par) for c in node.counters]
        subtree_static = node.subtree_static()
        for lanes in itertools.product(*lane_spaces):
            lane_subst = dict(subst)
            lane_uid = uid + tuple(lanes)
            lane_lockstep = lockstep
            lane_forks = fork_ancestors
            for ci, (c, lane) in enumerate(zip(node.counters, lanes)):
                unrolled = c.par > 1
                if unrolled:
                    lane_forks = lane_forks + (node.name,)
                # does the base counter stay shared across lanes?
                shared = (not unrolled) or (strategy is Unroll.FOP) or subtree_static
                if unrolled and not subtree_static:
                    lane_lockstep = False
                # the counter base is one physical counter: always shared
                # across its OWN vectorization lanes; across OUTER lanes it
                # is shared only in lockstep (else per-outer-lane fresh).
                base_uid = () if (shared and lockstep) else uid + tuple(lanes[:ci])
                base_name = _qualify(c.name, base_uid)
                eff_step = c.step * c.par
                eff_count = None if c.count is None else -(-c.count // c.par)
                iterators.setdefault(
                    base_name,
                    Iterator(base_name, start=c.start, step=eff_step, count=eff_count),
                )
                # iterator value for this lane: base + lane*step (+ data-dep start)
                val = Affine.of(const=lane * c.step, **{base_name: 1})
                if c.start_sym is not None:
                    # the data-dependent start belongs to the counter BASE:
                    # it varies with enclosing lanes (e.g. the row) but is
                    # shared across this counter's own vectorization lanes,
                    # so those lanes' symbols cancel in deltas (Sec 2.2).
                    sym_uid = uid + tuple(lanes[:ci])
                    val = val.with_sym(_qualify(c.start_sym, sym_uid))
                lane_subst[c.name] = val
            if node.is_inner:
                for decl in node.accesses:
                    exprs = []
                    for e in decl.exprs:
                        out = e
                        for nm, val in lane_subst.items():
                            out = out.subst(nm, val)
                        # any leftover RAW syms in the expr: qualify per lane
                        # (counter-injected syms already carry their '@' uid)
                        if out.syms and not lane_lockstep:
                            out = Affine(
                                terms=out.terms,
                                syms=tuple(
                                    ((k if "@" in k else _qualify(k, lane_uid)), v)
                                    for k, v in out.syms
                                ),
                                const=out.const,
                            )
                        exprs.append(out)
                    accesses.append(
                        Access(
                            memory=decl.memory,
                            exprs=tuple(exprs),
                            uid=lane_uid,
                            is_write=decl.is_write,
                            ctrl=node.name,
                            sched_cycle=decl.cycle,
                            label=decl.label or f"{node.name}[{lane_uid}]",
                        )
                    )
                    paths.append(path)
                    forks.append(lane_forks)
            else:
                for child in node.children:
                    visit(child, lane_uid, lane_subst, path, lane_lockstep, lane_forks)

    visit(program.root, (), {}, (), True, ())
    return UnrolledProgram(accesses, iterators, paths, ctrl_by_name, forks)


# ---------------------------------------------------------------------------
# LCA + concurrency (Sec 3.2 / Fig 8 support)
# ---------------------------------------------------------------------------


def lca_name(path_a: Sequence[str], path_b: Sequence[str]) -> str:
    out = path_a[0]
    for x, y in zip(path_a, path_b):
        if x != y:
            break
        out = x
    return out


def is_concurrent(
    up: UnrolledProgram, ia: int, ib: int
) -> bool:
    """Paper's isConcurrent: may accesses ia and ib be live the same cycle?"""
    a, b = up.accesses[ia], up.accesses[ib]
    pa, pb = up.paths[ia], up.paths[ib]
    lca = lca_name(pa, pb)
    ctrl = up.ctrl_by_name[lca]

    if a.ctrl == b.ctrl and a.uid != b.uid:
        # lanes of the same (vectorized/unrolled) controller execute together
        return True
    if lca in up.unroll_forks[ia] or lca in up.unroll_forks[ib]:
        # unrolling injected a fork-join at this level (Sec 2.4.3)
        return True
    if ctrl.is_inner:
        return abs(a.sched_cycle - b.sched_cycle) < ctrl.ii
    if ctrl.sched in (Sched.FORKJOIN, Sched.STREAM):
        return True
    # Sequential / Fork: never concurrent.  Pipelined: concurrent in time but
    # routed to different buffers of an N-buffered memory (paper Sec 3.2), so
    # *not* part of the same banking group.
    return False
