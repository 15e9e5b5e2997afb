"""Comparison systems for Tables 2-3 (paper Sec 4).

* ``baseline``  -- the generalized hyperplane partitioning of Wang/Li/Cong
  (FPGA'14) [33]: flat hyperplane schemes only, first-order cost rules
  (minimize bank count, then fan-out), NO Sec-3.4 transforms (mul/div/mod
  stay as DSP/IP calls).
* ``spatial``   -- unmodified Spatial [18]: takes the FIRST valid scheme its
  naive enumeration finds (alpha = row-major weights, B = 1, N counting up
  from the group size); no search, no transforms, no cost model.
* ``merlin``    -- emulation of the Merlin compiler behaviour the paper
  observed on F1: pattern-matches accesses to a bounding-box stencil
  template (banking denoise/bicubic 'as sobel-like patterns': a full
  bbox_h x bbox_w cyclic multidim scheme) with raw resolution arithmetic.
  This is an emulation from the paper's description, not Merlin itself.
* ``ours``      -- the full system: flat + multidim + duplication search,
  transforms, ML (or proxy) ranking.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .controller import Program, unroll
from .planner import BankingPlan, BankingPlanner
from .geometry import ConflictCache, FlatGeometry, MultiDimGeometry, \
    flat_conflict_edges, multidim_conflict_edges, _max_conflict_clique
from .grouping import build_groups
from .polytope import linearize
from .solver import (
    BankingSolution,
    SolverOptions,
    _attach_flat,
    _attach_multidim,
    solve
)

import time


def _as_plan(memory: str, groups, sols, dt: float, opts: SolverOptions,
             system: str) -> BankingPlan:
    """Wrap a comparison system's schemes as a (detached) BankingPlan so
    every system yields the same artifact type; ``plan.compile()`` lowers
    the emulated system's choice exactly like ours."""
    return BankingPlan(
        memory=memory, signature="", best=sols[0] if sols else None,
        solve_seconds=dt, num_candidates=len(sols), scorer_name=system,
        status="solved", created_at=time.time(), opts=opts,
        solutions=list(sols), groups=list(groups))


def run_ours(program: Program, memory: str, scorer=None) -> BankingPlan:
    opts = SolverOptions(transform_level="full")
    planner = BankingPlanner(opts=opts)
    return planner.plan(program, memory, scorer=scorer)


def run_baseline_wang14(program: Program, memory: str) -> BankingPlan:
    """Flat-only, raw arithmetic, first-order (min-N then min-FO) selection."""
    t0 = time.perf_counter()
    up = unroll(program)
    groups = build_groups(up, memory)
    mem = program.memories[memory]
    opts = SolverOptions(
        transform_level="basic", allow_multidim=False, allow_duplication=False,
        max_solutions=24,
    )
    sols = solve(mem, groups, up.iterators, opts)
    # first-order rules: fewest banks, then smallest max fan-out
    sols.sort(key=lambda s: (s.num_banks,
                             max(s.fan_outs) if s.fan_outs else 1,
                             s.bank_volume))
    for s in sols:
        s.score = s.num_banks
    dt = time.perf_counter() - t0
    return _as_plan(memory, groups, sols, dt, opts, "baseline")


def run_spatial_firstvalid(program: Program, memory: str) -> BankingPlan:
    """Unmodified Spatial: FIRST valid flat scheme in naive order."""
    t0 = time.perf_counter()
    up = unroll(program)
    groups = build_groups(up, memory)
    mem = program.memories[memory]
    cache = ConflictCache(up.iterators)
    sizes = [len(g) for g in groups]
    naive_opts = SolverOptions(transform_level="basic")
    found: Optional[BankingSolution] = None
    ell = max(sizes) if sizes else 1
    for alpha in (linearize(mem.dims),) + tuple(
        tuple(1 if i == d else 0 for i in range(mem.n)) for d in range(mem.n)
    ):
        for N in range(max(1, -(-ell // mem.ports)), 8 * ell + 2):
            geo = FlatGeometry(N=N, B=1, alpha=alpha, P=(1,) * mem.n)
            ok = True
            worst = 1
            for g in groups:
                edges = flat_conflict_edges(list(g), geo, cache)
                clique = _max_conflict_clique(len(g), edges)
                worst = max(worst, clique)
                if clique > mem.ports:
                    ok = False
                    break
            if ok:
                from .geometry import propose_P
                P = propose_P(mem, N, 1, alpha)[0]
                geoP = FlatGeometry(N=N, B=1, alpha=alpha, P=P)
                found = _attach_flat(groups, mem, geoP, P, up.iterators,
                                     worst, naive_opts)
                break
        if found:
            break
    dt = time.perf_counter() - t0
    sols = [found] if found else []
    return _as_plan(memory, groups, sols, dt, naive_opts, "spatial")


def run_merlin_emulation(program: Program, memory: str) -> BankingPlan:
    """Bounding-box stencil template with raw arithmetic (see module doc)."""
    t0 = time.perf_counter()
    up = unroll(program)
    groups = build_groups(up, memory)
    mem = program.memories[memory]
    cache = ConflictCache(up.iterators)
    naive_opts = SolverOptions(transform_level="basic")
    # bounding box of constant offsets per dimension across the largest group
    big = max(groups, key=len) if groups else None
    spans = []
    for d in range(mem.n):
        consts = sorted({a.exprs[d].const for a in big} if big else {0})
        spans.append(max(2 if mem.n > 1 else 1, consts[-1] - consts[0] + 1))
    found = None
    for scale in range(0, 4):
        Ns = tuple(min(mem.dims[d], spans[d] + scale) for d in range(mem.n))
        if int(np.prod(Ns)) < 1:
            continue
        geo = MultiDimGeometry(Ns=Ns, Bs=(1,) * mem.n, alphas=(1,) * mem.n)
        ok = True
        worst = 1
        for g in groups:
            edges = multidim_conflict_edges(list(g), geo, cache)
            clique = _max_conflict_clique(len(g), edges)
            worst = max(worst, clique)
            if clique > mem.ports:
                ok = False
                break
        if ok:
            found = _attach_multidim(groups, mem, geo, up.iterators, worst,
                                     naive_opts, note="merlin-bbox")
            break
    if found is None:
        # fall back to whatever first-valid finds
        return run_spatial_firstvalid(program, memory)
    dt = time.perf_counter() - t0
    return _as_plan(memory, groups, [found], dt, naive_opts, "merlin")


SYSTEMS = {
    "baseline": run_baseline_wang14,
    "spatial": run_spatial_firstvalid,
    "merlin": run_merlin_emulation,
    "ours": run_ours,
}
