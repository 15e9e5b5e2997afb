"""Banking solution-set construction (paper Sec 3.3).

Searches the (N, B, alpha, P) space for valid hyperplane geometries plus the
multidimensional (orthogonal-lattice) subset, with the paper's heuristics:

* prioritize N among the first multiples of the LCM of group sizes (small
  fan-out schemes come first),
* de-prioritize constants that the Sec 3.4 transforms cannot break down,
* drop (alpha, B) pairs that are not mutually co-prime (the same geometry is
  reachable by dividing out the GCD),
* record *fewer-ported* solutions (required_ports < available ports), and
* *bank-by-duplication* solutions that split heavy reader groups across
  array duplicates.

Fan-out / fan-in metrics are computed exactly from reachable residue sets
(not sampling): for geometry (N, B), an access's bank set is
``{ r // B  :  r in residues(x . alpha  mod N*B) }``.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from functools import reduce
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .geometry import (
    ConflictCache,
    FlatGeometry,
    MultiDimGeometry,
    _max_conflict_clique,
    flat_conflict_edges,
    multidim_conflict_edges,
    padding as geom_padding,
    propose_P,
)
from .polytope import (
    Access,
    AccessGroup,
    Iterator,
    MemorySpec,
    linearize,
    reachable_residues
)
from .resources import SchemeResources, estimate_scheme
from .transforms import (
    Cost,
    build_flat_resolution,
    build_multidim_resolution,
    cost as graph_cost,
    count_raw_ops,
    transform_friendliness,
)


# ---------------------------------------------------------------------------
# Options / solution containers
# ---------------------------------------------------------------------------


@dataclass
class SolverOptions:
    max_solutions: int = 32
    n_cap_factor: int = 4          # search N up to cap_factor * max group size
    n_budget: int = 48             # max distinct N values examined
    b_candidates: Tuple[int, ...] = (1, 2, 4, 3, 8, 7)
    allow_multidim: bool = True
    allow_duplication: bool = True
    duplication_factors: Tuple[int, ...] = (2, 4)
    # "full" = Sec-3.4 rewrites; "basic" = pow2-only (ordinary codegen,
    # what the baseline/spatial/merlin comparison systems get)
    transform_level: str = "full"
    alpha_budget: int = 12
    multidim_combo_budget: int = 256


@dataclass
class BankingSolution:
    memory: MemorySpec
    kind: str                      # "flat" | "multidim"
    geometry: object               # FlatGeometry | MultiDimGeometry
    P: Tuple[int, ...]
    pad: Tuple[int, ...]
    required_ports: int
    num_banks: int
    bank_volume: int
    fan_outs: Tuple[int, ...]      # per grouped access (reads+writes)
    max_fan_in: int
    duplicates: int = 1
    resolution_ba: object = None   # Node | tuple of Nodes
    resolution_bo: object = None   # Node
    arith_cost: Cost = field(default_factory=Cost)
    raw_ops: Dict[str, int] = field(default_factory=dict)
    resources: Optional[SchemeResources] = None
    score: float = float("inf")    # ranking score (ML cost model or proxy)
    note: str = ""

    @property
    def dsp_free(self) -> bool:
        return (self.resources is None) or self.resources.total.dsp == 0

    def describe(self) -> str:
        g = self.geometry
        if self.kind == "flat":
            head = f"flat N={g.N} B={g.B} alpha={g.alpha} P={self.P}"
        else:
            head = f"multidim N={g.Ns} B={g.Bs} alpha={g.alphas}"
        r = self.resources.total if self.resources else None
        tail = (f" banks={self.num_banks} vol={self.bank_volume}"
                f" FOmax={max(self.fan_outs) if self.fan_outs else 1}"
                f" ports={self.required_ports} dup={self.duplicates}")
        if r:
            tail += (f" | LUT={r.lut:.0f} FF={r.ff:.0f} BRAM={r.bram}"
                     f" DSP={r.dsp}")
        return head + tail


# ---------------------------------------------------------------------------
# Candidate sets
# ---------------------------------------------------------------------------


def _lcm(vals: Sequence[int]) -> int:
    return reduce(lambda a, b: a * b // math.gcd(a, b), [v for v in vals if v], 1)


def n_candidates(group_sizes: Sequence[int], ports: int, opts: SolverOptions) -> List[int]:
    ell = max(group_sizes) if group_sizes else 1
    lcm = _lcm(group_sizes)
    need = max(1, -(-ell // max(1, ports)))
    cand = set()
    for m in range(1, 5):
        if lcm * m >= need:
            cand.add(lcm * m)
    hi = max(need + 1, opts.n_cap_factor * ell + 1)
    cand.update(range(need, hi))
    ordered = sorted(
        cand,
        key=lambda n: (
            0 if (lcm and n % lcm == 0) else 1,   # LCM multiples first (paper)
            transform_friendliness(n),             # then Sec 3.4-friendly
            n,
        ),
    )
    return ordered[: opts.n_budget]


def alpha_candidates(mem: MemorySpec, groups: Sequence[AccessGroup],
                     opts: SolverOptions) -> List[Tuple[int, ...]]:
    n = mem.n
    cands: List[Tuple[int, ...]] = []

    def add(v: Tuple[int, ...]):
        g = reduce(math.gcd, [abs(x) for x in v if x], 0)
        if g > 1:
            v = tuple(x // g for x in v)
        if any(v) and v not in cands:
            cands.append(v)

    for d in range(n):
        e = [0] * n
        e[d] = 1
        add(tuple(e))
    add(tuple([1] * n))
    add(linearize(mem.dims))
    # strides observed in the accesses, per dim
    for d in range(n):
        coeffs = set()
        for g in groups:
            for a in g:
                for _, c in a.exprs[d].terms:
                    coeffs.add(abs(c))
        for c in sorted(coeffs)[:2]:
            if c > 1:
                e = [0] * n
                e[d] = c
                add(tuple(e))
    # diagonal-ish mixes for 2-D memories (wavefront patterns e.g. sw)
    if n == 2:
        add((1, 2))
        add((2, 1))
    return cands[: opts.alpha_budget]


# ---------------------------------------------------------------------------
# Exact fan metrics from residues
# ---------------------------------------------------------------------------


def flat_bank_set(a: Access, alpha, N: int, B: int,
                  iters: Dict[str, Iterator]) -> frozenset:
    y = a.dot(alpha)
    res = reachable_residues(y, iters, N * B)
    return frozenset(int(r) // B for r in res)


def multidim_bank_sets(a: Access, geo: MultiDimGeometry,
                       iters: Dict[str, Iterator]) -> Tuple[frozenset, ...]:
    out = []
    for d in range(len(geo.Ns)):
        y = a.exprs[d].scale(geo.alphas[d])
        res = reachable_residues(y, iters, geo.Ns[d] * geo.Bs[d])
        out.append(frozenset(int(r) // geo.Bs[d] for r in res))
    return tuple(out)


def _fan_metrics_flat(groups, alpha, N, B, iters):
    fos, fis = [], {}
    write_fos = []
    for g in groups:
        bank_touch: Dict[int, int] = {}
        for a in g:
            banks = flat_bank_set(a, alpha, N, B, iters)
            fos.append(len(banks))
            if a.is_write:
                write_fos.append(len(banks))
            for b in banks:
                bank_touch[b] = bank_touch.get(b, 0) + 1
        for b, c in bank_touch.items():
            fis[b] = max(fis.get(b, 0), c)
    return fos, write_fos, (max(fis.values()) if fis else 1), fis


def _fan_metrics_multidim(groups, geo, iters):
    fos, fis = [], {}
    write_fos = []
    for g in groups:
        bank_touch: Dict[Tuple, int] = {}
        for a in g:
            sets = multidim_bank_sets(a, geo, iters)
            fo = int(np.prod([len(s) for s in sets]))
            fos.append(fo)
            if a.is_write:
                write_fos.append(fo)
            for combo in itertools.product(*sets):
                bank_touch[combo] = bank_touch.get(combo, 0) + 1
        for b, c in bank_touch.items():
            fis[b] = max(fis.get(b, 0), c)
    return fos, write_fos, (max(fis.values()) if fis else 1), fis


# ---------------------------------------------------------------------------
# Resolution circuits + resource estimation for a geometry
# ---------------------------------------------------------------------------


def _flat_in_bits(mem: MemorySpec, alpha) -> int:
    span = sum(abs(a) * (d - 1) for a, d in zip(alpha, mem.dims)) + 1
    return max(4, span.bit_length() + 1)


def _attach_flat(sol_groups, mem, geo: FlatGeometry, P, iters,
                 required_ports, opts: SolverOptions, duplicates=1,
                 note="") -> BankingSolution:
    fos, wfos, max_fi, _ = _fan_metrics_flat(sol_groups, geo.alpha, geo.N, geo.B, iters)
    in_bits = _flat_in_bits(mem, geo.alpha)
    ba, bo = build_flat_resolution(geo.N, geo.B, geo.alpha, P, mem.dims,
                                   in_bits, level=opts.transform_level)
    ba_cost, bo_cost = graph_cost(ba, in_bits), graph_cost(bo, in_bits)
    res_costs = []
    # BA circuit elided for accesses pinned to one bank (constant-foldable)
    i = 0
    for g in sol_groups:
        for a in g:
            c = bo_cost if fos[i] == 1 else (ba_cost + bo_cost)
            res_costs.append(c)
            i += 1
    bank_vol = geo.bank_volume(mem.dims)
    resources = estimate_scheme(
        num_banks=geo.N,
        bank_volume=bank_vol,
        word_bits=mem.word_bits,
        addr_bits=max(1, (max(bank_vol - 1, 1)).bit_length()),
        fan_outs=[f for f in fos],
        fan_ins=[max_fi] * sum(1 for f in fos if f > 1) or [1],
        writes_fan_outs=wfos,
        resolution_costs=res_costs,
        duplicates=duplicates,
    )
    arith = Cost()
    for c in res_costs:
        arith = arith + c
    raw = count_raw_ops(ba)
    raw_bo = count_raw_ops(bo)
    raw = {k: raw[k] + raw_bo[k] for k in raw}
    return BankingSolution(
        memory=mem, kind="flat", geometry=geo, P=P,
        pad=geom_padding(mem, P), required_ports=required_ports,
        num_banks=geo.N, bank_volume=bank_vol, fan_outs=tuple(fos),
        max_fan_in=max_fi, duplicates=duplicates,
        resolution_ba=ba, resolution_bo=bo, arith_cost=arith, raw_ops=raw,
        resources=resources, note=note,
    )


def _attach_multidim(sol_groups, mem, geo: MultiDimGeometry, iters,
                     required_ports, opts: SolverOptions,
                     note="") -> BankingSolution:
    fos, wfos, max_fi, _ = _fan_metrics_multidim(sol_groups, geo, iters)
    in_bits = max(_flat_in_bits(mem, geo.alphas), 8)
    bas, bo = build_multidim_resolution(geo.Ns, geo.Bs, geo.alphas, mem.dims,
                                        in_bits, level=opts.transform_level)
    ba_cost = Cost()
    for b in bas:
        ba_cost = ba_cost + graph_cost(b, in_bits)
    bo_cost = graph_cost(bo, in_bits)
    res_costs = []
    i = 0
    for g in sol_groups:
        for a in g:
            res_costs.append(bo_cost if fos[i] == 1 else ba_cost + bo_cost)
            i += 1
    bank_vol = geo.bank_volume(mem.dims)
    resources = estimate_scheme(
        num_banks=geo.num_banks,
        bank_volume=bank_vol,
        word_bits=mem.word_bits,
        addr_bits=max(1, (max(bank_vol - 1, 1)).bit_length()),
        fan_outs=list(fos),
        fan_ins=[max_fi] * sum(1 for f in fos if f > 1) or [1],
        writes_fan_outs=wfos,
        resolution_costs=res_costs,
    )
    arith = Cost()
    for c in res_costs:
        arith = arith + c
    raw = {"mul": 0, "div": 0, "mod": 0}
    for g_ in list(bas) + [bo]:
        r = count_raw_ops(g_)
        raw = {k: raw[k] + r[k] for k in raw}
    P = tuple(max(1, -(-d // n)) for d, n in zip(mem.dims, geo.Ns))
    return BankingSolution(
        memory=mem, kind="multidim", geometry=geo, P=P,
        pad=geom_padding(mem, P), required_ports=required_ports,
        num_banks=geo.num_banks, bank_volume=bank_vol, fan_outs=tuple(fos),
        max_fan_in=max_fi, resolution_ba=bas, resolution_bo=bo,
        arith_cost=arith, raw_ops=raw, resources=resources, note=note,
    )


# ---------------------------------------------------------------------------
# Searches
# ---------------------------------------------------------------------------


def search_flat(mem: MemorySpec, groups: List[AccessGroup],
                iters: Dict[str, Iterator], opts: SolverOptions,
                duplicates: int = 1, note: str = "") -> List[BankingSolution]:
    cache = ConflictCache(iters)
    sizes = [len(g) for g in groups]
    out: List[BankingSolution] = []
    for alpha in alpha_candidates(mem, groups, opts):
        a_gcd = reduce(math.gcd, [abs(x) for x in alpha if x], 0)
        for B in opts.b_candidates:
            if B > 1 and math.gcd(a_gcd, B) != 1:
                continue  # co-primality pruning (paper Sec 3.3)
            for N in n_candidates(sizes, mem.ports, opts):
                geo = FlatGeometry(N=N, B=B, alpha=tuple(alpha), P=(1,) * mem.n)
                worst = 1
                ok = True
                for g in groups:
                    edges = flat_conflict_edges(list(g), geo, cache)
                    clique = _max_conflict_clique(len(g), edges)
                    worst = max(worst, clique)
                    if clique > mem.ports:
                        ok = False
                        break
                if not ok:
                    continue
                for P in propose_P(mem, N, B, alpha)[:2]:
                    geoP = FlatGeometry(N=N, B=B, alpha=tuple(alpha), P=P)
                    out.append(
                        _attach_flat(groups, mem, geoP, P, iters, worst, opts,
                                     duplicates=duplicates, note=note)
                    )
                if len(out) >= opts.max_solutions:
                    return out
    return out


def _dim_value_counts(groups: List[AccessGroup], dim: int) -> int:
    """Distinct projections of the accesses on one dimension."""
    seen = set()
    for g in groups:
        local = set()
        for a in g:
            e = a.exprs[dim]
            local.add((e.terms, e.syms, e.const))
        seen.add(len(local))
    return max(seen) if seen else 1


def search_multidim(mem: MemorySpec, groups: List[AccessGroup],
                    iters: Dict[str, Iterator], opts: SolverOptions
                    ) -> List[BankingSolution]:
    if mem.n < 2:
        return []
    cache = ConflictCache(iters)
    ell = max((len(g) for g in groups), default=1)
    cap = max(4 * ell, 8)
    per_dim: List[List[int]] = []
    for d in range(mem.n):
        k = _dim_value_counts(groups, d)
        cands = {1, k}
        cands.add(1 << max(0, (k - 1)).bit_length())  # next pow2
        if k + 1 <= mem.dims[d]:
            cands.add(k + 1)
        per_dim.append(sorted(c for c in cands if 1 <= c <= max(mem.dims[d], 1)))
    out: List[BankingSolution] = []
    combos = 0
    for Ns in itertools.product(*per_dim):
        combos += 1
        if combos > opts.multidim_combo_budget or len(out) >= opts.max_solutions:
            break
        if int(np.prod(Ns)) > cap or int(np.prod(Ns)) < 2:
            continue
        for Bs in ((1,) * mem.n, (2,) + (1,) * (mem.n - 1)):
            geo = MultiDimGeometry(Ns=tuple(Ns), Bs=Bs, alphas=(1,) * mem.n)
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
                out.append(_attach_multidim(groups, mem, geo, iters, worst, opts))
    return out


def search_duplication(mem: MemorySpec, groups: List[AccessGroup],
                       iters: Dict[str, Iterator], opts: SolverOptions
                       ) -> List[BankingSolution]:
    """Split the heaviest read group across duplicates and re-solve
    (paper: best when LUTs are scarce but BRAMs are abundant)."""
    if not groups:
        return []
    read_groups = [g for g in groups if not any(a.is_write for a in g)]
    if not read_groups:
        return []
    big = max(read_groups, key=len)
    if len(big) < 4:
        return []
    others = [g for g in groups if g is not big]
    out: List[BankingSolution] = []
    cache = ConflictCache(iters)
    for D in opts.duplication_factors:
        if len(big) < 2 * D:
            continue
        subsets = [AccessGroup(list(big)[i::D]) for i in range(D)]
        worst_subset = max(subsets, key=len)
        sub_opts = SolverOptions(
            max_solutions=8, n_budget=24,
            transform_level=opts.transform_level,
            allow_multidim=False, allow_duplication=False,
        )
        sols = search_flat(mem, others + [worst_subset], iters, sub_opts,
                           duplicates=D, note=f"dup x{D}")
        # the SAME geometry must be conflict-free for EVERY duplicate's
        # subset (writes are broadcast to all duplicates).  The `others`
        # groups don't change per duplicate -- the sub-search above
        # already verified them for every emitted geometry -- so only
        # each duplicate's subset needs re-checking, and a geometry's
        # verdict is shared across its P-proposal variants.
        verdicts: Dict[Tuple, bool] = {}
        valid = []
        for s in sols:
            gkey = (s.geometry.N, s.geometry.B, s.geometry.alpha)
            ok = verdicts.get(gkey)
            if ok is None:
                ok = True
                for sub in subsets:
                    edges = flat_conflict_edges(list(sub), s.geometry,
                                                cache)
                    if _max_conflict_clique(len(sub), edges) > mem.ports:
                        ok = False
                        break
                verdicts[gkey] = ok
            if ok:
                valid.append(s)
        out.extend(valid[:2])
    return out


def solve_monolithic(mem: MemorySpec, groups: List[AccessGroup],
                     iters: Dict[str, Iterator],
                     opts: Optional[SolverOptions] = None
                     ) -> List[BankingSolution]:
    """The pre-pipeline single-threaded nested-loop search.

    Kept as the reference implementation: the shard-equivalence property
    asserts that merging ``evaluate()`` streams reproduces this
    function's chosen scheme for any shard count -- whether the shards
    ran in-thread (tests/test_candidates.py), on a fork pool
    (``evaluate_parallel``), or on remote solve-fabric workers over the
    wire (tests/test_fabric.py).
    """
    opts = opts or SolverOptions()
    sols = search_flat(mem, groups, iters, opts)
    if opts.allow_multidim:
        sols += search_multidim(mem, groups, iters, opts)
    if opts.allow_duplication:
        sols += search_duplication(mem, groups, iters, opts)
    return sols


def solve(mem: MemorySpec, groups: List[AccessGroup],
          iters: Dict[str, Iterator],
          opts: Optional[SolverOptions] = None) -> List[BankingSolution]:
    """Construct the banking solution set for one problem.

    Since the candidate-space redesign this is the single-shard run of
    the shardable pipeline (enumerate -> evaluate -> reduce; see
    :mod:`repro_torch.core.candidates`): the same code path the service's
    sharded workers fan out across, with the reducer's section cuts
    reproducing the classic early-exit budgets, so the result matches
    :func:`solve_monolithic` exactly.
    """
    from .candidates import CandidateSpace, solve_space

    space = CandidateSpace(mem, groups, iters, opts or SolverOptions())
    return solve_space(space)
