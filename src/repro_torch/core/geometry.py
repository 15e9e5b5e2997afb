"""Hyperplane banking geometries (paper Sec 2.2, Table 1, Eqs 1-2).

A *flat* geometry banks the whole array with one hyperplane family:

    BA = floor((x . alpha) / B) mod N                                   (Eq 1)
    BO = B * sum_i( floor(x_i / P_i) * prod_{j>i} ceil(D_j / P_j) )
         + (x . alpha mod B)                                            (Eq 2)

A *multidimensional* geometry (Sec 3.3) banks each array dimension with its
own 1-D hyperplane geometry over the access projections; this captures the
orthogonal-parallelotope subset of lattice partitioning.  BA is then a vector
(one per dimension) and BO remains a scalar intra-bank offset.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .polytope import (
    Access,
    Affine,
    Iterator,
    MemorySpec,
    delta_can_hit_window,
)

# ---------------------------------------------------------------------------
# Geometry containers
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FlatGeometry:
    """(N, B, alpha, P) for a flat hyperplane scheme."""

    N: int
    B: int
    alpha: Tuple[int, ...]
    P: Tuple[int, ...]  # partition parallelotope (orthotope side lengths)

    @property
    def num_banks(self) -> int:
        return self.N

    def bank_address(self, x: Sequence[int]) -> int:
        y = int(np.dot(np.asarray(x, dtype=np.int64), np.asarray(self.alpha)))
        return (y // self.B) % self.N

    def bank_offset(self, x: Sequence[int], dims: Sequence[int]) -> int:
        acc = 0
        for i in range(len(dims)):
            stride = 1
            for j in range(i + 1, len(dims)):
                stride *= -(-dims[j] // self.P[j])  # ceil
            acc += (int(x[i]) // self.P[i]) * stride
        y = int(np.dot(np.asarray(x, dtype=np.int64), np.asarray(self.alpha)))
        return self.B * acc + (y % self.B)

    def bank_volume(self, dims: Sequence[int]) -> int:
        vol = self.B
        for j in range(len(dims)):
            vol *= -(-dims[j] // self.P[j])
        return vol


@dataclass(frozen=True)
class MultiDimGeometry:
    """Per-dimension 1-D hyperplane geometries (orthogonal lattice subset)."""

    Ns: Tuple[int, ...]
    Bs: Tuple[int, ...]
    alphas: Tuple[int, ...]  # scalar alpha per dimension

    @property
    def num_banks(self) -> int:
        return int(np.prod(self.Ns))

    def bank_address(self, x: Sequence[int]) -> Tuple[int, ...]:
        return tuple(
            ((int(xi) * a) // b) % n
            for xi, a, b, n in zip(x, self.alphas, self.Bs, self.Ns)
        )

    def bank_offset(self, x: Sequence[int], dims: Sequence[int]) -> int:
        # intra-bank offset: row-major over per-dim intra-bank coordinates
        coords = []
        sizes = []
        for xi, a, b, n, d in zip(x, self.alphas, self.Bs, self.Ns, dims):
            y = int(xi) * a
            block = y // (b * n)  # which repetition of the N-bank period
            within = y % b        # position inside the blocking factor
            blocks = -(-d * a // b)            # total B-blocks along this dim
            per_bank = -(-blocks // n)         # blocks landing in each bank
            coords.append(block * b + within)
            sizes.append(per_bank * b)
        off = 0
        for c, s in zip(coords, sizes):
            off = off * s + c
        return off

    def bank_volume(self, dims: Sequence[int]) -> int:
        vol = 1
        for a, b, n, d in zip(self.alphas, self.Bs, self.Ns, dims):
            blocks = -(-d * a // b)
            per_bank = -(-blocks // n)
            vol *= per_bank * b
        return vol


Geometry = "FlatGeometry | MultiDimGeometry"


# ---------------------------------------------------------------------------
# Validity (Def 2.9) -- conflict graph + clique bound
# ---------------------------------------------------------------------------


def _pair_delta(a: Access, b: Access, alpha: Sequence[int]) -> Affine:
    return a.dot(alpha) - b.dot(alpha)


def _dim_delta(a: Access, b: Access, dim: int, alpha_d: int) -> Affine:
    return a.exprs[dim].scale(alpha_d) - b.exprs[dim].scale(alpha_d)


def _max_conflict_clique(n_nodes: int, edges: set) -> int:
    """Size of the largest clique in the pairwise-conflict graph.

    Groups are small (tens of accesses); greedy + exact fallback via
    networkx when the greedy bound straddles the port limit.
    """
    if not edges:
        return 1
    adj: Dict[int, set] = {i: set() for i in range(n_nodes)}
    for u, v in edges:
        adj[u].add(v)
        adj[v].add(u)
    # Greedy lower bound
    best = 2
    order = sorted(adj, key=lambda u: -len(adj[u]))
    for u in order[: min(len(order), 16)]:
        clique = {u}
        for v in sorted(adj[u], key=lambda w: -len(adj[w])):
            if all(v in adj[c] for c in clique):
                clique.add(v)
        best = max(best, len(clique))
    return best


class ConflictCache:
    """Memoizes residue analyses keyed by canonical delta signature.

    Lanes of a vectorized access differ only in constants, so the same
    symbolic delta recurs across many pairs; caching makes the candidate
    sweep cheap (the paper's 'quickly identify valid schemes').

    Also memoizes the *pair deltas themselves*: for a fixed access pair
    and alpha, the symbolic delta is independent of (N, B), so the affine
    arithmetic runs once per (pair, alpha) instead of once per candidate
    geometry -- the dominant cost of a cold candidate sweep.

    One cache may be shared by every shard of a candidate-space solve:
    entries are pure functions of their keys, so racing threads at worst
    recompute a value (dict reads/writes are individually atomic).
    """

    def __init__(self, iters: Dict[str, Iterator]):
        self.iters = iters
        self._memo: Dict[Tuple, bool] = {}
        self._deltas: Dict[Tuple, Affine] = {}
        # pin delta-key accesses: keys embed id(), which must stay unique
        self._pins: Dict[int, Access] = {}

    def conflicts(self, delta: Affine, N: int, B: int) -> bool:
        key = (delta.terms, delta.syms, delta.const % (N * B), N, B)
        hit = self._memo.get(key)
        if hit is None:
            hit = delta_can_hit_window(delta, self.iters, N, B)
            self._memo[key] = hit
        return hit

    def pair_delta(self, a: Access, b: Access,
                   alpha: Tuple[int, ...]) -> Affine:
        key = (id(a), id(b), alpha)
        d = self._deltas.get(key)
        if d is None:
            d = _pair_delta(a, b, alpha)
            self._deltas[key] = d
            self._pins[id(a)] = a
            self._pins[id(b)] = b
        return d

    def dim_delta(self, a: Access, b: Access, dim: int,
                  alpha_d: int) -> Affine:
        key = (id(a), id(b), dim, alpha_d)
        d = self._deltas.get(key)
        if d is None:
            d = _dim_delta(a, b, dim, alpha_d)
            self._deltas[key] = d
            self._pins[id(a)] = a
            self._pins[id(b)] = b
        return d


def flat_conflict_edges(
    group: Sequence[Access],
    geo: FlatGeometry,
    cache: ConflictCache,
) -> set:
    edges = set()
    for i, j in itertools.combinations(range(len(group)), 2):
        d = cache.pair_delta(group[i], group[j], geo.alpha)
        if cache.conflicts(d, geo.N, geo.B):
            edges.add((i, j))
    return edges


def flat_is_valid(
    group: Sequence[Access],
    geo: FlatGeometry,
    cache: ConflictCache,
    ports: int,
) -> bool:
    """Def 2.9: no >ports accesses may simultaneously resolve to one bank."""
    edges = flat_conflict_edges(group, geo, cache)
    return _max_conflict_clique(len(group), edges) <= ports


def multidim_conflict_edges(
    group: Sequence[Access],
    geo: MultiDimGeometry,
    cache: ConflictCache,
) -> set:
    """A pair conflicts only if it conflicts on EVERY dimension (the paper's
    'regrouping': guaranteed-different BA on one dim rules the pair out)."""
    edges = set()
    for i, j in itertools.combinations(range(len(group)), 2):
        all_dims = True
        for d in range(len(geo.Ns)):
            delta = cache.dim_delta(group[i], group[j], d, geo.alphas[d])
            if not cache.conflicts(delta, geo.Ns[d], geo.Bs[d]):
                all_dims = False
                break
        if all_dims:
            edges.add((i, j))
    return edges


def multidim_is_valid(
    group: Sequence[Access],
    geo: MultiDimGeometry,
    cache: ConflictCache,
    ports: int,
) -> bool:
    edges = multidim_conflict_edges(group, geo, cache)
    return _max_conflict_clique(len(group), edges) <= ports


# ---------------------------------------------------------------------------
# Partition parallelotope P + padding (Table 1: delta) for flat geometries
# ---------------------------------------------------------------------------


def propose_P(mem: MemorySpec, N: int, B: int, alpha: Sequence[int]) -> List[Tuple[int, ...]]:
    """Candidate P orthotopes for a flat geometry.

    P must tile a region in which every BA appears >=1 and <=B times
    (Sec 2.2).  We propose concentrating the N*B period along each dimension
    with nonzero alpha and verify by enumeration of one period region.
    """
    n = mem.n
    out: List[Tuple[int, ...]] = []
    period = N * B
    for d in range(n):
        if alpha[d] == 0:
            continue
        a = abs(alpha[d])
        span = period // math.gcd(period, a)
        P = [1] * n
        P[d] = max(1, span)
        if P[d] <= mem.dims[d] * 2:
            out.append(tuple(P))
    if not out:
        out.append(tuple([1] * n))
    # verify each candidate; keep those covering every bank <= B times
    ok = []
    for P in out:
        if _verify_P(mem, N, B, alpha, P):
            ok.append(P)
    return ok or [_fallback_P(mem, N, B, alpha)]


def _verify_P(mem: MemorySpec, N: int, B: int, alpha, P) -> bool:
    region = [min(p, d) for p, d in zip(P, mem.dims)]
    if int(np.prod(region)) > 65536:
        return False
    counts = np.zeros(N, dtype=np.int64)
    for x in itertools.product(*[range(r) for r in region]):
        y = sum(xi * a for xi, a in zip(x, alpha))
        counts[(y // B) % N] += 1
    return bool((counts >= 1).all() and (counts <= B).all())


def _fallback_P(mem: MemorySpec, N: int, B: int, alpha) -> Tuple[int, ...]:
    # Degenerate but always-correct: one element per P-cell along dim with
    # largest |alpha| spanning the whole dimension (bank volume = whole array
    # over N after padding).  Used only when no structured P verifies.
    n = mem.n
    d = int(np.argmax([abs(a) for a in alpha])) if any(alpha) else 0
    P = [1] * n
    P[d] = mem.dims[d]
    return tuple(P)


def padding(mem: MemorySpec, P: Sequence[int]) -> Tuple[int, ...]:
    """Per-dimension pad so P tiles the (padded) array exactly."""
    return tuple((-d) % p for d, p in zip(mem.dims, P))


# ---------------------------------------------------------------------------
# Metrics: fan-out / fan-in (Table 1)
# ---------------------------------------------------------------------------


def _sample_iters(iters: Dict[str, Iterator], n_samples: int, seed: int) -> List[Dict[str, int]]:
    rng = np.random.default_rng(seed)
    envs = []
    for _ in range(n_samples):
        env = {}
        for name, it in iters.items():
            cnt = it.count if it.count is not None else 64
            t = int(rng.integers(0, max(cnt, 1)))
            env[name] = it.start + it.step * t
        envs.append(env)
    return envs


def fan_out(
    access: Access,
    geo,
    dims: Sequence[int],
    iters: Dict[str, Iterator],
    sym_env: Optional[Dict[str, int]] = None,
    n_samples: int = 128,
) -> int:
    """FO_a: number of distinct banks an access can touch (sampled exactly
    for bounded iterator spaces, statistically otherwise)."""
    names = set(access.dot(getattr(geo, "alpha", tuple([1] * len(dims)))).iterator_names)
    for e in access.exprs:
        names.update(e.iterator_names)
    bounded = all(
        iters.get(nm) is not None and iters[nm].count is not None and iters[nm].count <= 64
        for nm in names
    )
    banks = set()
    sym_env = dict(sym_env or {})
    for e in access.exprs:
        for k, _ in e.syms:
            sym_env.setdefault(k, 0)
    if bounded and names:
        spaces = [iters[nm].values(64) for nm in names]
        total = int(np.prod([len(s) for s in spaces]))
        if total <= 4096:
            for combo in itertools.product(*spaces):
                env = dict(zip(names, (int(c) for c in combo)))
                env.update(sym_env)
                x = [e.evaluate(env) for e in access.exprs]
                banks.add(geo.bank_address(x))
            return len(banks)
    for env in _sample_iters(iters, n_samples, seed=0xB4):
        env = dict(env)
        env.update(sym_env)
        x = [e.evaluate(env) for e in access.exprs]
        banks.add(geo.bank_address(x))
    return len(banks)


def fan_ins(
    group: Sequence[Access],
    geo,
    dims: Sequence[int],
    iters: Dict[str, Iterator],
) -> Dict:
    """FI_b per bank, sampled: how many accesses can feed each bank."""
    fi: Dict = {}
    for acc in group:
        sym_env = {}
        for e in acc.exprs:
            for k, _ in e.syms:
                sym_env.setdefault(k, 0)
        touched = set()
        for env in _sample_iters(iters, 64, seed=0x5EED):
            env = dict(env)
            env.update(sym_env)
            x = [e.evaluate(env) for e in acc.exprs]
            touched.add(geo.bank_address(x))
        for b in touched:
            fi[b] = fi.get(b, 0) + 1
    return fi
