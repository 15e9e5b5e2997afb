"""Polyhedral machinery for the banking system.

The paper (Defs 2.1-2.9) represents each logical access as an affine map from
an iterator polytope to the array polytope and reduces banking validity to
*conflict-polytope emptiness*: geometry (N, B, alpha) is conflict-free for a
pair of accesses iff applying the bank-address equation to the *delta* of the
two address patterns (Def 2.8) can never produce bank-address zero (same
bank) for any point of the iterator polytope.

The paper uses ISL; ISL is not available here.  Instead we implement an exact
decision procedure for the class of polytopes the solver actually emits:
deltas of affine accesses over box-bounded (possibly unbounded /
data-dependent) integer iterators.  For such deltas, reachability of
``delta . alpha  (mod N*B)`` is a *sumset* problem over Z_M which we solve
exactly by dynamic programming over residues.  Uninterpreted function symbols
(Sec 2.2, non-affine address components) either cancel in the delta (same
symbol, synchronized occurrence) or are treated as unbounded unknowns --
conservative, exactly as quantifier-free Presburger with uninterpreted
symbols behaves.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Iterators and uninterpreted symbols
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Iterator:
    """A loop iterator (Def 2.4 contributes one dimension of the iterator space).

    Values are ``start + step * t`` for ``t in [0, count)``.  ``count=None``
    models data-dependent bounds (e.g. ``Q_RNG(x,y,z)`` in the MD running
    example) -- the iterator is then *unbounded* for emptiness purposes.
    """

    name: str
    start: int = 0
    step: int = 1
    count: Optional[int] = None  # None => data-dependent / unbounded

    def values(self, cap: int) -> np.ndarray:
        n = cap if self.count is None else min(self.count, cap)
        return self.start + self.step * np.arange(n)


@dataclass(frozen=True)
class Sym:
    """An uninterpreted function symbol used in an address (Sec 2.2).

    ``key`` identifies the syntactic call site *and* the argument values it
    was instantiated with (e.g. ``f(i0)`` under lane 3).  Two occurrences with
    the same key denote the same (unknown) value and cancel in deltas.
    """

    key: str


# ---------------------------------------------------------------------------
# Affine expressions:  sum(coeff * iterator) + sum(coeff * sym) + const
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Affine:
    terms: Tuple[Tuple[str, int], ...] = ()       # (iterator name, coeff)
    syms: Tuple[Tuple[str, int], ...] = ()        # (sym key, coeff)
    const: int = 0

    # -- construction helpers ------------------------------------------------
    @staticmethod
    def of(const: int = 0, **coeffs: int) -> "Affine":
        return Affine(
            terms=tuple(sorted((k, int(v)) for k, v in coeffs.items() if v != 0)),
            const=int(const),
        )

    @staticmethod
    def const_(c: int) -> "Affine":
        return Affine(const=int(c))

    def with_sym(self, key: str, coeff: int = 1) -> "Affine":
        d = dict(self.syms)
        d[key] = d.get(key, 0) + coeff
        return replace(self, syms=tuple(sorted((k, v) for k, v in d.items() if v != 0)))

    # -- algebra --------------------------------------------------------------
    def __add__(self, other: "Affine") -> "Affine":
        t = dict(self.terms)
        for k, v in other.terms:
            t[k] = t.get(k, 0) + v
        s = dict(self.syms)
        for k, v in other.syms:
            s[k] = s.get(k, 0) + v
        return Affine(
            terms=tuple(sorted((k, v) for k, v in t.items() if v != 0)),
            syms=tuple(sorted((k, v) for k, v in s.items() if v != 0)),
            const=self.const + other.const,
        )

    def __neg__(self) -> "Affine":
        return Affine(
            terms=tuple((k, -v) for k, v in self.terms),
            syms=tuple((k, -v) for k, v in self.syms),
            const=-self.const,
        )

    def __sub__(self, other: "Affine") -> "Affine":
        return self + (-other)

    def scale(self, c: int) -> "Affine":
        if c == 0:
            return Affine()
        return Affine(
            terms=tuple((k, v * c) for k, v in self.terms),
            syms=tuple((k, v * c) for k, v in self.syms),
            const=self.const * c,
        )

    def subst(self, name: str, value: "Affine") -> "Affine":
        """Substitute iterator ``name`` with affine ``value``."""
        coeff = dict(self.terms).get(name, 0)
        if coeff == 0:
            return self
        rest = Affine(
            terms=tuple((k, v) for k, v in self.terms if k != name),
            syms=self.syms,
            const=self.const,
        )
        return rest + value.scale(coeff)

    def rename(self, mapping: Dict[str, str]) -> "Affine":
        t: Dict[str, int] = {}
        for k, v in self.terms:
            nk = mapping.get(k, k)
            t[nk] = t.get(nk, 0) + v
        return replace(
            self, terms=tuple(sorted((k, v) for k, v in t.items() if v != 0))
        )

    def coeff(self, name: str) -> int:
        return dict(self.terms).get(name, 0)

    @property
    def iterator_names(self) -> Tuple[str, ...]:
        return tuple(k for k, _ in self.terms)

    def is_const(self) -> bool:
        return not self.terms and not self.syms

    def evaluate(self, env: Dict[str, int]) -> int:
        v = self.const
        for k, c in self.terms:
            v += c * env[k]
        for k, c in self.syms:
            v += c * env[k]
        return v

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        parts = [f"{c}*{k}" for k, c in self.terms]
        parts += [f"{c}*<{k}>" for k, c in self.syms]
        if self.const or not parts:
            parts.append(str(self.const))
        return " + ".join(parts)


# ---------------------------------------------------------------------------
# Exact residue reachability over Z_M (the emptiness oracle)
# ---------------------------------------------------------------------------

_FULL_CAP = 4096  # enumeration guard; moduli in banking problems are small


def _term_residues(coeff: int, count: Optional[int], M: int) -> np.ndarray:
    """Residues mod M reachable by ``coeff * t`` for t in [0, count)."""
    if M == 1:
        return np.zeros(1, dtype=np.int64)
    c = coeff % M
    if c == 0:
        return np.zeros(1, dtype=np.int64)
    g = math.gcd(c, M)
    period = M // g
    if count is None or count >= period:
        # full cyclic subgroup generated by gcd(c, M)
        return (np.arange(period, dtype=np.int64) * g) % M
    return (np.arange(count, dtype=np.int64) * c) % M


def _sumset(a: np.ndarray, b: np.ndarray, M: int) -> np.ndarray:
    if len(a) * len(b) <= 65536:
        return np.unique((a[:, None] + b[None, :]) % M)
    # indicator-based set convolution for large sets
    ia = np.zeros(M, dtype=bool)
    ia[a % M] = True
    out = np.zeros(M, dtype=bool)
    for r in np.unique(b % M):
        out |= np.roll(ia, int(r))
    return np.nonzero(out)[0].astype(np.int64)


def reachable_residues(
    expr: Affine, iters: Dict[str, Iterator], M: int
) -> np.ndarray:
    """Exact set of residues mod M attainable by ``expr`` over its iterators.

    Iterators present in ``expr`` but missing from ``iters`` (and all
    uninterpreted symbols) are treated as unbounded integers -- conservative.
    """
    if M <= 1:
        return np.zeros(1, dtype=np.int64)
    acc = np.array([expr.const % M], dtype=np.int64)
    for name, coeff in expr.terms:
        it = iters.get(name)
        if it is None:
            res = _term_residues(coeff, None, M)
        else:
            # value = start + step*t  => coeff*value = coeff*start + coeff*step*t
            base = (coeff * it.start) % M
            res = (_term_residues(coeff * it.step, it.count, M) + base) % M
        acc = _sumset(acc, res, M)
        if len(acc) == M:
            return acc  # saturated
    for _key, coeff in expr.syms:
        res = _term_residues(coeff, None, M)
        acc = _sumset(acc, res, M)
        if len(acc) == M:
            return acc
    return acc


def delta_can_hit_window(
    delta: Affine,
    iters: Dict[str, Iterator],
    N: int,
    B: int,
) -> bool:
    """Conflict-polytope non-emptiness test (Def 2.8 / 2.9).

    Two accesses with address delta ``delta`` (already dotted with alpha)
    share a bank under geometry (N, B) iff ``delta`` can be congruent to a
    value in the open window (-B, B) modulo N*B:

        y1 = B q1 + r1,  y2 = B q2 + r2,  q1 === q2 (mod N)
        =>  y1 - y2 === r1 - r2 (mod N*B)  with |r1 - r2| < B.

    For B == 1 this degenerates to the exact test ``delta === 0 (mod N)``.
    """
    M = N * B
    if M <= 1:
        return True  # single bank: everything conflicts
    res = reachable_residues(delta, iters, M)
    if B == 1:
        return bool((res == 0).any())
    lo, hi = M - (B - 1), B - 1  # window residues: [0, B) and (M-B, M)
    return bool(((res <= hi) | (res >= lo)).any())


# ---------------------------------------------------------------------------
# Array / access-pattern containers (Defs 2.5-2.7)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MemorySpec:
    """An n-dimensional on-chip memory (Def 2.5)."""

    name: str
    dims: Tuple[int, ...]
    word_bits: int = 32
    ports: int = 1  # k in Def 2.9 (BRAMs are commonly true-dual-ported: 2)

    @property
    def n(self) -> int:
        return len(self.dims)

    @property
    def volume(self) -> int:
        return int(np.prod(self.dims))


@dataclass(frozen=True)
class Access:
    """A logical access (Def 2.6): per-dimension affine address expressions.

    ``uid`` is the unroll-ID (Sec 2.4.3): one integer per parallelized
    ancestor naming the lane this access copy belongs to.
    """

    memory: str
    exprs: Tuple[Affine, ...]
    uid: Tuple[int, ...] = ()
    is_write: bool = False
    ctrl: str = ""          # id of the innermost controller containing it
    sched_cycle: int = 0    # schedule slot within an inner controller
    label: str = ""

    @property
    def n(self) -> int:
        return len(self.exprs)

    def dot(self, alpha: Sequence[int]) -> Affine:
        out = Affine()
        for e, a in zip(self.exprs, alpha):
            out = out + e.scale(int(a))
        return out


@dataclass
class AccessGroup:
    """Accesses that may be live in the same cycle (Def 2.7)."""

    accesses: List[Access] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.accesses)

    def __iter__(self):
        return iter(self.accesses)


def linearize(dims: Sequence[int]) -> Tuple[int, ...]:
    """Row-major linearization weights for an array shape."""
    w = [1] * len(dims)
    for i in range(len(dims) - 2, -1, -1):
        w[i] = w[i + 1] * dims[i + 1]
    return tuple(w)
