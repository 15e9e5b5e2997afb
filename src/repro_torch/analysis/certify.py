"""Independent conflict-freedom certifier: the solver's second opinion.

The whole solving spine -- solver, reducer, fabric, store -- trusts ONE
decision procedure, the indicator-vector sumset DP behind
:func:`repro_torch.core.polytope.delta_can_hit_window`.  This module re-decides
every access pair of a finished :class:`~repro_torch.core.solver.BankingSolution`
through a deliberately different path:

* **bounded lattice enumeration** -- iterators with small static trip
  counts are walked point by point over their actual window, so a
  conflict arrives with the concrete lattice assignment that collides;
* **residue-witness sets** -- unbounded iterators, data-dependent
  counters and ``Sym`` terms contribute the cyclic subgroup of Z_M they
  generate (plain gcd arithmetic plus explicit per-residue witness
  pointers, never the numpy roll-convolution sumset).

Agreement yields a machine-checkable :class:`ConflictCertificate`: a
JSON document carrying, for every distinct pair delta, the residue
classes mod the free-term subgroup reachable by the bounded part and
the conflict-window classes they must avoid.  :func:`check_certificate`
re-derives every proof offline -- a plan store can be audited without
the solver.  Disagreement yields a concrete :class:`Counterexample` --
two iterator points, same cycle, same bank -- that renders directly as
a pytest regression case (``Counterexample.to_pytest``).
"""

from __future__ import annotations

import itertools
import json
import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.polytope import Access, AccessGroup, Affine, Iterator
from ..core.solver import BankingSolution

__all__ = [
    "CERTIFICATE_FORMAT",
    "CertificationError",
    "ConflictCertificate",
    "Counterexample",
    "PairDecision",
    "certify_plan",
    "certify_solution",
    "check_certificate",
    "certificate_matches_plan",
    "decide_delta",
    "make_batch_verifier",
]

CERTIFICATE_FORMAT = "conflict-certificate/v1"
_ENUM_CAP = 1 << 14       # max lattice points enumerated outright
_SCAN_CAP = 1 << 12       # max env grid scanned for a literal collision


class CertificationError(RuntimeError):
    """A scheme failed independent certification.

    Carries the :class:`Counterexample` (when one was constructed) so
    callers can persist it or render it as a regression test.
    """

    def __init__(self, message: str, counterexample=None):
        super().__init__(message)
        self.counterexample = counterexample


# ---------------------------------------------------------------------------
# The independent pair decision
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PairDecision:
    """Outcome of independently re-deciding one pair delta mod N*B.

    The reachable residue set of the delta factors as ``partials + <d>``
    where ``d`` generates the subgroup contributed by the free terms
    (unbounded iterators / Syms) and ``partials`` is the finite set the
    bounded lattice reaches.  Conflict iff some conflict-window residue
    is congruent mod ``d`` to some partial -- so the proof of conflict-
    freedom is just two disjoint residue-class sets.
    """

    conflict: bool
    M: int
    subgroup: int                       # d: free-term subgroup generator
    partials: Tuple[int, ...]           # bounded-part residues mod d
    window: Tuple[int, ...]             # window residues mod d
    method: str                         # trivial | lattice | witness-set
    witness: Optional[Dict[str, int]] = None   # env hitting the window


def _extgcd(a: int, b: int) -> Tuple[int, int, int]:
    """(g, x, y) with x*a + y*b == g == gcd(a, b)."""
    old_r, r = a, b
    old_x, x = 1, 0
    old_y, y = 0, 1
    while r:
        q = old_r // r
        old_r, r = r, old_r - q * r
        old_x, x = x, old_x - q * x
        old_y, y = y, old_y - q * y
    return old_r, old_x, old_y


def _solve_free(gens: Sequence[int], target: int, M: int) -> List[int]:
    """Integer multipliers x with sum(x[i]*gens[i]) === target (mod M).

    Requires ``target`` to be a multiple of gcd(M, *gens); folds the
    generators through the extended euclidean algorithm, tracking how
    each partial gcd is expressed over the generators (the M component
    of the combination vanishes mod M).
    """
    d = M
    combo: List[int] = []
    for g in gens:
        g2, a, b = _extgcd(d, g % M)
        combo = [a * c for c in combo] + [b]
        d = g2
    if d == 0:
        d = M
    k = (target % M) // d
    return [c * k for c in combo]


def _bounded_partials(const, bounded, M, enum_cap):
    """Residues mod M reachable by ``const + sum(c*t)`` with one witness
    lattice assignment each -> ({residue: (t, ...)}, method)."""
    total = 1
    for _name, _c, trips in bounded:
        total *= trips
    if total <= enum_cap:
        # bounded lattice enumeration: walk the actual iteration lattice
        out: Dict[int, Tuple[int, ...]] = {}
        for ts in itertools.product(*(range(tr) for _, _, tr in bounded)):
            r = const
            for (_name, c, _tr), t in zip(bounded, ts):
                r += c * t
            out.setdefault(r % M, ts)
            if len(out) == M:
                break
        return out, "lattice"
    # residue-witness sets: fold one term at a time, keeping for every
    # new residue a witness pointer back into the previous layer
    layers: List[Dict[int, Optional[Tuple[int, int]]]] = [{const % M: None}]
    for _name, c, trips in bounded:
        prev, nxt = layers[-1], {}
        for r in prev:
            for t in range(trips):
                nr = (r + c * t) % M
                if nr not in nxt:
                    nxt[nr] = (r, t)
            if len(nxt) == M:
                break
        layers.append(nxt)
    out = {}
    for r in layers[-1]:
        ts: List[int] = []
        rr = r
        for li in range(len(bounded), 0, -1):
            back = layers[li][rr]
            assert back is not None
            rr, t = back
            ts.append(t)
        out[r] = tuple(reversed(ts))
    return out, "witness-set"


def decide_delta(delta: Affine, iters: Dict[str, Iterator], N: int, B: int,
                 *, enum_cap: int = _ENUM_CAP) -> PairDecision:
    """Independently decide conflict-window reachability for one delta.

    Same predicate as :func:`~repro_torch.core.polytope.delta_can_hit_window`
    (Def 2.8/2.9: delta === r (mod N*B) with |r| < B), decided by
    lattice enumeration + subgroup witness arithmetic instead of the
    sumset DP.  Conflicting decisions come with a concrete witness
    environment assigning every variable of ``delta``.
    """
    M = int(N) * int(B)
    names = [k for k, _ in delta.terms] + [k for k, _ in delta.syms]
    if M <= 1:
        env = {}
        for n in names:
            it = iters.get(n)
            env[n] = it.start if it is not None else 0
        return PairDecision(True, M, 1, (0,), (0,), "trivial", env)
    window = tuple(sorted({w % M for w in range(-(B - 1), B)}))
    const = delta.const % M
    fixed: Dict[str, int] = {}
    bounded: List[Tuple[str, int, int, Iterator]] = []   # name, c, trips, it
    free: List[Tuple[str, str, int, Optional[Iterator]]] = []
    for name, coeff in delta.terms:
        it = iters.get(name)
        if it is None:
            # unknown trip space: conservative unbounded integer
            if coeff % M == 0:
                fixed[name] = 0
            else:
                free.append(("raw", name, coeff % M, None))
            continue
        const = (const + coeff * it.start) % M
        c = (coeff * it.step) % M
        if c == 0 or (it.count is not None and it.count <= 1):
            fixed[name] = it.start
            continue
        period = M // math.gcd(c, M)
        if it.count is None or it.count >= period:
            # the window already wraps the whole subgroup <gcd(c, M)>
            free.append(("iter", name, c, it))
        else:
            bounded.append((name, c, min(it.count, period), it))
    for key, coeff in delta.syms:
        if coeff % M == 0:
            fixed.setdefault(key, 0)
        else:
            free.append(("sym", key, coeff % M, None))
    d = M
    for _kind, _name, g, _it in free:
        d = math.gcd(d, g)
    partials, method = _bounded_partials(
        const, [(n, c, tr) for n, c, tr, _ in bounded], M, enum_cap)
    hit = None
    for p in partials:
        for w in window:
            if (w - p) % d == 0:
                hit = (p, w)
                break
        if hit:
            break
    p_mod = tuple(sorted({p % d for p in partials}))
    w_mod = tuple(sorted({w % d for w in window}))
    if hit is None:
        return PairDecision(False, M, d, p_mod, w_mod, method, None)
    p, w = hit
    env = dict(fixed)
    for (name, _c, _tr, it), t in zip(bounded, partials[p]):
        env[name] = it.start + it.step * t
    xs = _solve_free([g for _k, _n, g, _i in free], (w - p) % M, M)
    for (kind, name, g, it), x in zip(free, xs):
        if kind == "iter":
            period = M // math.gcd(g, M)
            t = x % period
            env[name] = it.start + it.step * t
        else:
            env[name] = x % M
    r = delta.evaluate(env) % M
    assert r in set(window), (delta, env, r)     # internal soundness check
    return PairDecision(True, M, d, p_mod, w_mod, method, env)


# ---------------------------------------------------------------------------
# Counterexamples
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Counterexample:
    """Two concurrent accesses, one iterator point, one shared bank.

    ``env`` assigns every iterator/Sym the pair depends on; ``x1``/``x2``
    are the resulting array points and ``bank1``/``bank2`` their bank
    ids under the refuted scheme.  ``same_bank`` is True when the two
    points literally land on one bank; when only the relaxed window
    criterion (Def 2.8) is violated the residue evidence is kept
    instead and ``same_bank`` is False.
    """

    memory: str
    scheme: str
    group: str
    a_label: str
    b_label: str
    env: Dict[str, int]
    x1: Tuple[int, ...]
    x2: Tuple[int, ...]
    bank1: object
    bank2: object
    same_bank: bool
    residue: int
    window: Tuple[int, ...]
    note: str = ""

    def describe(self) -> str:
        head = (f"{self.memory}: accesses {self.a_label!r}/{self.b_label!r}"
                f" at env={self.env} -> points {self.x1} / {self.x2}")
        if self.same_bank:
            return f"{head} share bank {self.bank1} under {self.scheme}"
        return (f"{head} hit window residue {self.residue} (window "
                f"{self.window}) under {self.scheme}")

    def to_json(self) -> dict:
        return {
            "format": "conflict-counterexample/v1",
            "memory": self.memory, "scheme": self.scheme,
            "group": self.group,
            "a_label": self.a_label, "b_label": self.b_label,
            "env": dict(self.env),
            "x1": list(self.x1), "x2": list(self.x2),
            "bank1": _bank_json(self.bank1), "bank2": _bank_json(self.bank2),
            "same_bank": self.same_bank,
            "residue": self.residue, "window": list(self.window),
            "note": self.note,
        }

    def to_pytest(self, name: str = "test_certifier_counterexample") -> str:
        """Render as a self-contained pytest regression case.

        The generated test re-evaluates the two array points at the
        recorded environment and asserts the collision is real -- it
        fails only if someone edits it out of agreement with the
        recorded evidence, so a future solver/certifier disagreement
        lands in the suite as a reproducible case, not a log line.
        """
        cex = json.dumps(self.to_json(), indent=1, sort_keys=True)
        body = [
            "import json",
            "",
            "",
            f"def {name}():",
            '    """Auto-rendered by repro_torch.analysis.certify; see',
            "    Counterexample.to_pytest.  Evidence that the scheme",
            f"    {self.scheme!r}",
            f"    conflicts on memory {self.memory!r}.",
            '    """',
            # JSON, not a Python literal: true/false/null must parse
            f"    cex = json.loads(r'''{cex}''')",
            "    x1, x2 = tuple(cex['x1']), tuple(cex['x2'])",
        ]
        if self.same_bank:
            body += [
                "    assert cex['same_bank']",
                "    assert cex['bank1'] == cex['bank2'], (",
                "        'recorded points must collide on one bank')",
            ]
        else:
            body += [
                "    assert cex['residue'] in cex['window'], (",
                "        'recorded delta residue must sit in the window')",
            ]
        return "\n".join(body) + "\n"


def _bank_json(bank):
    if isinstance(bank, tuple):
        return list(int(b) for b in bank)
    return int(bank) if bank is not None else None


def _point(access: Access, env: Dict[str, int]) -> Tuple[int, ...]:
    return tuple(int(e.evaluate(env)) for e in access.exprs)


def _pair_names(a: Access, b: Access) -> List[str]:
    names: List[str] = []
    for acc in (a, b):
        for e in acc.exprs:
            for k, _ in e.terms:
                if k not in names:
                    names.append(k)
            for k, _ in e.syms:
                if k not in names:
                    names.append(k)
    return names


def _literal_collision(a, b, geometry, iters, env0, *, cap=_SCAN_CAP):
    """Scan a small env grid near the witness for a literal shared bank."""
    names = _pair_names(a, b)
    axes: List[List[int]] = []
    for n in names:
        it = iters.get(n)
        if it is not None:
            trips = it.count if it.count is not None else 16
            vals = [it.start + it.step * t for t in range(min(trips, 16))]
        else:
            base = env0.get(n, 0)
            vals = [base + k for k in range(-4, 12)]
        if env0.get(n) is not None and env0[n] not in vals:
            vals.insert(0, env0[n])
        axes.append(vals)
    total = 1
    for vals in axes:
        total *= len(vals)
    while total > cap:
        big = max(range(len(axes)), key=lambda i: len(axes[i]))
        total //= len(axes[big])
        axes[big] = axes[big][:max(1, len(axes[big]) // 2)]
        total *= len(axes[big])
    for combo in itertools.product(*axes):
        env = dict(zip(names, combo))
        b1 = geometry.bank_address(_point(a, env))
        b2 = geometry.bank_address(_point(b, env))
        if b1 == b2:
            return env, b1
    return None, None


def _counterexample(sol, group_label, a, b, iters, env, residue, window,
                    note=""):
    geo = sol.geometry
    lit_env, bank = _literal_collision(a, b, geo, iters, env)
    if lit_env is not None:
        env, same = lit_env, True
        bank1 = bank2 = bank
    else:
        same = False
        bank1 = geo.bank_address(_point(a, env))
        bank2 = geo.bank_address(_point(b, env))
    return Counterexample(
        memory=sol.memory.name, scheme=sol.describe(), group=group_label,
        a_label=a.label or f"access{a.uid}",
        b_label=b.label or f"access{b.uid}",
        env=dict(env), x1=_point(a, env), x2=_point(b, env),
        bank1=bank1, bank2=bank2, same_bank=same,
        residue=residue, window=tuple(window), note=note)


# ---------------------------------------------------------------------------
# Whole-solution certification
# ---------------------------------------------------------------------------

def _clique_lower_bound(n: int, edges: set) -> int:
    """Greedy clique bound, reimplemented here so the certifier's verdict
    never borrows code from the path under audit (same semantics as the
    solver's: the certificate records the full edge set, so a stronger
    offline checker can always re-derive an exact clique)."""
    if not edges:
        return 1
    adj: Dict[int, set] = {i: set() for i in range(n)}
    for u, v in edges:
        adj[u].add(v)
        adj[v].add(u)
    best = 2
    for u in sorted(adj, key=lambda q: -len(adj[q]))[:16]:
        clique = {u}
        for v in sorted(adj[u], key=lambda w: -len(adj[w])):
            if all(v in adj[c] for c in clique):
                clique.add(v)
        best = max(best, len(clique))
    return best


def _geometry_json(sol: BankingSolution) -> dict:
    g = sol.geometry
    if sol.kind == "flat":
        return {"kind": "flat", "N": int(g.N), "B": int(g.B),
                "alpha": [int(x) for x in g.alpha],
                "P": [int(x) for x in g.P]}
    return {"kind": "multidim", "Ns": [int(x) for x in g.Ns],
            "Bs": [int(x) for x in g.Bs],
            "alphas": [int(x) for x in g.alphas]}


def _affine_json(e: Affine) -> dict:
    return {"terms": [[k, int(c)] for k, c in e.terms],
            "syms": [[k, int(c)] for k, c in e.syms],
            "const": int(e.const)}


def _affine_from_json(d: dict) -> Affine:
    return Affine(terms=tuple((k, int(c)) for k, c in d["terms"]),
                  syms=tuple((k, int(c)) for k, c in d["syms"]),
                  const=int(d["const"]))


def _delta_key(delta: Affine, N: int, B: int) -> str:
    return json.dumps([_affine_json(delta), int(N), int(B)],
                      sort_keys=True)


def _certify_groups(sol: BankingSolution, groups, duplicates: int):
    """The groups a solution must keep conflict-free, with labels.

    Mirrors the candidate space: a duplicated scheme serves each read
    subset from its own copy, so each subset (plus every write-bearing
    group) must be independently conflict-free.
    """
    if duplicates <= 1:
        return [(f"group{i}", g) for i, g in enumerate(groups)]
    read_groups = [g for g in groups if not any(a.is_write for a in g)]
    big = max(read_groups, key=len) if read_groups else None
    if big is None or len(big) < 2 * duplicates:
        raise CertificationError(
            f"scheme claims x{duplicates} duplication but no read group "
            f"is splittable {duplicates} ways")
    labeled = [(f"group{i}", g) for i, g in enumerate(groups) if g is not big]
    labeled += [(f"dup-subset{i}",
                 AccessGroup(list(big)[i::duplicates]))
                for i in range(duplicates)]
    return labeled


class ConflictCertificate:
    """Wrapper over the JSON certificate document."""

    def __init__(self, doc: dict):
        self.doc = doc

    @property
    def verdict(self) -> str:
        return self.doc.get("verdict", "")

    @property
    def signature(self) -> str:
        return self.doc.get("signature", "")

    def to_json(self) -> dict:
        return self.doc

    @classmethod
    def from_json(cls, doc: dict) -> "ConflictCertificate":
        return cls(doc)


@dataclass
class CertifyResult:
    ok: bool
    certificate: Optional[ConflictCertificate]
    counterexample: Optional[Counterexample]
    pairs_checked: int
    seconds: float
    reason: str = ""


def certify_solution(sol: BankingSolution, groups, iters,
                     *, signature: str = "", scorer: str = "",
                     enum_cap: int = _ENUM_CAP) -> CertifyResult:
    """Independently certify one scheme over its access groups.

    Returns a :class:`CertifyResult`: either ``ok`` with a
    machine-checkable certificate, or a counterexample -- the concrete
    env where more than ``ports`` accesses of one group collide (or, at
    minimum, a pair the scheme's edge set missed).
    """
    t0 = time.perf_counter()
    mem = sol.memory
    try:
        labeled = _certify_groups(sol, groups, sol.duplicates)
    except CertificationError as e:
        return CertifyResult(False, None, None, 0,
                             time.perf_counter() - t0, reason=str(e))
    proofs: Dict[str, dict] = {}
    group_docs = []
    pairs_checked = 0

    def decide(delta, N, B):
        key = _delta_key(delta, N, B)
        cached = proofs.get(key)
        if cached is not None:
            return cached["_decision"], key
        dec = decide_delta(delta, iters, N, B, enum_cap=enum_cap)
        proofs[key] = {
            "delta": _affine_json(delta), "N": int(N), "B": int(B),
            "conflict": dec.conflict, "M": dec.M,
            "subgroup": dec.subgroup,
            "partials_mod_d": list(dec.partials),
            "window_mod_d": list(dec.window),
            "method": dec.method, "_decision": dec,
        }
        return dec, key

    for label, group in labeled:
        accesses = list(group)
        edges = set()
        pair_docs = []
        for i, j in itertools.combinations(range(len(accesses)), 2):
            a, b = accesses[i], accesses[j]
            pairs_checked += 1
            if sol.kind == "flat":
                geo = sol.geometry
                delta = a.dot(geo.alpha) - b.dot(geo.alpha)
                dec, key = decide(delta, geo.N, geo.B)
                keys = [key]
                conflict = dec.conflict
            else:
                geo = sol.geometry
                conflict, keys = True, []
                for dim in range(len(geo.Ns)):
                    dd = (a.exprs[dim].scale(geo.alphas[dim])
                          - b.exprs[dim].scale(geo.alphas[dim]))
                    dec, key = decide(dd, geo.Ns[dim], geo.Bs[dim])
                    keys.append(key)
                    if not dec.conflict:
                        conflict = False
                        break
            if conflict:
                edges.add((i, j))
            pair_docs.append([i, j, keys, bool(conflict)])
        clique = _clique_lower_bound(len(accesses), edges)
        group_docs.append({
            "label": label, "n": len(accesses),
            "labels": [a.label or f"access{a.uid}" for a in accesses],
            "edges": sorted([list(e) for e in edges]),
            "pairs": pair_docs, "clique": clique,
        })
        if clique > mem.ports:
            # the scheme admits a conflict clique beyond the ports: dig
            # out one offending edge and build the concrete evidence
            u, v = min(edges)
            a, b = accesses[u], accesses[v]
            if sol.kind == "flat":
                delta = (a.dot(sol.geometry.alpha)
                         - b.dot(sol.geometry.alpha))
                dec, _ = decide(delta, sol.geometry.N, sol.geometry.B)
                env = dec.witness or {}
                residue = delta.evaluate(env) % max(dec.M, 1) \
                    if env else 0
                window = tuple(sorted({w % max(dec.M, 1)
                                       for w in range(-(sol.geometry.B - 1),
                                                      sol.geometry.B)}))
            else:
                env = {}
                for i2, j2, keys2, c2 in pair_docs:
                    if (i2, j2) == (u, v):
                        for key in keys2:
                            w_env = proofs[key]["_decision"].witness
                            if w_env:
                                env.update(w_env)
                residue, window = 0, (0,)
            cex = _counterexample(
                sol, label, a, b, iters, env, residue, window,
                note=(f"clique {clique} > ports {mem.ports} "
                      f"in {label}"))
            return CertifyResult(
                False, None, cex, pairs_checked,
                time.perf_counter() - t0,
                reason=f"conflict clique {clique} > {mem.ports} ports")

    for doc in proofs.values():
        doc.pop("_decision", None)
    cert = ConflictCertificate({
        "format": CERTIFICATE_FORMAT,
        "signature": signature, "scorer": scorer,
        "memory": mem.name, "ports": int(mem.ports),
        "dims": [int(d) for d in mem.dims],
        "kind": sol.kind, "duplicates": int(sol.duplicates),
        "geometry": _geometry_json(sol),
        "iterators": {name: {"start": it.start, "step": it.step,
                             "count": it.count}
                      for name, it in iters.items()},
        "groups": group_docs,
        "proofs": proofs,
        "pairs_checked": pairs_checked,
        "verdict": "certified",
        "created_at": time.time(),
    })
    return CertifyResult(True, cert, None, pairs_checked,
                         time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# Offline certificate checking (what `python -m repro_torch.analysis` runs)
# ---------------------------------------------------------------------------

def check_certificate(cert) -> Tuple[bool, str]:
    """Re-derive every residue proof of a certificate from scratch.

    Needs nothing but the certificate itself: rebuilds each pair delta,
    re-decides it, and re-checks the clique arithmetic against the
    recorded ports.  Returns (ok, reason).
    """
    doc = cert.doc if isinstance(cert, ConflictCertificate) else cert
    if doc.get("format") != CERTIFICATE_FORMAT:
        return False, f"unknown certificate format {doc.get('format')!r}"
    if doc.get("verdict") != "certified":
        return False, f"verdict is {doc.get('verdict')!r}"
    iters = {name: Iterator(name, start=d["start"], step=d["step"],
                            count=d["count"])
             for name, d in doc.get("iterators", {}).items()}
    for key, proof in doc.get("proofs", {}).items():
        delta = _affine_from_json(proof["delta"])
        dec = decide_delta(delta, iters, proof["N"], proof["B"])
        if dec.conflict != proof["conflict"]:
            return False, f"proof {key}: recorded conflict bit disagrees"
        if (dec.subgroup != proof["subgroup"]
                or list(dec.partials) != list(proof["partials_mod_d"])
                or list(dec.window) != list(proof["window_mod_d"])):
            return False, f"proof {key}: residue sets disagree"
        if not proof["conflict"]:
            touch = {p % proof["subgroup"]
                     for p in proof["partials_mod_d"]}
            if touch & set(proof["window_mod_d"]):
                return False, f"proof {key}: classes not disjoint"
    ports = int(doc.get("ports", 1))
    for g in doc.get("groups", []):
        edges = {tuple(e) for e in g["edges"]}
        for i, j, _keys, conflict in g["pairs"]:
            if conflict != ((i, j) in edges):
                return False, f"{g['label']}: edge list disagrees with pairs"
        clique = _clique_lower_bound(g["n"], edges)
        if clique != g["clique"]:
            return False, (f"{g['label']}: recorded clique {g['clique']} "
                           f"!= recomputed {clique}")
        if clique > ports:
            return False, (f"{g['label']}: clique {clique} exceeds "
                           f"{ports} ports")
    return True, "ok"


def certify_plan(plan, iters, *, scorer: str = "") -> CertifyResult:
    """Certify a plan's chosen scheme against its own access groups."""
    if plan.best is None:
        return CertifyResult(True, None, None, 0, 0.0,
                             reason="plan has no solution to certify")
    return certify_solution(plan.best, plan.groups, iters,
                            signature=plan.signature,
                            scorer=scorer or plan.scorer_name)


def make_batch_verifier(space):
    """Build the untrusted-result gate a :class:`SolveFabric` applies to
    every solution batch a remote worker streams back.

    Returns ``None`` to accept the batch, or the failing
    :class:`CertifyResult` (reason + counterexample) to reject it -- the
    fabric then drops the batch, requeues the unit away from that
    worker, and counts a ``cert_rejected``.
    """
    def verify(events):
        for ev in events:
            for sol in getattr(ev, "solutions", ()) or ():
                res = certify_solution(sol, space.groups, space.iters)
                if not res.ok:
                    return res
        return None
    return verify


def certificate_matches_plan(cert, plan) -> bool:
    """Does this certificate certify this plan's chosen scheme?"""
    doc = cert.doc if isinstance(cert, ConflictCertificate) else cert
    best = plan.best
    if best is None:
        return False
    if doc.get("signature") and plan.signature \
            and doc["signature"] != plan.signature:
        return False
    return doc.get("geometry") == _geometry_json(best)
