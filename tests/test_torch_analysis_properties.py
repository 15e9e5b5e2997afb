# tests/test_analysis_properties.py of the JAX package, run against repro_torch: the same
# cases on the port's plan plane (CPU tensors where a case builds a server).
"""Property tests: the conflict-window oracle ``delta_can_hit_window``
(the solver's sumset DP) and the certifier's independent
``decide_delta`` both agree with *brute-force enumeration* of reachable
residues over randomized affine access pairs -- bounded, unbounded, and
undeclared iterators, plus uninterpreted ``Sym`` terms that cancel (or
fail to cancel) in deltas."""

import pytest

pytest.importorskip(
    "hypothesis", reason="property tests need hypothesis (pip install -r requirements-dev.txt)")
from hypothesis import assume, given, settings, strategies as st

from repro_torch.analysis import decide_delta
from repro_torch.core.polytope import Affine, Iterator, delta_can_hit_window


def brute_force_conflict(delta, iters, N, B):
    """Ground truth by exhaustive residue enumeration: every generator's
    value set is walked outright (period of any term divides M, so M
    steps always suffice), no subgroup/sumset shortcuts."""
    M = N * B
    if M <= 1:
        return True
    residues = {delta.const % M}
    for name, coeff in delta.terms:
        it = iters.get(name)
        if it is None:                       # undeclared: any integer
            vals = range(M)
        elif it.count is None:               # unbounded counter
            vals = [it.start + it.step * t for t in range(M)]
        else:
            vals = [it.start + it.step * t for t in range(it.count)]
        residues = {(r + coeff * v) % M for r in residues for v in vals}
    for _, coeff in delta.syms:              # uninterpreted: any integer
        residues = {(r + coeff * v) % M
                    for r in residues for v in range(M)}
    if B == 1:
        return 0 in residues
    return any(r <= B - 1 or r >= M - B + 1 for r in residues)


_coeff = st.integers(-5, 5).filter(lambda c: c != 0)


@st.composite
def delta_cases(draw):
    N = draw(st.integers(1, 8))
    B = draw(st.sampled_from([1, 2, 3, 4]))
    assume(N * B <= 16)
    terms, iters = [], {}
    for t in range(draw(st.integers(0, 3))):
        name = f"i{t}"
        terms.append((name, draw(_coeff)))
        kind = draw(st.sampled_from(["bounded", "unbounded", "missing"]))
        if kind == "bounded":
            iters[name] = Iterator(name, draw(st.integers(-3, 3)),
                                   draw(st.integers(1, 3)),
                                   draw(st.integers(1, 6)))
        elif kind == "unbounded":
            iters[name] = Iterator(name, draw(st.integers(-3, 3)),
                                   draw(st.integers(1, 3)), None)
    syms = ()
    if draw(st.booleans()):
        syms = (("f(i)@site", draw(_coeff)),)
    delta = Affine(terms=tuple(terms), syms=syms,
                   const=draw(st.integers(-8, 8)))
    return delta, iters, N, B


@settings(max_examples=40, deadline=None)
@given(delta_cases())
def test_oracle_matches_brute_force(case):
    delta, iters, N, B = case
    want = brute_force_conflict(delta, iters, N, B)
    assert bool(delta_can_hit_window(delta, iters, N, B)) == want


@settings(max_examples=40, deadline=None)
@given(delta_cases())
def test_certifier_decision_matches_brute_force(case):
    """The certifier's independent lattice/residue path reaches the same
    verdict as exhaustive enumeration -- so solver and certifier can
    only agree on the truth, not on a shared bug."""
    delta, iters, N, B = case
    want = brute_force_conflict(delta, iters, N, B)
    dec = decide_delta(delta, iters, N, B)
    assert dec.conflict == want
    if dec.conflict and dec.witness is not None:
        M = N * B
        r = delta.evaluate(dec.witness) % M
        assert M <= 1 or r <= B - 1 or r >= M - B + 1


@st.composite
def access_pairs(draw):
    """Two affine accesses over shared iterators; the pair shares a Sym
    whose coefficients either match (cancels in the delta) or differ
    (a residual uninterpreted term survives)."""
    iters = {}
    for t in range(draw(st.integers(1, 2))):
        name = f"i{t}"
        count = draw(st.one_of(st.none(), st.integers(1, 6)))
        iters[name] = Iterator(name, draw(st.integers(-2, 2)),
                               draw(st.integers(1, 3)), count)

    def expr():
        terms = tuple((n, draw(st.integers(-4, 4)))
                      for n in iters if draw(st.booleans()))
        return Affine(terms=tuple((n, c) for n, c in terms if c),
                      const=draw(st.integers(-5, 5)))

    ca = draw(_coeff)
    cancels = draw(st.booleans())
    cb = ca if cancels else draw(_coeff.filter(lambda c: c != ca))
    a = expr().with_sym("Q(x)@0", ca)
    b = expr().with_sym("Q(x)@0", cb)
    N = draw(st.integers(1, 6))
    B = draw(st.sampled_from([1, 2, 3]))
    assume(N * B <= 12)
    return a, b, cancels, iters, N, B


@settings(max_examples=40, deadline=None)
@given(access_pairs())
def test_access_pair_deltas_cancel_syms_and_match_brute_force(pair):
    a, b, cancels, iters, N, B = pair
    delta = a - b
    # same key, same coefficient: the unknown value cancels exactly
    assert (delta.syms == ()) == cancels
    want = brute_force_conflict(delta, iters, N, B)
    assert bool(delta_can_hit_window(delta, iters, N, B)) == want
    assert decide_delta(delta, iters, N, B).conflict == want
