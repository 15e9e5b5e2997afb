# tests/test_analysis.py of the JAX package, run against repro_torch: the same
# cases on the port's plan plane (CPU tensors where a case builds a server).
"""Static verification layer: independent conflict-freedom certifier,
Program lint pass, and result-batch checking.

The certifier re-decides every access pair of a finished scheme via a
separate decision path (bounded lattice enumeration + residue-witness
sets), so a bug in the solver's sumset DP cannot vouch for itself.
Covers: certifier/solver agreement over benchmark problems, concrete
counterexamples from corrupted schemes (auto-rendered as pytest cases),
machine-checked certificate round-trips, the lint diagnostics, store
certificate sidecars + hydrate re-verification, PlanService verify
modes, and the adversarial fabric worker whose forged solutions the
batch verifier refuses.
"""

import dataclasses
import json
import os
import queue
import socket
import threading

import numpy as np
import pytest

from repro_torch.analysis import (CertificationError, LintError,
                            certificate_matches_plan, certify_plan,
                            certify_solution, check_certificate,
                            decide_delta, lint_program, make_batch_verifier)
from repro_torch.analysis.certify import ConflictCertificate
from repro_torch.core import (AccessDecl, Counter, Ctrl, MemorySpec,
                              PlanService, Program, Sched, SolveFabric,
                              build_groups, problems, rank_solutions, unroll)
from repro_torch.core.candidates import (evaluate, events_to_wire,
                                         shard_from_indices, space_from_wire)
from repro_torch.core.fabric import read_frame, write_frame
from repro_torch.core.planner import BankingPlanner
from repro_torch.core.polytope import Affine, Iterator, delta_can_hit_window
from repro_torch.core.solver import solve_monolithic
from repro_torch.core.store import DirectoryStore, MemoryStore

# flat, duplication-split, and multidim certification paths
APPS = ["denoise", "sobel", "sgd"]


def _key(s):
    return (s.kind, s.geometry, s.duplicates)


def _problem(app):
    prog = problems.build(app)
    memname = list(prog.memories)[0]
    up = unroll(prog)
    return prog, memname, up


# ---------------------------------------------------------------------------
# The independent pair decision vs the solver's oracle
# ---------------------------------------------------------------------------


def test_decide_delta_matches_oracle_randomized():
    """decide_delta (lattice/residue path) agrees with the solver's
    sumset-DP oracle on randomized deltas mixing bounded, unbounded,
    and undeclared iterators plus uninterpreted syms -- and every
    conflict verdict carries a witness that lands in the window."""
    rng = np.random.default_rng(7)
    for trial in range(400):
        n_terms = int(rng.integers(0, 4))
        terms, iters = [], {}
        for t in range(n_terms):
            name = f"i{t}"
            coeff = int(rng.integers(-5, 6))
            if coeff == 0:
                coeff = 1
            terms.append((name, coeff))
            kind = rng.integers(0, 3)
            if kind == 0:      # bounded
                iters[name] = Iterator(name, int(rng.integers(-3, 4)),
                                       int(rng.integers(1, 4)),
                                       int(rng.integers(1, 7)))
            elif kind == 1:    # unbounded (data-dependent count)
                iters[name] = Iterator(name, int(rng.integers(-3, 4)),
                                       int(rng.integers(1, 4)), None)
            # kind == 2: undeclared -- the oracle treats it as free
        syms = ()
        if rng.integers(0, 3) == 0:
            syms = (("q@site", int(rng.integers(-3, 4)) or 1),)
        delta = Affine(terms=tuple(terms), syms=syms,
                       const=int(rng.integers(-8, 9)))
        N = int(rng.integers(1, 9))
        B = int(rng.choice([1, 1, 2, 3, 4]))
        oracle = bool(delta_can_hit_window(delta, iters, N, B))
        dec = decide_delta(delta, iters, N, B)
        assert dec.conflict == oracle, (trial, delta, iters, N, B)
        if dec.conflict and dec.witness is not None:
            M = N * B
            r = delta.evaluate(dec.witness) % M
            assert r <= B - 1 or r >= M - B + 1, (trial, dec.witness)


def test_decide_delta_witness_set_fallback_agrees():
    """Forcing the witness-set fold (enum_cap too small for the lattice
    product) must not change any verdict."""
    rng = np.random.default_rng(11)
    for trial in range(150):
        iters = {
            "a": Iterator("a", 0, 1, int(rng.integers(2, 7))),
            "b": Iterator("b", int(rng.integers(-2, 3)), 2,
                          int(rng.integers(2, 7))),
        }
        delta = Affine(terms=(("a", int(rng.integers(1, 5))),
                              ("b", -int(rng.integers(1, 5)))),
                       const=int(rng.integers(-4, 5)))
        N, B = int(rng.integers(1, 7)), int(rng.choice([1, 2, 3]))
        full = decide_delta(delta, iters, N, B)
        folded = decide_delta(delta, iters, N, B, enum_cap=2)
        assert full.conflict == folded.conflict, (trial, delta, N, B)


# ---------------------------------------------------------------------------
# Certifier vs solver over the benchmark suite
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("app", APPS)
def test_certifier_agrees_with_solver(app):
    """Every solver-chosen scheme certifies with zero disagreements,
    the emitted certificate re-checks, and it matches its plan."""
    prog, memname, up = _problem(app)
    plan = BankingPlanner().plan(prog, memname, use_cache=False)
    res = certify_plan(plan, up.iterators)
    assert res.ok, f"{app}: {res.reason}"
    assert res.pairs_checked > 0
    ok, why = check_certificate(res.certificate)
    assert ok, f"{app}: {why}"
    assert certificate_matches_plan(res.certificate, plan)
    # serialization round-trip preserves checkability
    wire = json.loads(json.dumps(res.certificate.to_json()))
    ok, why = check_certificate(ConflictCertificate(wire))
    assert ok, why


def test_corrupted_scheme_yields_counterexample(render_counterexample):
    """A deliberately corrupted scheme (forged down to one bank) must
    come back with a concrete two-point counterexample -- which renders
    and passes as a standalone pytest case."""
    prog, memname, up = _problem("sobel")
    plan = BankingPlanner().plan(prog, memname, use_cache=False)
    forged = dataclasses.replace(
        plan.best,
        geometry=dataclasses.replace(plan.best.geometry, N=1, B=1))
    res = certify_solution(forged, plan.groups, up.iterators)
    assert not res.ok and res.counterexample is not None
    cex = res.counterexample
    assert cex.x1 != cex.x2 or cex.a_label != cex.b_label
    assert "bank" in cex.describe() or "window" in cex.describe()
    path = render_counterexample(cex, name="test_sobel_forged_one_bank")
    assert path.exists()


def test_certificate_tampering_detected():
    """check_certificate refuses a certificate whose proofs, edges, or
    clique no longer match a fresh re-decision."""
    prog, memname, up = _problem("denoise")
    plan = BankingPlanner().plan(prog, memname, use_cache=False)
    good = certify_plan(plan, up.iterators).certificate

    # flip one proof's verdict
    doc = json.loads(json.dumps(good.to_json()))
    key = next(iter(doc["proofs"]))
    doc["proofs"][key]["conflict"] = not doc["proofs"][key]["conflict"]
    ok, why = check_certificate(ConflictCertificate(doc))
    assert not ok

    # understate a group's clique
    doc = json.loads(json.dumps(good.to_json()))
    doc["groups"][0]["clique"] = 0
    ok, why = check_certificate(ConflictCertificate(doc))
    assert not ok

    # a tampered geometry no longer matches the plan
    doc = json.loads(json.dumps(good.to_json()))
    doc["geometry"]["N"] = 1
    assert not certificate_matches_plan(ConflictCertificate(doc), plan)


# ---------------------------------------------------------------------------
# Program lint
# ---------------------------------------------------------------------------


def _mk_program(counters, accesses, dims=(64,), ports=2):
    mem = MemorySpec("buf", dims, 32, ports=ports)
    root = Ctrl("main", Sched.INNER, counters=counters, accesses=accesses)
    return Program(root=root, memories={"buf": mem})


def test_lint_flags_out_of_bounds_access():
    prog = _mk_program(
        [Counter("x", 0, 1, 16, par=2)],
        [AccessDecl("buf", (Affine.of(x=1),), label="r0")], dims=(8,))
    report = lint_program(prog, "buf")
    assert not report.ok
    assert any(d.code == "oob-access" for d in report.errors)


def test_lint_flags_degenerate_counters():
    prog = _mk_program(
        [Counter("x", 0, 0, 4, par=2), Counter("y", 0, 1, 0)],
        [AccessDecl("buf", (Affine.of(x=1),))])
    codes = [d.code for d in lint_program(prog, "buf").errors]
    assert codes.count("degenerate-counter") >= 2


def test_lint_flags_sym_collision_across_call_sites():
    inner_a = Ctrl("site_a", Sched.INNER,
                   counters=[Counter("i", 0, 1, 4, par=2)],
                   accesses=[AccessDecl(
                       "buf", (Affine.of(i=1).with_sym("q"),))])
    inner_b = Ctrl("site_b", Sched.INNER,
                   counters=[Counter("j", 0, 1, 4, par=2)],
                   accesses=[AccessDecl(
                       "buf", (Affine.of(j=1).with_sym("q"),))])
    mem = MemorySpec("buf", (64,), 32, ports=2)
    root = Ctrl("main", Sched.SEQUENTIAL, children=[inner_a, inner_b])
    prog = Program(root=root, memories={"buf": mem})
    report = lint_program(prog, "buf")
    assert any(d.code == "sym-collision" for d in report.errors)


def test_lint_flags_port_oversubscription():
    """ports-many identical write addresses per cycle: no geometry can
    separate them -- error; identical reads only warn (duplication)."""
    writes = [AccessDecl("buf", (Affine.of(x=1),), is_write=True,
                         label=f"w{k}") for k in range(3)]
    prog = _mk_program([Counter("x", 0, 1, 8, par=1)], writes, ports=1)
    report = lint_program(prog, "buf")
    assert any(d.code == "port-oversubscription" for d in report.errors)
    reads = [AccessDecl("buf", (Affine.of(x=1),), label=f"r{k}")
             for k in range(3)]
    prog = _mk_program([Counter("x", 0, 1, 8, par=1)], reads, ports=1)
    report = lint_program(prog, "buf")
    assert report.ok
    assert any(d.code == "port-oversubscription" for d in report.warnings)


def test_lint_clean_on_benchmark_programs():
    for app in APPS:
        prog, memname, _ = _problem(app)
        assert lint_program(prog, memname).ok, app


# ---------------------------------------------------------------------------
# Store: certificate sidecars + hydrate re-verification
# ---------------------------------------------------------------------------


def test_memory_store_certificate_round_trip():
    store = MemoryStore()
    assert store.get_certificate("sig", "s") is None
    store.put_certificate("sig", "s", {"verdict": "certified"})
    assert store.get_certificate("sig", "s")["verdict"] == "certified"


def test_directory_store_certificates_and_hydrate_verify(tmp_path):
    prog, memname, up = _problem("denoise")
    store = DirectoryStore(tmp_path)
    planner = BankingPlanner(store=store)
    plan = planner.plan(prog, memname)
    res = certify_plan(plan, up.iterators)
    store.put_certificate(plan.signature, plan.scorer_name,
                          res.certificate.to_json())
    assert store.certificate_path(plan.signature,
                                  plan.scorer_name).exists()

    # an armed fresh store serves the plan only because the cert checks
    armed = DirectoryStore(tmp_path, verify_hydrated=True)
    assert armed.get(plan.signature, plan.scorer_name) is not None

    # tampering with the certificate turns the entry into a miss
    p = armed.certificate_path(plan.signature, plan.scorer_name)
    doc = json.loads(p.read_text())
    doc["geometry"]["N"] = 1
    p.write_text(json.dumps(doc))
    assert DirectoryStore(tmp_path, verify_hydrated=True).get(
        plan.signature, plan.scorer_name) is None

    # no certificate at all: an armed store refuses, a relaxed one serves
    p.unlink()
    assert DirectoryStore(tmp_path, verify_hydrated=True).get(
        plan.signature, plan.scorer_name) is None
    assert DirectoryStore(tmp_path).get(
        plan.signature, plan.scorer_name) is not None

    # delete removes the sidecar with the plan
    store.put_certificate(plan.signature, plan.scorer_name,
                          res.certificate.to_json())
    store.delete(plan.signature, plan.scorer_name)
    assert not store.certificate_path(plan.signature,
                                      plan.scorer_name).exists()


# ---------------------------------------------------------------------------
# PlanService verify modes
# ---------------------------------------------------------------------------


def test_service_verify_store_certifies_and_persists(tmp_path):
    prog, memname, _ = _problem("denoise")
    store = DirectoryStore(tmp_path)
    svc = PlanService(store=store, workers=2, verify="store")
    assert store.verify_hydrated     # armed store refuses uncertified
    try:
        plan = svc.submit(prog, memname).result(timeout=120)
        assert svc.stats.certified == 1 and svc.stats.cert_failures == 0
        cert = store.get_certificate(plan.signature, plan.scorer_name)
        assert cert is not None and cert["verdict"] == "certified"
        ok, why = check_certificate(ConflictCertificate(cert))
        assert ok, why
    finally:
        svc.shutdown()


def test_service_lint_gate_refuses_bad_program():
    prog = _mk_program(
        [Counter("x", 0, 1, 16, par=2)],
        [AccessDecl("buf", (Affine.of(x=1),), label="r0")], dims=(8,))
    svc = PlanService(workers=1, verify="store")
    try:
        with pytest.raises(LintError) as exc:
            svc.submit(prog, "buf")
        assert not exc.value.report.ok
        assert svc.stats.lint_errors == 1
        # per-submit opt-out still solves the (conflict-clean) program
        svc.submit(prog, "buf", verify="off").result(timeout=60)
    finally:
        svc.shutdown()


def test_service_rejects_unknown_verify_mode():
    with pytest.raises(ValueError, match="unknown verify mode"):
        PlanService(verify="sometimes")
    svc = PlanService(workers=1)
    try:
        prog, memname, _ = _problem("denoise")
        with pytest.raises(ValueError, match="unknown verify mode"):
            svc.submit(prog, memname, verify="sometimes")
    finally:
        svc.shutdown()


def test_service_cert_failure_aborts_caching(monkeypatch, tmp_path):
    """A certification failure surfaces through the ticket AND keeps the
    refused plan out of every cache layer."""
    from repro_torch.analysis import certify as certify_mod
    from repro_torch.analysis.certify import CertifyResult

    def refuse(plan, iters, **kw):
        return CertifyResult(False, None, None, 1, 0.0,
                             reason="forced refusal")

    monkeypatch.setattr(certify_mod, "certify_plan", refuse)
    prog, memname, _ = _problem("denoise")
    store = DirectoryStore(tmp_path)
    svc = PlanService(store=store, workers=1, verify="store")
    try:
        ticket = svc.submit(prog, memname)
        with pytest.raises(CertificationError, match="forced refusal"):
            ticket.result(timeout=120)
        assert svc.stats.cert_failures == 1
        assert store.get(ticket.signature, ticket.scorer_name) is None
        assert svc.planner.lookup(ticket._prep) is None
    finally:
        svc.shutdown()


# ---------------------------------------------------------------------------
# Untrusted fabric: adversarial worker injecting forged solutions
# ---------------------------------------------------------------------------


def _run_malicious_worker(address):
    """Speaks the real worker wire protocol but corrupts every solution
    it streams back: geometry forged to a single bank and the score
    forced to -1e9, so an unchecked reducer would crown a colliding
    scheme the winner."""
    host, _, port = address.rpartition(":")
    sock = socket.create_connection((host or "127.0.0.1", int(port)))
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    send_lock = threading.Lock()
    write_frame(sock, {"t": "join", "pid": os.getpid(), "host": "evil"},
                send_lock)
    spaces, leases = {}, queue.Queue()

    def reader():
        try:
            while True:
                msg = read_frame(sock)
                t = msg.get("t")
                if t == "space":
                    spaces[msg["solve_id"]] = space_from_wire(msg["payload"])
                elif t == "lease":
                    leases.put(msg)
                elif t == "shutdown":
                    break
        except Exception:
            pass
        finally:
            leases.put(None)

    threading.Thread(target=reader, daemon=True).start()
    while True:
        msg = leases.get()
        if msg is None:
            break
        sid, lid = msg["solve_id"], msg["lease_id"]
        space = spaces.get(sid)
        try:
            if space is None:
                write_frame(sock, {"t": "error", "lease_id": lid,
                                   "error": "no space"}, send_lock)
                continue
            shard = shard_from_indices(space, msg["indices"])
            batch = []
            for ev in evaluate(shard):
                forged = []
                for sol in ev.solutions:
                    if sol.kind == "flat":
                        g = dataclasses.replace(sol.geometry, N=1, B=1)
                        forged.append(dataclasses.replace(
                            sol, geometry=g, score=-1e9, note="forged"))
                    else:
                        forged.append(dataclasses.replace(
                            sol, score=-1e9, note="forged"))
                batch.append(dataclasses.replace(ev, solutions=forged))
            write_frame(sock, {"t": "results", "lease_id": lid,
                               "payload": events_to_wire(batch)}, send_lock)
            write_frame(sock, {"t": "done", "lease_id": lid,
                               "evaluated": len(batch)}, send_lock)
        except OSError:
            break
    try:
        sock.close()
    except OSError:
        pass


def test_adversarial_fabric_worker_is_rejected_and_solve_converges():
    """Acceptance: a fabric solve with an adversarial worker
    injecting bogus solutions still converges to the exact monolithic
    answer, with ServiceStats.cert_rejected > 0 -- forged batches are
    refused by the certifier gate, their units requeued away from the
    sender and evaluated locally."""
    prog, memname, up = _problem("sobel")
    mono = _key(rank_solutions(list(solve_monolithic(
        prog.memories[memname], build_groups(up, memname),
        up.iterators)))[0])

    fabric = SolveFabric(chunk=32)
    t = threading.Thread(target=_run_malicious_worker,
                         args=(fabric.address,), daemon=True)
    t.start()
    assert fabric.wait_for_workers(1, timeout=30)
    svc = PlanService(workers=2, executor="fabric", fabric=fabric,
                      verify="all")
    try:
        plan = svc.submit(prog, memname).result(timeout=240)
        assert _key(plan.best) == mono, \
            "forged solutions corrupted the solve"
        assert svc.stats.cert_rejected > 0
        assert fabric.stats.cert_rejected > 0
        assert fabric.stats.local_evaluated > 0   # orphans ran locally
        assert svc.stats.certified == 1           # final plan certified
        assert plan.best.note != "forged"
    finally:
        svc.shutdown()
        fabric.shutdown()


def test_batch_verifier_accepts_honest_events():
    """make_batch_verifier passes genuinely evaluated batches through
    untouched (returns None) and refuses forged ones."""
    prog, memname, up = _problem("denoise")
    from repro_torch.core import CandidateSpace
    from repro_torch.core.solver import SolverOptions
    space = CandidateSpace(prog.memories[memname],
                           build_groups(up, memname), up.iterators,
                           SolverOptions())
    verify = make_batch_verifier(space)
    honest = list(evaluate(shard_from_indices(
        space, list(range(min(16, len(space)))))))
    assert verify(honest) is None
    forged = []
    for ev in honest:
        if ev.solutions:
            sol = ev.solutions[0]
            if sol.kind != "flat":
                continue
            g = dataclasses.replace(sol.geometry, N=1, B=1)
            forged.append(dataclasses.replace(
                ev, solutions=[dataclasses.replace(sol, geometry=g)]))
    assert forged, "expected at least one flat solution to forge"
    res = verify(forged)
    assert res is not None and not res.ok
