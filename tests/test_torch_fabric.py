# tests/test_fabric.py of the JAX package, run against repro_torch: the same
# cases on the port's fabric, its workers spawned as
# ``python -m repro_torch.launch.solve_worker``.
"""SolveFabric: remote shard workers over the localhost wire protocol.

Covers the wire codecs, the shard-equivalence matrix evaluated by real
worker subprocesses, the PlanService ``executor="fabric"`` backend for
1/2/4 workers (the acceptance matrix), worker-kill requeue
convergence, measurable cut-broadcast pruning, and the no-worker
fallbacks.
"""

import signal
import threading
import time

import pytest

from repro_torch.core import (CandidateSpace, PlanService,
                              SolutionReducer, SolveFabric, SolverOptions,
                              build_groups, rank_solutions, space_from_wire,
                              space_to_wire, spawn_local_workers, unroll)
from repro_torch.core import problems
from repro_torch.core.candidates import (evaluate, events_from_wire,
                                         events_to_wire, shard_from_indices)
from repro_torch.core.planner import BankingPlanner
from repro_torch.core.solver import solve_monolithic

APPS = ["sobel", "motion-lh", "sgd", "md_grid"]


def _problem(app):
    prog = problems.build(app)
    memname = list(prog.memories)[0]
    up = unroll(prog)
    return (prog.memories[memname], build_groups(up, memname),
            up.iterators)


def _key(s):
    return (s.kind, s.geometry, s.duplicates)


def _mono_winner(app):
    mem, groups, iters = _problem(app)
    return _key(rank_solutions(list(solve_monolithic(mem, groups,
                                                     iters)))[0])


class _Cluster:
    """A fabric plus n local worker subprocesses, cleaned up reliably."""

    def __init__(self, n, **kw):
        self.fabric = SolveFabric(**kw)
        self.procs = spawn_local_workers(self.fabric.address, n) if n else []
        if n:
            assert self.fabric.wait_for_workers(n, timeout=60), \
                f"{n} workers did not attach"

    def kill(self, i):
        self.procs[i].send_signal(signal.SIGKILL)

    def close(self):
        for p in self.procs:
            p.terminate()
        for p in self.procs:
            p.wait(timeout=10)
        self.fabric.shutdown()


@pytest.fixture
def cluster2():
    c = _Cluster(2, chunk=16)
    yield c
    c.close()


# ---------------------------------------------------------------------------
# Wire codecs
# ---------------------------------------------------------------------------


def test_wire_codecs_round_trip():
    """Space and event streams survive the wire byte-for-byte: a decoded
    space evaluates a leased work unit to identical results."""
    mem, groups, iters = _problem("motion-lh")
    space = CandidateSpace(mem, groups, iters, SolverOptions())
    far = space_from_wire(space_to_wire(space))
    assert far is not space and len(far) == len(space)
    idxs = list(range(0, min(64, len(space))))
    local = [(e.index, [_key(s) for s in e.solutions], e.valid_mask)
             for e in evaluate(shard_from_indices(space, idxs))]
    events = list(evaluate(shard_from_indices(far, idxs)))
    wired = events_from_wire(events_to_wire(events))
    remote = [(e.index, [_key(s) for s in e.solutions], e.valid_mask)
              for e in wired]
    assert remote == local


# ---------------------------------------------------------------------------
# CI smoke: one ticket end-to-end through 2 worker subprocesses
# ---------------------------------------------------------------------------


def test_fabric_smoke_one_ticket_end_to_end(cluster2):
    """A localhost fabric with 2 worker subprocesses solves one
    PlanService ticket end-to-end: remote leases, streamed results,
    cut broadcasts, and the exact monolithic winner."""
    svc = PlanService(workers=2, executor="fabric", fabric=cluster2.fabric)
    prog = problems.build("sobel")
    ticket = svc.submit(prog, list(prog.memories)[0])
    plan = ticket.result(timeout=120)
    assert plan.status == "solved"
    assert _key(plan.best) == _mono_winner("sobel")
    assert svc.stats.fabric_solves == 1 and svc.stats.fabric_fallbacks == 0
    assert svc.stats.fabric_leases > 0
    assert cluster2.fabric.stats.evaluated > 0   # work really went remote
    assert ticket.best_so_far() is plan.best     # progressive API intact


# ---------------------------------------------------------------------------
# Shard equivalence over the wire (the ISSUE acceptance matrix)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("app", APPS)
def test_two_worker_fabric_shard_equivalence_matrix(cluster2, app):
    """k in {1, 2, 4} work units evaluated by two remote workers merge
    to the identical solution list -- and the identical ranked winner --
    as the monolithic search (shard equivalence over the wire)."""
    mem, groups, iters = _problem(app)
    mono = solve_monolithic(mem, groups, iters)
    seen = set()
    mono_keys = [k for s in mono if (k := _key(s)) not in seen
                 and not seen.add(k)]
    winner = _key(rank_solutions(list(mono))[0])
    for k in (1, 2, 4):
        space = CandidateSpace(mem, groups, iters, SolverOptions())
        red = SolutionReducer(space)
        cluster2.fabric.solve(space, reducer=red,
                              chunk=max(1, -(-len(space) // k)))
        sols = red.finalize()
        assert [_key(s) for s in sols] == mono_keys, (app, k)
        assert _key(rank_solutions(list(sols))[0]) == winner, (app, k)


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_plan_service_fabric_executor_matches_monolithic(workers):
    """Acceptance: PlanService with executor="fabric" returns a
    plan identical to solve_monolithic() for every benchmark problem,
    regardless of worker count."""
    c = _Cluster(workers, chunk=16)
    try:
        svc = PlanService(workers=2, executor="fabric", fabric=c.fabric)
        for app in APPS:
            prog = problems.build(app)
            memname = list(prog.memories)[0]
            plan = svc.submit(prog, memname).result(timeout=120)
            assert _key(plan.best) == _mono_winner(app), (app, workers)
        assert svc.stats.fabric_solves == len(APPS)
    finally:
        c.close()


# ---------------------------------------------------------------------------
# Fault tolerance
# ---------------------------------------------------------------------------


def test_worker_kill_mid_solve_requeues_and_converges():
    """SIGKILLing a worker mid-solve requeues its leases (killed worker
    excluded) onto the surviving worker; the merged result still equals
    the monolithic winner."""
    c = _Cluster(2, chunk=8, lease_window=2)
    try:
        mem, groups, iters = _problem("sobel")
        space = CandidateSpace(mem, groups, iters, SolverOptions())
        red = SolutionReducer(space)
        done = {}

        def run():
            done["report"] = c.fabric.solve(space, reducer=red)

        t = threading.Thread(target=run)
        t.start()
        deadline = time.monotonic() + 60
        while (c.fabric.stats.results_frames < 1
               and time.monotonic() < deadline):
            time.sleep(0.001)
        assert c.fabric.stats.results_frames >= 1, "no results before kill"
        c.kill(0)
        t.join(timeout=120)
        assert not t.is_alive(), "solve hung after the worker died"
        assert c.fabric.stats.workers_lost >= 1
        winner = _key(rank_solutions(list(red.finalize()))[0])
        assert winner == _mono_winner("sobel")
    finally:
        c.close()


def test_no_workers_solves_locally():
    """A fabric with zero attached workers still converges: the driving
    thread evaluates orphan units itself."""
    fabric = SolveFabric(chunk=32)
    try:
        mem, groups, iters = _problem("sobel")
        space = CandidateSpace(mem, groups, iters, SolverOptions())
        red = SolutionReducer(space)
        report = fabric.solve(space, reducer=red)
        assert report.local_evaluated > 0 and report.leases == 0
        winner = _key(rank_solutions(list(red.finalize()))[0])
        assert winner == _mono_winner("sobel")
    finally:
        fabric.shutdown()


def test_per_ticket_executor_override(cluster2):
    """A pool-default service routes a single submit to the fabric via
    submit(executor="fabric") -- and rejects unknown executors."""
    svc = PlanService(workers=2, fabric=cluster2.fabric)   # default: pool
    prog = problems.build("sobel")
    memname = list(prog.memories)[0]
    plan = svc.submit(prog, memname, executor="fabric").result(timeout=120)
    assert _key(plan.best) == _mono_winner("sobel")
    assert svc.stats.fabric_solves == 1
    assert svc.stats.shards_spawned == 0       # the pool never fanned out
    with pytest.raises(ValueError, match="unknown executor"):
        svc.submit(prog, memname, executor="nope")
    with pytest.raises(ValueError, match="unknown executor"):
        PlanService(executor="nope")


def test_service_fabric_executor_falls_back_to_pool():
    """executor="fabric" with no fabric attached must not wedge: the
    in-process pool runs the solve and the fallback is counted."""
    svc = PlanService(workers=2, executor="fabric")
    prog = problems.build("sobel")
    plan = svc.submit(prog, list(prog.memories)[0]).result(timeout=60)
    assert _key(plan.best) == _mono_winner("sobel")
    assert svc.stats.fabric_fallbacks == 1 and svc.stats.fabric_solves == 0
    assert svc.stats.shards_spawned >= 1       # the pool really ran


# ---------------------------------------------------------------------------
# Cut broadcast
# ---------------------------------------------------------------------------


def test_cut_broadcast_reduces_evaluated_candidates():
    """With the cut protocol on, remote workers skip provably-dead
    candidates (dispatch filtering + mid-lease broadcast); without it
    they evaluate far more of the space for the same final answer."""
    mem, groups, iters = _problem("sobel")
    evaluated = {}
    for cuts in (True, False):
        c = _Cluster(1, chunk=16, lease_window=1, broadcast_cuts=cuts)
        try:
            space = CandidateSpace(mem, groups, iters, SolverOptions())
            red = SolutionReducer(space)
            report = c.fabric.solve(space, reducer=red)
            evaluated[cuts] = report.evaluated
            winner = _key(rank_solutions(list(red.finalize()))[0])
            assert winner == _mono_winner("sobel"), f"cuts={cuts}"
        finally:
            c.close()
    assert evaluated[True] < evaluated[False], evaluated
    assert c.fabric.stats.cut_broadcasts == 0   # really ran without cuts


# ---------------------------------------------------------------------------
# Adaptive per-ticket shard budgets (pool path)
# ---------------------------------------------------------------------------


def test_adaptive_budget_small_space_skips_fan_out():
    """With the default (adaptive) shard budget, a small candidate space
    solves as ONE shard -- no fan-out overhead -- while a larger space
    still fans out across the pool."""
    svc = PlanService(workers=4)          # shard_budget=None -> adaptive
    assert svc.shard_budget is None
    prog = problems.build("sobel")
    memname = list(prog.memories)[0]
    tiny = SolverOptions(max_solutions=4, n_budget=2, alpha_budget=2,
                         allow_multidim=False, allow_duplication=False)
    svc.submit(prog, memname, opts=tiny).result(timeout=60)
    assert svc.stats.adaptive_budgets == 1
    assert svc.stats.shards_spawned == 1   # small space: single shard
    svc.submit(prog, memname).result(timeout=60)   # full-size space
    assert svc.stats.adaptive_budgets == 2
    assert svc.stats.shards_spawned > 1    # big space: real fan-out


def test_suggested_shards_scales_with_enumeration():
    mem, groups, iters = _problem("sobel")
    space = CandidateSpace(mem, groups, iters, SolverOptions())
    assert space.suggested_shards(8) > 1
    assert space.suggested_shards(1) == 1
    tiny = CandidateSpace(mem, groups, iters,
                          SolverOptions(max_solutions=4, n_budget=2,
                                        alpha_budget=2,
                                        allow_multidim=False,
                                        allow_duplication=False))
    assert tiny.suggested_shards(8) == 1
    # explicit budgets still win over the adaptive default
    planner = BankingPlanner()
    svc = PlanService(planner=planner, workers=2, shard_budget=3)
    assert svc.shard_budget == 3


# ---------------------------------------------------------------------------
# Worker heartbeats
# ---------------------------------------------------------------------------


def test_worker_heartbeats_are_counted():
    """Real workers emit the lightweight hb frame on their own cadence
    (even while idle) and the fabric counts every one."""
    fabric = SolveFabric(chunk=16)
    procs = []
    try:
        procs = spawn_local_workers(fabric.address, 1, hb_interval=0.1)
        assert fabric.wait_for_workers(1, timeout=60)
        deadline = time.monotonic() + 30
        while fabric.stats.heartbeats < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert fabric.stats.heartbeats >= 3
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.wait(timeout=10)
        fabric.shutdown()


def test_heartbeat_timeout_drops_silent_worker_before_lease_timeout():
    """A worker that has spoken hb and then goes silent while holding a
    lease is dropped after ``hb_timeout`` -- NOT after the much longer
    lease timeout -- and its lease converges locally."""
    from repro_torch.core.fabric import read_frame, write_frame
    fabric = SolveFabric(chunk=64, hb_timeout=1.0, lease_timeout=300.0)
    sock = None
    try:
        import socket as socket_mod
        host, _, port = fabric.address.rpartition(":")
        sock = socket_mod.create_connection((host, int(port)))
        send_lock = threading.Lock()
        write_frame(sock, {"t": "join", "pid": 0, "host": "fake"},
                    send_lock)
        got_lease = threading.Event()

        def fake_worker():
            # hb once after the first lease, then total silence: the
            # fabric must not wait lease_timeout=300s for this one
            try:
                while True:
                    msg = read_frame(sock)
                    if msg.get("t") == "lease" and not got_lease.is_set():
                        write_frame(sock, {"t": "hb"}, send_lock)
                        got_lease.set()
            except Exception:
                pass

        threading.Thread(target=fake_worker, daemon=True).start()
        assert fabric.wait_for_workers(1, timeout=30)
        mem, groups, iters = _problem("sobel")
        space = CandidateSpace(mem, groups, iters, SolverOptions())
        red = SolutionReducer(space)
        t0 = time.monotonic()
        report = fabric.solve(space, reducer=red)
        wall = time.monotonic() - t0
        assert got_lease.is_set(), "fake worker never got a lease"
        assert wall < 60, f"hb drop did not beat lease_timeout ({wall=})"
        assert fabric.stats.heartbeats >= 1
        assert fabric.stats.workers_lost >= 1
        assert report.local_evaluated > 0     # orphan units ran locally
        winner = _key(rank_solutions(list(red.finalize()))[0])
        assert winner == _mono_winner("sobel")
    finally:
        fabric.shutdown()
        if sock is not None:
            sock.close()


def test_lease_cap_bounds_concurrent_leases(cluster2):
    """solve(lease_cap=1) never holds more than one lease in flight --
    the per-tenant fabric QoS knob -- and still converges exactly."""
    mem, groups, iters = _problem("sobel")
    space = CandidateSpace(mem, groups, iters, SolverOptions())
    red = SolutionReducer(space)
    report = cluster2.fabric.solve(space, reducer=red, chunk=8,
                                   lease_cap=1)
    assert report.peak_leases == 1
    assert report.leases > 1          # sequential leases, not one giant
    winner = _key(rank_solutions(list(red.finalize()))[0])
    assert winner == _mono_winner("sobel")
