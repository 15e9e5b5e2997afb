# tests/test_tenancy.py of the JAX package, run against repro_torch: the same
# cases on the port's plan plane (CPU tensors where a case builds a server).
"""Multi-tenant planning plane: QoS classes, admission control, fair
share (repro_torch.runtime.tenancy + PlanService integration).

Covers the FairShareQueue discipline (deterministic FIFO tie-break
within a band -- the regression the bare heap never guaranteed --
weighted stride interleave, strict band ordering), the
AdmissionController quota cycle (acquire -> defer -> shed -> release),
the service-level story (deferral is honest and the fallback still
executes; shed submits fail with a concrete AdmissionError, never a
silent drop; a saturating batch tenant cannot starve the interactive
band; QoS shard budgets cap fan-out), and the acceptance property that
``stats.for_tenant`` slices reconcile EXACTLY with the global counters
-- including under N threads submitting across 3 tenants on one shared
DirectoryStore.
"""

import itertools
import threading
import time

import numpy as np
import pytest
import torch  # noqa: F401  (fallback pack/gather import torch lazily;
# importing up front -- single-threaded, like the other suites -- keeps
# the first import away from live service worker threads)

from repro_torch.core import (AccessDecl, AdmissionError, BankingPlanner,
                        Counter, Ctrl, MemorySpec, PlanService, Program,
                        QoSClass, Sched, TenantRegistry)
from repro_torch.core.polytope import Affine
from repro_torch.core.store import DirectoryStore
from repro_torch.runtime.tenancy import (AdmissionController, FairShareQueue,
                                   QOS_CLASSES, resolve_qos)


_UID = itertools.count()


def _program(tag, i):
    """A unique banking problem per CALL: plan identity is structural
    (the memory name is excluded from the signature), so uniqueness
    comes from distinct memory dims.  Reuse the returned Program to get
    an intentional dedup / cache hit."""
    name = f"{tag}{i}"
    mem = MemorySpec(name, dims=(256 + 8 * next(_UID),), word_bits=32,
                     ports=1)
    return Program(
        root=Ctrl("reader", Sched.INNER,
                  counters=[Counter("i", 0, 1, 32, par=8)],
                  accesses=[AccessDecl(name, (Affine.of(i=1),))]),
        memories={name: mem},
    ), name


@pytest.fixture
def solve_gate(monkeypatch):
    """Blocks the FIRST cold solve until .set(); records memory names in
    claim order (the universal chokepoint every cold solve enters)."""
    gate = threading.Event()
    order = []
    real = BankingPlanner.build_space

    def gated(self, prep):
        order.append(prep.mem.name)
        if len(order) == 1:
            gate.wait(30)
        return real(self, prep)

    monkeypatch.setattr(BankingPlanner, "build_space", gated)
    gate.order = order
    yield gate
    gate.set()


@pytest.fixture
def slow_solves(monkeypatch):
    """Every cold solve takes >= 50 ms: quota windows become
    deterministic (submits are microseconds, slots release only when a
    solve really finishes)."""
    real = BankingPlanner.build_space

    def slowed(self, prep):
        time.sleep(0.05)
        return real(self, prep)

    monkeypatch.setattr(BankingPlanner, "build_space", slowed)


class _T:
    def __init__(self, tenant):
        self.tenant = tenant


# ---------------------------------------------------------------------------
# FairShareQueue discipline
# ---------------------------------------------------------------------------


def test_fifo_tie_break_within_band():
    """Regression: equal-priority entries of one tenant MUST
    drain in submit order -- the seq tie-break, not arbitrary heap
    order -- and a lower band always preempts a higher one."""
    q = FairShareQueue()
    t = _T("default")
    # interleave two bands; within each band, seq is the submit order
    q.put((1, 0, "b0", t))
    q.put((0, 1, "a0", t))
    q.put((1, 2, "b1", t))
    q.put((0, 3, "a1", t))
    q.put((0, 4, "a2", t))
    assert [q.get()[2] for _ in range(5)] == ["a0", "a1", "a2", "b0", "b1"]
    assert q.qsize() == 0


def test_weighted_stride_interleave_is_deterministic():
    """Within one band, a weight-3 tenant wins ~3 pops per weight-1 pop,
    with pass ties broken by head seq -- the exact drain order is
    reproducible."""
    reg = TenantRegistry()
    reg.register("heavy", QoSClass("heavy", weight=3.0))
    reg.register("light", QoSClass("light", weight=1.0))
    q = FairShareQueue(reg)
    th, tl = _T("heavy"), _T("light")
    seq = 0
    for i in range(6):
        q.put((0, seq, f"h{i}", th))
        seq += 1
    for i in range(2):
        q.put((0, seq, f"l{i}", tl))
        seq += 1
    pops = [q.get()[2] for _ in range(8)]
    assert pops == ["h0", "l0", "h1", "h2", "h3", "l1", "h4", "h5"]


def test_bands_are_strict_across_tenants():
    """An interactive-band entry drains before a batch-band one no
    matter the weights or push order."""
    reg = TenantRegistry()
    reg.register("vip", QOS_CLASSES["interactive"])
    reg.register("bulk", QOS_CLASSES["batch"])
    q = FairShareQueue(reg)
    bulk, vip = _T("bulk"), _T("vip")
    for i in range(3):           # bulk pushed FIRST, at its band 10
        q.put((10, i, f"bulk{i}", bulk))
    for i in range(2):
        q.put((0, 3 + i, f"vip{i}", vip))
    assert [q.get()[2] for _ in range(5)] == \
        ["vip0", "vip1", "bulk0", "bulk1", "bulk2"]


def test_idle_tenant_reactivates_at_the_pass_floor():
    """A long-idle tenant must not monopolize the queue on return: its
    pass re-enters at the active minimum, not at its stale zero."""
    reg = TenantRegistry()
    reg.register("a", QoSClass("a", weight=1.0))
    reg.register("b", QoSClass("b", weight=1.0))
    q = FairShareQueue(reg)
    ta, tb = _T("a"), _T("b")
    for i in range(4):
        q.put((0, i, f"a{i}", ta))
    assert [q.get()[2] for _ in range(3)] == ["a0", "a1", "a2"]
    q.put((0, 10, "b0", tb))     # b arrives late, pass floor = a's pass
    q.put((0, 11, "b1", tb))
    # equal passes now: FIFO on head seq alternates fairly, no b-burst
    assert q.get()[2] == "a3"
    assert [q.get()[2] for _ in range(2)] == ["b0", "b1"]


# ---------------------------------------------------------------------------
# AdmissionController quota cycle
# ---------------------------------------------------------------------------


def test_admission_quota_cycle():
    reg = TenantRegistry()
    reg.register("t", QoSClass("t", max_inflight=2, max_deferred=2))
    ac = AdmissionController(reg)
    assert ac.try_acquire("t") and ac.try_acquire("t")
    assert not ac.try_acquire("t")           # at max_inflight
    assert ac.defer("t", "a") and ac.defer("t", "b")
    assert not ac.defer("t", "c")            # backlog full: caller sheds
    assert ac.pending() == 2
    assert ac.release("t") == ["a"]          # oldest promoted, slot held
    assert ac.inflight("t") == 2 and ac.pending_for("t") == 1
    assert ac.release("t") == ["b"]
    assert ac.release("t") == [] and ac.pending() == 0


def test_default_tenant_is_unbounded():
    ac = AdmissionController(TenantRegistry())
    assert all(ac.try_acquire("default") for _ in range(100))
    assert resolve_qos("default").max_inflight is None
    with pytest.raises(ValueError, match="unknown QoS class"):
        resolve_qos("platinum")


# ---------------------------------------------------------------------------
# Service integration: bands, FIFO, deferral, shedding
# ---------------------------------------------------------------------------


def test_service_fifo_within_band_regression(solve_gate):
    """Equal-priority same-tenant submits are claimed in submit order."""
    svc = PlanService(workers=1)
    svc.submit(*_program("blk", 0))          # occupies the only worker
    while not solve_gate.order:
        time.sleep(0.001)
    tickets = [svc.submit(*_program("m", i)) for i in range(4)]
    solve_gate.set()
    for t in tickets:
        t.result(timeout=60)
    claimed = [n for n in solve_gate.order if n.startswith("m")]
    assert claimed == [f"m{i}" for i in range(4)]


def test_interactive_band_preempts_saturating_batch(solve_gate):
    """The starvation scenario: a batch tenant floods the queue first,
    yet every interactive solve is claimed before any batch solve."""
    reg = TenantRegistry()
    reg.register("fast", "interactive")
    reg.register("bulk", "batch")
    svc = PlanService(workers=1, tenants=reg)
    svc.submit(*_program("blk", 0))          # gate-blocked: queue builds
    while not solve_gate.order:
        time.sleep(0.001)
    bulk = [svc.submit(*_program("s", i), tenant="bulk") for i in range(3)]
    fast = [svc.submit(*_program("f", i), tenant="fast") for i in range(2)]
    solve_gate.set()
    for t in fast + bulk:
        t.result(timeout=60)
    order = solve_gate.order[1:]
    f_pos = [i for i, n in enumerate(order) if n.startswith("f")]
    s_pos = [i for i, n in enumerate(order) if n.startswith("s")]
    assert max(f_pos) < min(s_pos), order
    # the bands came from the QoS classes, not the callers
    assert all(t.priority == 0 for t in fast)
    assert all(t.priority == 10 for t in bulk)


def test_over_quota_submits_defer_honestly_and_still_serve(solve_gate):
    reg = TenantRegistry()
    reg.register("lim", QoSClass("lim", max_inflight=2))
    svc = PlanService(workers=1, tenants=reg)
    pairs = [_program("d", i) for i in range(5)]
    tickets = [svc.submit(p, m, tenant="lim") for p, m in pairs]
    deferred = [t for t in tickets if t.deferred]
    assert len(deferred) == 3 and svc.stats.deferred == 3
    t = deferred[0]
    assert t.status == "deferred" and not t.done()
    # deferral is honest, not a denial: the fallback executes NOW
    prog, mem = pairs[tickets.index(t)]
    n = prog.memories[mem].dims[0]
    fb = t.fallback(backend="numpy")
    flat = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    got = fb.gather(fb.pack(flat, device="cpu"), np.asarray([0, 3, n - 1]))
    np.testing.assert_array_equal(got, flat[[0, 3, n - 1]])
    solve_gate.set()
    for t in tickets:            # released solves run to completion
        assert t.result(timeout=60).status == "solved"
        assert not t.deferred
    s = svc.stats.for_tenant("lim")
    assert s.solved == 5 and s.deferred == 3 and s.queued == 5
    assert svc.stats.shed == 0


def test_full_backlog_sheds_with_concrete_error(solve_gate):
    reg = TenantRegistry()
    reg.register("tiny", QoSClass("tiny", max_inflight=1, max_deferred=1))
    svc = PlanService(workers=1, tenants=reg)
    t1 = svc.submit(*_program("x", 0), tenant="tiny")
    t2 = svc.submit(*_program("x", 1), tenant="tiny")
    t3 = svc.submit(*_program("x", 2), tenant="tiny")
    assert not t1.deferred and t2.deferred
    # never a silent drop: the shed ticket is done, loud, and specific
    assert t3.status == "shed" and t3.done()
    with pytest.raises(AdmissionError, match="over quota"):
        t3.result(timeout=1)
    fb = t3.fallback(backend="numpy")        # ...and still executable
    assert fb.n_banks == 1
    assert svc.stats.shed == 1
    solve_gate.set()
    assert t1.result(timeout=60).status == "solved"
    assert t2.result(timeout=60).status == "solved"


def test_dedup_upgrade_of_deferred_ticket_keeps_it_out_of_queue(
        solve_gate):
    """A higher-priority duplicate of a DEFERRED ticket must upgrade its
    priority without enqueueing it (it has no admission slot yet)."""
    reg = TenantRegistry()
    reg.register("lim", QoSClass("lim", max_inflight=1))
    svc = PlanService(workers=1, tenants=reg)
    svc.submit(*_program("y", 0), tenant="lim")      # holds the slot
    prog, mem = _program("y", 1)
    t2 = svc.submit(prog, mem, tenant="lim", priority=5)
    assert t2.deferred
    dup = svc.submit(prog, mem, tenant="lim", priority=-5)
    assert dup is t2 and t2.priority == -5 and t2.deferred
    assert svc.stats.deduped == 1
    solve_gate.set()
    assert t2.result(timeout=60).status == "solved"


def test_qos_shard_budget_caps_fan_out():
    """A capped tenant's cold solve may not fan across the whole pool;
    the same problem from the default tenant still does."""
    from repro_torch.core import problems
    reg = TenantRegistry()
    reg.register("capped", QoSClass("capped", shard_budget=1))
    svc = PlanService(workers=4, tenants=reg)
    prog = problems.build("sobel")
    memname = list(prog.memories)[0]
    svc.submit(prog, memname, use_cache=False,
               tenant="capped").result(timeout=60)
    assert svc.stats.for_tenant("capped").shards_spawned == 1
    svc.submit(prog, memname, use_cache=False).result(timeout=60)
    assert svc.stats.for_tenant("default").shards_spawned > 1


# ---------------------------------------------------------------------------
# Per-tenant stats slices reconcile exactly
# ---------------------------------------------------------------------------


def _assert_slices_reconcile(svc):
    g = svc.stats.as_dict()
    slices = g.pop("tenants", {})
    for k, v in g.items():
        total = sum(s.get(k, 0) for s in slices.values())
        assert v == total, f"{k}: global {v} != slice sum {total}"


def test_stats_slices_reconcile_over_mixed_workload():
    reg = TenantRegistry()
    reg.register("a", "interactive")
    reg.register("b", "batch")
    svc = PlanService(workers=2, tenants=reg)
    prog, mem = _program("w", 0)
    svc.submit(prog, mem, tenant="a").result(timeout=60)
    svc.submit(prog, mem, tenant="b").result(timeout=60)   # sync hit
    svc.submit(*_program("w", 1), tenant="b").result(timeout=60)
    svc.submit(*_program("w", 2)).result(timeout=60)       # default
    assert svc.stats.sync_hits == 1 and svc.stats.solved == 3
    assert svc.stats.for_tenant("b").sync_hits == 1
    _assert_slices_reconcile(svc)
    # as_dict stays JSON-serializable with the nested slices
    import json
    json.dumps(svc.stats.as_dict())


def test_concurrent_three_tenant_contention_on_shared_store(
        tmp_path, slow_solves):
    """N threads submitting across 3 tenants on ONE shared
    DirectoryStore -- quotas enforced, the high-QoS tenant not starved,
    per-tenant stats summing exactly to the global counters."""
    reg = TenantRegistry()
    reg.register("interactive", "interactive")
    reg.register("batch", "batch")
    reg.register("best_effort", "best_effort")
    store = DirectoryStore(tmp_path / "plans")
    svc = PlanService(store=store, workers=2, tenants=reg)
    counts = {"interactive": 3, "batch": 6, "best_effort": 4}
    tickets = {name: [] for name in counts}

    def submitter(name, n):
        for i in range(n):
            tickets[name].append(
                svc.submit(*_program(name[0], i), tenant=name))

    threads = [threading.Thread(target=submitter, args=(n, k))
               for n, k in counts.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, ts in tickets.items():
        for t in ts:
            assert t.result(timeout=120).status == "solved", name
    assert svc.drain(timeout=120)
    # quota enforcement: best_effort (max_inflight=2) submitted 4 solves
    # in microseconds against >=50ms solves -- it MUST have deferred
    be = svc.stats.for_tenant("best_effort")
    assert be.deferred >= 1 and be.solved == 4 and be.shed == 0
    # no starvation: every interactive solve landed before the batch
    # flood finished (strict band ordering under saturation)
    last = {name: max(t.resolved_at for t in ts)
            for name, ts in tickets.items()}
    assert last["interactive"] < last["batch"]
    _assert_slices_reconcile(svc)
    # one shared store really served the whole fleet
    assert svc.planner.store is store


# ---------------------------------------------------------------------------
# CI smoke: 2 tenants, saturated queue, no starvation (fast)
# ---------------------------------------------------------------------------


def test_smoke_two_tenant_saturation_no_starvation(slow_solves):
    """CI smoke: one noisy batch tenant saturates a 1-worker service;
    the interactive tenant's submits all resolve before the flood's
    last, and the stats slices reconcile."""
    reg = TenantRegistry()
    reg.register("vip", "interactive")
    reg.register("noisy", "batch")
    svc = PlanService(workers=1, tenants=reg)
    flood = [svc.submit(*_program("n", i), tenant="noisy")
             for i in range(5)]
    vips = [svc.submit(*_program("v", i), tenant="vip") for i in range(2)]
    for t in vips + flood:
        assert t.result(timeout=120).status == "solved"
    assert (max(t.resolved_at for t in vips)
            < max(t.resolved_at for t in flood))
    _assert_slices_reconcile(svc)
