# tests/test_service.py of the JAX package, run against repro_torch: the same
# cases on the port's plan plane (CPU tensors where a case builds a server).
"""PlanService front door: submit -> ticket -> compile -> execute, warm
stores answering before the ticket returns, fallback-first serving with
hot-swap, stale-while-revalidate, priority, dedup, error propagation."""

import dataclasses
import threading

import numpy as np
import pytest

from repro_torch.core import (AccessDecl, BankingPlanner, Counter, Ctrl,
                        MemorySpec, PlanService, Program, Sched,
                        SolverOptions, StaleWhileRevalidate)
from repro_torch.core.polytope import Affine
from repro_torch.core.store import DirectoryStore


def _reader_program(stride=1, count=32, par=8, dims=(256,), name="table"):
    mem = MemorySpec(name, dims=dims, word_bits=32, ports=1)
    return Program(
        root=Ctrl("reader", Sched.INNER,
                  counters=[Counter("i", 0, 1, count, par=par)],
                  accesses=[AccessDecl(name, (Affine.of(i=stride),))]),
        memories={name: mem},
    )


@pytest.fixture
def solve_counter(monkeypatch):
    """Counts cold solves at the universal chokepoint: every path about
    to do solver work (sharded service workers, blocking plan()) starts
    by enumerating its candidate space via BankingPlanner.build_space."""
    calls = []
    real = BankingPlanner.build_space

    def counting(self, prep):
        calls.append(1)
        return real(self, prep)

    monkeypatch.setattr(BankingPlanner, "build_space", counting)
    return calls


@pytest.fixture
def solve_gate(monkeypatch):
    """Blocks the FIRST cold solve until .set(); records memory names."""
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
    gate.set()   # never leave a worker blocked past the test


# ---------------------------------------------------------------------------
# Ticket lifecycle
# ---------------------------------------------------------------------------


def test_submit_returns_ticket_and_fallback_before_solve(solve_gate):
    svc = PlanService(workers=1)
    ticket = svc.submit(_reader_program(), "table")
    assert not ticket.done() and ticket.status in ("queued", "solving")
    # fallback is available immediately: trivial single-bank scheme
    fb = ticket.fallback(backend="numpy")
    assert fb.n_banks == 1 and fb.layout.logical_size == 256
    flat = np.arange(256 * 4, dtype=np.float32).reshape(256, 4)
    got = fb.gather(fb.pack(flat, device="cpu"), np.asarray([0, 5, 255]))
    np.testing.assert_array_equal(got, flat[[0, 5, 255]])
    solve_gate.set()
    plan = ticket.result(timeout=30)
    assert plan.status == "solved" and ticket.done()
    art = ticket.artifact(backend="numpy")
    assert art.n_banks == plan.best.num_banks
    # solved ticket's fallback IS the solved artifact now
    assert ticket.fallback(backend="numpy").n_banks == art.n_banks


def test_result_timeout_raises(solve_gate):
    svc = PlanService(workers=1)
    ticket = svc.submit(_reader_program(), "table")
    with pytest.raises(TimeoutError):
        ticket.result(timeout=0.05)
    solve_gate.set()
    assert ticket.result(timeout=30).best is not None


def test_submit_time_errors_raise_synchronously():
    svc = PlanService(workers=1)
    with pytest.raises(KeyError):
        svc.submit(_reader_program(), "no_such_memory")
    with pytest.raises(ValueError, match="unknown scorer"):
        svc.submit(_reader_program(), "table", scorer="nope")


def test_worker_errors_propagate_through_result(monkeypatch):
    def boom(self, prep):
        raise RuntimeError("solver exploded")

    monkeypatch.setattr(BankingPlanner, "build_space", boom)
    svc = PlanService(workers=1)
    ticket = svc.submit(_reader_program(), "table")
    with pytest.raises(RuntimeError, match="solver exploded"):
        ticket.result(timeout=30)
    assert ticket.status == "error" and svc.stats.errors == 1
    # the fallback still serves even though the solve failed
    assert ticket.fallback(backend="numpy").n_banks == 1


def test_inflight_submits_share_one_ticket(solve_gate):
    svc = PlanService(workers=1)
    t1 = svc.submit(_reader_program(), "table")
    t2 = svc.submit(_reader_program(), "table")   # same signature, in flight
    assert t2 is t1 and svc.stats.deduped == 1
    solve_gate.set()
    t1.result(timeout=30)
    assert len(solve_gate.order) == 1             # ONE solve for both
    # after completion, a resubmit is a sync cache hit, not the old ticket
    t3 = svc.submit(_reader_program(), "table")
    assert t3 is not t1 and t3.done()


def test_priority_orders_the_queue(solve_gate):
    svc = PlanService(workers=1)
    svc.submit(_reader_program(name="first"), "first")       # occupies worker
    svc.submit(_reader_program(stride=2, name="low"), "low", priority=5)
    svc.submit(_reader_program(stride=3, name="high"), "high", priority=0)
    solve_gate.set()
    assert svc.drain(timeout=30)
    assert solve_gate.order == ["first", "high", "low"]


def test_dedup_upgrades_priority(solve_gate):
    """A hotter resubmit of an in-flight problem pulls it forward in the
    queue (the stale lower-priority entry becomes a no-op)."""
    svc = PlanService(workers=1)
    svc.submit(_reader_program(name="first"), "first")       # occupies worker
    a1 = svc.submit(_reader_program(stride=2, name="a"), "a", priority=5)
    svc.submit(_reader_program(stride=3, name="b"), "b", priority=2)
    a2 = svc.submit(_reader_program(stride=2, name="a"), "a", priority=0)
    assert a2 is a1 and a1.priority == 0 and svc.stats.deduped == 1
    solve_gate.set()
    assert svc.drain(timeout=30)
    assert solve_gate.order == ["first", "a", "b"]   # a jumped ahead of b


# ---------------------------------------------------------------------------
# Sharded solves: stats counters + progressive best-so-far tickets
# ---------------------------------------------------------------------------


def test_sharded_solve_stats_and_monotone_best(solve_counter):
    """A cold ticket fans its candidate space across the worker pool:
    ServiceStats counts shards spawned/completed and best-so-far
    promotions, and ``best_so_far()`` never regresses in score as the
    shard streams land -- ending exactly at the plan's winner."""
    svc = PlanService(workers=2, shard_budget=4)
    ticket = svc.submit(_reader_program(stride=3, count=64), "table")
    scores = []
    while not ticket.wait(0.001):
        best = ticket.best_so_far()
        if best is not None:
            scores.append(best.score)
    plan = ticket.result(30)
    assert plan.status == "solved" and len(solve_counter) == 1
    st = svc.stats
    assert st.shards_spawned == 4          # one space, four shards
    assert st.shards_completed == st.shards_spawned
    assert st.best_promotions >= 1
    assert st.dedup_hits >= 0
    assert st.solved == 1
    scores.append(plan.best.score)          # the winner caps the series
    assert all(a >= b for a, b in zip(scores, scores[1:]))
    assert ticket.best_so_far() is plan.best
    assert ticket.best_version() >= 1


def test_shard_budget_one_still_resolves(solve_counter):
    svc = PlanService(workers=1, shard_budget=1)
    plan = svc.submit(_reader_program(), "table").result(timeout=30)
    assert plan.best is not None and svc.stats.shards_spawned == 1


def test_sharded_result_matches_blocking_plan():
    """ticket.result() after a 4-way sharded solve chooses the same
    scheme as a fresh blocking (single-path) planner."""
    svc = PlanService(workers=2, shard_budget=4)
    sharded = svc.submit(_reader_program(stride=2), "table").result(30)
    blocking = BankingPlanner().plan(_reader_program(stride=2), "table")
    assert sharded.best.geometry == blocking.best.geometry
    assert sharded.signature == blocking.signature


# ---------------------------------------------------------------------------
# Warm stores: tickets born done
# ---------------------------------------------------------------------------


def test_warm_directory_store_returns_done_ticket(tmp_path, solve_counter):
    """Acceptance: a warm DirectoryStore makes submit() return an
    already-done ticket -- zero solver calls, asserted via counter."""
    svc1 = PlanService(store=DirectoryStore(tmp_path), workers=1)
    svc1.submit(_reader_program(), "table").result(timeout=30)
    assert len(solve_counter) == 1
    # a different service + planner ("another process") on the same dir
    svc2 = PlanService(store=DirectoryStore(tmp_path), workers=1)
    ticket = svc2.submit(_reader_program(), "table")
    assert ticket.done()                          # answered inside submit
    assert len(solve_counter) == 1                # NO solver call
    plan = ticket.result()
    assert plan.status == "cached-disk"
    assert svc2.stats.sync_hits == 1 and svc2.stats.queued == 0
    # the artifact comes straight off the shared store too
    art = ticket.artifact()
    assert art.n_banks == plan.best.num_banks


def test_use_cache_false_always_resolves(solve_counter):
    svc = PlanService(workers=1)
    svc.submit(_reader_program(), "table").result(timeout=30)
    t = svc.submit(_reader_program(), "table", use_cache=False)
    t.result(timeout=30)
    assert len(solve_counter) == 2


# ---------------------------------------------------------------------------
# Stale-while-revalidate: near-match serves, exact solve runs speculatively
# ---------------------------------------------------------------------------


def test_stale_near_match_serves_while_revalidating(tmp_path, solve_gate):
    store = DirectoryStore(tmp_path)
    warm = PlanService(store=store, workers=1)
    solve_gate.set()   # base solve may run immediately
    base = warm.submit(_reader_program(), "table",
                       opts=SolverOptions(n_budget=8)).result(timeout=30)
    # fresh planner, same store, drifted solver options -> near match
    gate2 = threading.Event()
    real = BankingPlanner.build_space
    seen = []

    def gated2(self, prep):
        seen.append(1)
        gate2.wait(30)
        return real(self, prep)

    BankingPlanner.build_space = gated2
    try:
        svc = PlanService(store=DirectoryStore(tmp_path), workers=1)
        ticket = svc.submit(_reader_program(), "table",
                            opts=SolverOptions(n_budget=16))
        assert ticket.status in ("revalidating", "solving")
        assert ticket.stale_plan is not None
        assert ticket.stale_plan.signature == base.signature
        # the provisional artifact is the near-match scheme, NOT trivial
        fb = ticket.fallback(backend="numpy")
        assert fb.n_banks == base.best.num_banks > 1
        assert svc.stats.revalidations == 1
        gate2.set()
        fresh = ticket.result(timeout=30)
        # the speculative re-plan really solved under the new options
        assert fresh.status == "solved" and len(seen) == 1
        assert fresh.signature != base.signature
        assert fresh.family == base.family
    finally:
        gate2.set()
        BankingPlanner.build_space = real


def test_revalidate_can_be_disabled(tmp_path, solve_gate):
    store = DirectoryStore(tmp_path)
    solve_gate.set()
    PlanService(store=store, workers=1).submit(
        _reader_program(), "table",
        opts=SolverOptions(n_budget=8)).result(timeout=30)
    svc = PlanService(store=DirectoryStore(tmp_path), workers=1,
                      revalidate=StaleWhileRevalidate(enabled=False))
    ticket = svc.submit(_reader_program(), "table",
                        opts=SolverOptions(n_budget=16))
    assert ticket.stale_plan is None
    assert ticket.fallback(backend="numpy").n_banks == 1   # trivial
    ticket.result(timeout=30)


# ---------------------------------------------------------------------------
# Fallback-first serving with hot swap (the acceptance test)
# ---------------------------------------------------------------------------


def _tiny_model():
    from repro_torch.configs import get_arch
    from repro_torch.models import get_model

    cfg = get_arch("qwen2_7b").reduced()
    cfg = dataclasses.replace(cfg, n_layers=1, d_model=32, d_ff=64,
                              vocab=64, n_heads=2, n_kv_heads=2, head_dim=16)
    return get_model(cfg)


def test_server_first_tick_from_fallback_then_hot_swap(solve_gate):
    """The server serves its first tick from the fallback artifact without
    waiting on the solver, then hot-swaps to the solved artifact between
    ticks -- with identical gather results across the swap."""
    from repro_torch.runtime.server import Request, Server, page_ticket

    svc = PlanService(workers=1)
    ticket = page_ticket(None, max_len=32, page=8, readers=4, service=svc)
    assert not ticket.done()                  # solver is gated shut
    server = Server(_tiny_model(), max_batch=2, max_len=32, kv_plan=ticket, device="cpu")
    # first-tick layout IS the trivial fallback: one bank = one page
    assert server.pager.pages_per_slot == 1
    assert server.pager.page_size >= 32
    server.submit(Request(uid=0, prompt=np.asarray([3, 4, 5], np.int32),
                          max_new=6))
    server.tick()
    assert server.ticks == 1 and not ticket.done()   # served pre-solve
    assert len(server.active[0].out) == 1            # a real token came out
    fb_art, fb_table = server._kv_art, server.kv_records
    idx = np.asarray([[0, 1, 2], [1, 2, 3]], np.int32)
    before = np.asarray(fb_art.gather(fb_table, idx))
    # release the solver; the swap happens between ticks
    solve_gate.set()
    assert ticket.wait(30)
    server._maybe_swap_kv()
    assert server.swaps == 1
    solved = server.pager.artifact
    assert solved.n_banks > 1                        # real banking now
    assert server.pager.pages_per_slot == solved.n_banks
    # identical gather results through the solved resolution circuit
    after = np.asarray(server._kv_art.gather(server.kv_records, idx))
    np.testing.assert_array_equal(before, after)
    # and the whole logical record table survived the swap
    np.testing.assert_array_equal(
        np.asarray(fb_art.unpack(fb_table)),
        np.asarray(server._kv_art.unpack(server.kv_records)))
    server.tick()
    assert server.swaps == 1                         # swap is one-shot
    server.run(max_ticks=50)
    assert not server.active and not server.queue
    assert server.pager.used_pages == 0              # pages released


def test_server_promotes_to_best_so_far_mid_search(monkeypatch):
    """Before the full search drains, the server adopts the ticket's
    best-so-far scheme between ticks (a *promotion*, not the final
    swap) -- and the logical record table survives both the promotion
    and the eventual solved swap."""
    from repro_torch.core import service as service_mod
    from repro_torch.runtime.server import Request, Server, page_ticket

    real = service_mod.evaluate
    reached = threading.Event()    # one valid scheme has streamed
    release = threading.Event()    # let the search finish

    def paced(shard, gate=None):
        for ev in real(shard, gate=gate):
            yield ev
            if ev.solutions and not reached.is_set():
                reached.set()
                assert release.wait(30)

    monkeypatch.setattr(service_mod, "evaluate", paced)
    try:
        svc = PlanService(workers=1, shard_budget=1)
        ticket = page_ticket(None, max_len=32, page=8, readers=4,
                             service=svc)
        server = Server(_tiny_model(), max_batch=2, max_len=32,
                        kv_plan=ticket, device="cpu")
        assert server.pager.pages_per_slot == 1      # trivial fallback
        assert reached.wait(30)
        assert not ticket.done()
        best = ticket.best_so_far()
        assert best is not None and ticket.best_version() >= 1
        server.submit(Request(uid=0,
                              prompt=np.asarray([3, 4, 5], np.int32),
                              max_new=6))
        server.tick()          # _maybe_swap_kv promotes, then serves
        assert server.promotions == 1 and server.swaps == 0
        assert server.pager.pages_per_slot > 1       # real banking now
        assert len(server.active[0].out) == 1
        promoted_art, promoted_tab = server._kv_art, server.kv_records
        idx = np.asarray([[0, 1, 2], [1, 2, 3]], np.int32)
        before = np.asarray(promoted_art.gather(promoted_tab, idx))
        server._maybe_swap_kv()
        assert server.promotions == 1                # same version: no-op
        release.set()
        assert ticket.wait(30)
        server._maybe_swap_kv()      # the final solved swap (a no-op if
        # the promotion already landed the winning layout)
        assert server._kv_art.layout == ticket.artifact().layout
        assert server.swaps == (0 if promoted_art.layout
                                == ticket.artifact().layout else 1)
        after = np.asarray(server._kv_art.gather(server.kv_records, idx))
        np.testing.assert_array_equal(before, after)
        server.run(max_ticks=50)
        assert not server.active and not server.queue
    finally:
        release.set()


def test_server_with_done_ticket_and_with_raw_artifact_agree(solve_gate):
    """A ticket that resolved before the server starts behaves exactly
    like the legacy solved-artifact path."""
    from repro_torch.runtime.server import Request, Server, page_ticket

    solve_gate.set()
    svc = PlanService(workers=1)
    ticket = page_ticket(None, max_len=32, page=8, readers=4, service=svc)
    ticket.wait(30)
    model = _tiny_model()
    s_ticket = Server(model, max_batch=2, max_len=32, kv_plan=ticket, device="cpu")
    s_art = Server(model, max_batch=2, max_len=32,
                   kv_plan=ticket.artifact(), device="cpu")
    assert s_ticket.swaps == 0 and s_ticket._kv_ticket is None
    assert (s_ticket.pager.pages_per_slot == s_art.pager.pages_per_slot
            == ticket.artifact().n_banks)
    for s in (s_ticket, s_art):
        s.submit(Request(uid=0, prompt=np.asarray([5, 6], np.int32),
                         max_new=4))
        s.run(max_ticks=20)
    assert s_ticket.active == {} and s_art.active == {}


def test_batched_tick_gather_is_one_call(monkeypatch, solve_gate):
    """Server.tick issues exactly ONE banked gather per tick, covering
    every active slot (stacked (slots, W) index matrix)."""
    from repro_torch.core.artifact import CompiledBankingPlan
    from repro_torch.runtime.server import Request, Server, page_ticket

    solve_gate.set()
    svc = PlanService(workers=1)
    ticket = page_ticket(None, max_len=32, page=8, readers=4, service=svc)
    ticket.result(30)
    server = Server(_tiny_model(), max_batch=2, max_len=32, kv_plan=ticket, device="cpu")
    calls = []
    real = CompiledBankingPlan.gather

    def spying(self, table, rows, **kw):
        calls.append(np.asarray(rows).shape)
        return real(self, table, rows, **kw)

    monkeypatch.setattr(CompiledBankingPlan, "gather", spying)
    for uid in range(2):
        server.submit(Request(uid=uid,
                              prompt=np.asarray([3 + uid, 4], np.int32),
                              max_new=3))
    server.tick()
    assert len(calls) == 1                      # one kernel launch per tick
    assert calls[0] == (2, server._gather_window)   # both slots, stacked
    server.tick()
    assert len(calls) == 2
