# tests/test_jointplan.py of the JAX package, run against repro_torch: the same
# cases on the port's plan plane (CPU tensors where a case builds a server).
"""Joint whole-model planning: Pareto frontiers, exact co-selection
under a shared ResourceBudget, the JointTicket graph (progressive
re-selection, completion-order invariance, certifier-backed eviction),
plan_all rebased on it, joint/ store persistence, and the server's
coherent multi-pool swap."""

import threading
from types import SimpleNamespace

import numpy as np
import pytest

from repro_torch.core import (AccessDecl, BankingPlanner, Counter, Ctrl,
                        MemorySpec, PlanService, Program, ResourceBudget,
                        ResourceUse, Sched, co_select, pareto_frontier,
                        trivial_solution)
from repro_torch.core.jointplan import (FrontierPoint, JointPlan, TRIVIAL_PENALTY,
                                  independent_use, is_trivial)
from repro_torch.core.polytope import Affine
from repro_torch.core.store import DirectoryStore


def _joint_program(dims_a=(256,), dims_b=(128,), par_a=8, par_b=4):
    """Two banked memories behind one FORKJOIN root -- the minimal
    whole-model shape (think: KV pool + MoE dispatch table)."""
    a = MemorySpec("a", dims=dims_a, word_bits=16, ports=1)
    b = MemorySpec("b", dims=dims_b, word_bits=32, ports=1)
    return Program(
        root=Ctrl("model", Sched.FORKJOIN, children=[
            Ctrl("ra", Sched.INNER,
                 counters=[Counter("i", 0, 1, 32, par=par_a)],
                 accesses=[AccessDecl("a", (Affine.of(i=1),))]),
            Ctrl("rb", Sched.INNER,
                 counters=[Counter("j", 0, 1, 32, par=par_b)],
                 accesses=[AccessDecl("b", (Affine.of(j=1),))]),
        ]),
        memories={"a": a, "b": b},
    )


def _pt(score, trivial=False, **axes):
    """Synthetic frontier point: co_select only reads score/use/trivial
    plus key(), so a stub solution with a flat geometry suffices."""
    sol = SimpleNamespace(kind="flat",
                          geometry=SimpleNamespace(
                              N=axes.get("banks", 1), B=1,
                              alpha=(1,), Ns=None, Bs=None, alphas=None),
                          duplicates=1, score=score)
    return FrontierPoint(solution=sol, use=ResourceUse(**axes),
                         score=score, trivial=trivial)


# ---------------------------------------------------------------------------
# Budget currency
# ---------------------------------------------------------------------------


def test_resource_use_arithmetic_and_budget():
    u = ResourceUse(banks=4, volume=64, lut=10.0, bram=4)
    v = ResourceUse(banks=2, volume=32, lut=5.0, bram=2, dsp=1)
    s = u + v
    assert (s.banks, s.volume, s.lut, s.bram, s.dsp) == (6, 96, 15.0, 6, 1)
    assert not ResourceBudget().bounded              # slack admits anything
    assert ResourceBudget().admits(s)
    tight = ResourceBudget(bram=5, banks=6)
    assert tight.bounded and not tight.admits(s)     # bram 6 > 5
    assert ResourceBudget(bram=6, banks=6).admits(s)
    head = tight.headroom(s)
    assert head == {"banks": 0, "bram": -1}


# ---------------------------------------------------------------------------
# Pareto frontiers
# ---------------------------------------------------------------------------


def _solved_frontier(cap=8):
    planner = BankingPlanner()
    prog = _joint_program()
    prep = planner.prepare(prog, "a", use_cache=False)
    plan = planner.plan(prog, "a", use_cache=False)
    triv = trivial_solution(prep.mem, prep.groups, prep.iterators, prep.opts)
    return pareto_frontier(plan.solutions, trivial=triv, cap=cap), plan


def test_pareto_frontier_trivial_always_last_and_penalized():
    front, plan = _solved_frontier()
    assert front[-1].trivial and is_trivial(front[-1].solution)
    assert front[-1].score > TRIVIAL_PENALTY
    reals = front[:-1]
    assert reals, "solver produced no real frontier points"
    # best-cost-first, and the argmin scheme leads the frontier
    assert reals[0].score == min(p.score for p in reals)
    assert reals[0].solution.num_banks == plan.best.num_banks
    # no real point dominates another (Pareto property)
    for p in reals:
        for q in reals:
            if p is q:
                continue
            assert not (q.score <= p.score
                        and all(x <= y for x, y in zip(q.use.as_tuple(),
                                                       p.use.as_tuple()))
                        and (q.score < p.score
                             or q.use.as_tuple() != p.use.as_tuple()))


def test_pareto_frontier_cap_keeps_per_axis_minima():
    full, _ = _solved_frontier(cap=64)
    capped, _ = _solved_frontier(cap=3)
    assert len(capped) <= 3 + len(ResourceUse().as_dict())  # cap + axis mins
    # every axis's cheapest draw survives truncation
    reals_full = [p for p in full if not p.trivial]
    reals_cap = [p for p in capped if not p.trivial]
    for axis in ("banks", "bram", "lut"):
        lo = min(p.use.axis(axis) for p in reals_full)
        assert min(p.use.axis(axis) for p in reals_cap) == lo


def test_frontier_of_empty_stream_is_trivial_only():
    planner = BankingPlanner()
    prog = _joint_program()
    prep = planner.prepare(prog, "a", use_cache=False)
    triv = trivial_solution(prep.mem, prep.groups, prep.iterators, prep.opts)
    front = pareto_frontier([], trivial=triv, cap=4)
    assert len(front) == 1 and front[0].trivial


# ---------------------------------------------------------------------------
# Exact co-selection
# ---------------------------------------------------------------------------


def _fronts():
    big = TRIVIAL_PENALTY * 2
    return {
        "a": [_pt(10.0, banks=8, bram=8, volume=64),
              _pt(30.0, banks=2, bram=2, volume=64),
              _pt(big, trivial=True, banks=1, bram=1, volume=64)],
        "b": [_pt(5.0, banks=4, bram=4, volume=32),
              _pt(50.0, banks=2, bram=2, volume=32),
              _pt(big, trivial=True, banks=1, bram=1, volume=32)],
    }


def test_co_select_slack_budget_is_independent_argmin():
    for budget in (None, ResourceBudget()):
        sel = co_select(_fronts(), budget)
        assert sel.feasible
        assert sel.picks["a"].score == 10.0 and sel.picks["b"].score == 5.0
        assert sel.total_score == 15.0 and sel.total_use.bram == 12


def test_co_select_trades_down_the_right_memory():
    # bram cap 10: argmins draw 12.  Cheapest total under the cap keeps
    # a's argmin (8) and trades b down (2) -> 60.0 beats trading a
    # down (2+4=6 for 35.0)... which is cheaper still: the exact search
    # must find 35.0, not the greedy 60.0.
    sel = co_select(_fronts(), ResourceBudget(bram=10))
    assert sel.feasible and sel.total_use.bram <= 10
    assert sel.total_score == 35.0
    assert sel.picks["a"].score == 30.0 and sel.picks["b"].score == 5.0
    # no trivial member was needed
    assert not any(p.trivial for p in sel.picks.values())


def test_co_select_falls_back_to_trivial_under_pressure():
    # bram=3: the cheapest real pair draws 4, so exactly one member must
    # serialize -- and the exact search trades down the one whose real
    # scheme it can keep cheapest (keep a's 30.0, trivialize b)
    sel = co_select(_fronts(), ResourceBudget(bram=3))
    assert sel.feasible and sel.total_use.bram <= 3
    picked_trivial = [n for n, p in sel.picks.items() if p.trivial]
    assert picked_trivial == ["b"]
    assert sel.picks["a"].score == 30.0


def test_co_select_infeasible_returns_all_trivial_never_raises():
    sel = co_select(_fronts(), ResourceBudget(bram=1))   # floor is 2
    assert not sel.feasible
    assert all(p.trivial for p in sel.picks.values())
    assert sel.total_use.bram == 2                       # honest accounting


# ---------------------------------------------------------------------------
# The JointTicket graph (service front door)
# ---------------------------------------------------------------------------


def test_submit_joint_slack_equals_independent():
    svc = PlanService(workers=2)
    prog = _joint_program()
    jplan = svc.submit_joint(prog).result(timeout=120)
    assert jplan.feasible and jplan.fits()
    for name in ("a", "b"):
        indep = svc.submit(prog, name).result(timeout=120)
        m = jplan.members[name]
        assert not m.trivial
        assert m.chosen.describe() == indep.best.describe()
    assert jplan.total_use.as_tuple() == independent_use(
        {n: svc.submit(prog, n).result(timeout=120)
         for n in ("a", "b")}).as_tuple()
    svc.shutdown()


def test_submit_joint_budget_fits_where_independent_does_not():
    svc = PlanService(workers=2)
    prog = _joint_program()
    free = svc.submit_joint(prog).result(timeout=120)
    cap = ResourceBudget(bram=max(2, int(free.total_use.bram * 0.6)))
    assert not cap.admits(free.total_use)        # independent blows it
    squeezed = svc.submit_joint(prog, budget=cap).result(timeout=120)
    assert squeezed.feasible and squeezed.fits()
    assert squeezed.total_use.bram <= cap.bram
    # fitting required actually trading some member down
    traded = [n for n in ("a", "b")
              if (squeezed.members[n].chosen.describe()
                  != free.members[n].chosen.describe())]
    assert traded
    svc.shutdown()


def test_submit_joint_infeasible_never_raises():
    svc = PlanService(workers=2)
    prog = _joint_program()
    # two memories, one physical bank total: even all-trivial needs 2
    t = svc.submit_joint(prog, budget=ResourceBudget(banks=1))
    jplan = t.result(timeout=120)                # resolves, no exception
    assert not jplan.feasible and not jplan.fits()
    assert all(m.trivial and is_trivial(m.chosen)
               for m in jplan.members.values())
    assert svc.stats.joint_infeasible == 1
    # the ticket still hands out executable artifacts for every member
    arts = t.artifacts(backend="numpy")
    assert set(arts) == {"a", "b"} and all(a.n_banks == 1
                                           for a in arts.values())
    svc.shutdown()


def test_joint_fallback_serves_before_any_solve(monkeypatch):
    gate = threading.Event()
    real = BankingPlanner.build_space

    def gated(self, prep):
        gate.wait(30)
        return real(self, prep)

    monkeypatch.setattr(BankingPlanner, "build_space", gated)
    svc = PlanService(workers=2)
    t = svc.submit_joint(_joint_program())
    assert not t.done()
    fbs = t.fallback(backend="numpy")
    assert set(fbs) == {"a", "b"}
    flat = np.arange(256 * 2, dtype=np.float32).reshape(256, 2)
    got = fbs["a"].gather(fbs["a"].pack(flat, device="cpu"), np.asarray([0, 5, 255]))
    np.testing.assert_array_equal(got, flat[[0, 5, 255]])
    gate.set()
    assert t.result(timeout=120).feasible
    svc.shutdown()


@pytest.mark.parametrize("block_first", ["a", "b"])
def test_selection_invariant_to_completion_order(monkeypatch, block_first):
    """The same problem solved with either member landing last must
    produce the identical joint plan -- selection is a pure function of
    the final frontiers, not of arrival order."""
    gate = threading.Event()
    real = BankingPlanner.build_space

    def gated(self, prep):
        if prep.mem.name == block_first:
            gate.wait(30)
        return real(self, prep)

    monkeypatch.setattr(BankingPlanner, "build_space", gated)
    svc = PlanService(workers=2)
    prog = _joint_program()
    budget = ResourceBudget(bram=9)
    t = svc.submit_joint(prog, budget=budget)
    other = "b" if block_first == "a" else "a"
    t.members[other].result(timeout=120)         # other member lands first
    gate.set()
    jplan = t.result(timeout=120)
    svc.shutdown()
    # reference: the same problem with no gating at all
    svc2 = PlanService(workers=2)
    ref = svc2.submit_joint(prog, budget=budget).result(timeout=120)
    svc2.shutdown()
    assert jplan.signature == ref.signature
    assert jplan.total_use.as_tuple() == ref.total_use.as_tuple()
    for name in ("a", "b"):
        assert (jplan.members[name].chosen.describe()
                == ref.members[name].chosen.describe())


def test_progressive_reselection_while_members_land(monkeypatch):
    """While one member is still solving, selection() serves the landed
    member's real scheme + the other's trivial; best_version bumps when
    the blocked member finally lands."""
    gate = threading.Event()
    real = BankingPlanner.build_space

    def gated(self, prep):
        if prep.mem.name == "a":
            gate.wait(30)
        return real(self, prep)

    monkeypatch.setattr(BankingPlanner, "build_space", gated)
    svc = PlanService(workers=2)
    t = svc.submit_joint(_joint_program())
    t.members["b"].result(timeout=120)
    sel = t.selection()
    assert not sel.picks["b"].trivial      # landed member: real scheme
    assert sel.picks["a"].trivial          # in-flight member: trivial
    v = t.best_version()
    gate.set()
    jplan = t.result(timeout=120)
    assert not jplan.members["a"].trivial
    assert t.best_version() > v            # the joint selection moved
    assert svc.stats.joint_reselects >= 1
    svc.shutdown()


def test_cert_rejection_of_one_member_never_poisons_group(monkeypatch):
    """A certifier that refuses every scheme for memory 'a' must degrade
    'a' to trivial -- 'b' still lands solved AND certified."""
    from repro_torch.analysis import certify as certify_mod

    real = certify_mod.certify_solution

    def hostile(sol, groups, iterators, **kw):
        res = real(sol, groups, iterators, **kw)
        if sol.memory.name == "a" and not is_trivial(sol):
            res.ok = False
            res.certificate = None
        return res

    monkeypatch.setattr(certify_mod, "certify_solution", hostile)
    svc = PlanService(workers=2, verify="store")
    jplan = svc.submit_joint(_joint_program()).result(timeout=120)
    a, b = jplan.members["a"], jplan.members["b"]
    assert a.trivial and not a.certified and a.certificate is None
    assert not b.trivial and b.certified and b.certificate is not None
    # the certificate is machine-checkable (PR-7 contract)
    from repro_torch.analysis import check_certificate
    from repro_torch.analysis.certify import ConflictCertificate
    ok, _why = check_certificate(ConflictCertificate.from_json(b.certificate))
    assert ok
    svc.shutdown()


def test_joint_plan_persists_and_hydrates(tmp_path):
    store = DirectoryStore(tmp_path)
    svc = PlanService(workers=2, store=store)
    prog = _joint_program()
    budget = ResourceBudget(bram=64)
    first = svc.submit_joint(prog, budget=budget).result(timeout=120)
    assert (tmp_path / "joint" / f"{first.signature}.json").exists()
    svc.shutdown()
    # a fresh service over the same directory answers before returning
    svc2 = PlanService(workers=2, store=DirectoryStore(tmp_path))
    t = svc2.submit_joint(prog, budget=budget)
    assert t.done() and svc2.stats.joint_sync_hits == 1
    hydrated = t.result()
    assert hydrated.status == "cached-disk"
    assert hydrated.signature == first.signature
    assert hydrated.total_use.as_tuple() == first.total_use.as_tuple()
    for name in ("a", "b"):
        assert (hydrated.members[name].chosen.describe()
                == first.members[name].chosen.describe())
    # round-trip through JSON is exact on the accounting view
    assert (JointPlan.from_json(first.to_json()).as_dict()
            == first.as_dict())
    svc2.shutdown()


# ---------------------------------------------------------------------------
# plan_all rides the joint graph
# ---------------------------------------------------------------------------


def test_plan_all_without_budget_matches_independent():
    planner = BankingPlanner()
    prog = _joint_program()
    plans = planner.plan_all(prog)
    assert set(plans) == {"a", "b"}
    for name, p in plans.items():
        assert p.status in ("solved", "cached")
        indep = planner.plan(prog, name)
        assert p.best.describe() == indep.best.describe()
    row = plans["a"].table_row()
    assert "volume" in row and row["banks"] == plans["a"].best.num_banks
    d = plans["a"].as_dict()
    assert d["resources"]["total"]["bram"] >= 1


def test_plan_all_under_budget_fits_where_independent_does_not():
    planner = BankingPlanner()
    prog = _joint_program()
    free = planner.plan_all(prog)
    free_use = independent_use(free)
    cap = ResourceBudget(bram=max(2, int(free_use.bram * 0.6)))
    assert not cap.admits(free_use)
    squeezed = planner.plan_all(prog, budget=cap)
    got = ResourceUse()
    for p in squeezed.values():
        got = got + ResourceUse.of_solution(p.best)
    assert cap.admits(got)


def test_plan_all_timeout_contract(monkeypatch):
    gate = threading.Event()
    real = BankingPlanner.build_space

    def gated(self, prep):
        gate.wait(30)
        return real(self, prep)

    monkeypatch.setattr(BankingPlanner, "build_space", gated)
    planner = BankingPlanner()
    plans = planner.plan_all(_joint_program(), timeout=0.2)
    gate.set()
    for p in plans.values():
        assert p.status == "timeout"
        assert "exceeded 0.2s budget" in p.error


# ---------------------------------------------------------------------------
# Coherent multi-pool server swap
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_server_swaps_all_pools_coherently(monkeypatch):
    """An MoE model serves through TWO banked pools (KV pages + MoE
    dispatch).  With the KV solve gated, the server starts on the joint
    fallback; releasing the gate must promote BOTH pools in ONE
    generation bump -- never a mixed generation, asserted every tick."""
    from repro_torch.configs import get_arch
    from repro_torch.models import get_model
    from repro_torch.runtime.server import Request, Server, joint_ticket

    gate = threading.Event()
    real = BankingPlanner.build_space

    def gated(self, prep):
        if prep.mem.name == "kv_pool":
            gate.wait(60)
        return real(self, prep)

    monkeypatch.setattr(BankingPlanner, "build_space", gated)
    cfg = get_arch("olmoe-1b-7b").reduced()
    svc = PlanService(workers=2)
    ticket = joint_ticket(cfg, max_len=32, page=8, readers=2, service=svc)
    assert set(ticket.members) == {"kv_pool", "moe_dispatch"}
    model = get_model(cfg)
    server = Server(model, max_batch=2, max_len=32, kv_plan=ticket,
                    device="cpu")
    assert "moe_dispatch" in server.pools
    assert server.coherent and set(server.generations.values()) == {0}

    # every tick must observe a single generation across all pools
    orig_tick = server._tick

    def checked_tick():
        assert server.coherent, f"mixed generations: {server.generations}"
        orig_tick()

    server._tick = checked_tick
    rng = np.random.default_rng(0)
    r0 = Request(uid=0, prompt=rng.integers(
        2, cfg.vocab - 1, size=3).astype(np.int32), max_new=2)
    server.submit(r0)
    server.run(max_ticks=50)          # serve from fallback, gate closed
    assert r0.done and r0.out
    gate.set()
    plan = ticket.result(timeout=120)
    assert not plan.members["kv_pool"].trivial
    r1 = Request(uid=1, prompt=rng.integers(
        2, cfg.vocab - 1, size=3).astype(np.int32), max_new=2)
    server.submit(r1)
    server.run(max_ticks=50)          # adopts the final joint selection
    assert server.joint_swaps + server.joint_promotions >= 1
    assert server.coherent
    gens = set(server.generations.values())
    assert len(gens) == 1 and gens.pop() >= 1
    assert r1.done and r1.out
    svc.shutdown()
