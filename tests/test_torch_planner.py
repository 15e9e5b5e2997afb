# tests/test_planner.py of the JAX package, run against repro_torch: the same
# cases on the port's plan plane (CPU tensors where a case builds a server).
"""Planner subsystem: signature cache, JSON durability, scorer registry."""

import json

import numpy as np
import pytest

from repro_torch.core import (AccessDecl, BankingPlan, BankingPlanner, Counter,
                        Ctrl, MemorySpec, PlanRequest, Program, Sched,
                        SolverOptions, program_signature,
                        register_scorer, resolve_scorer)
from repro_torch.core import planner as planner_mod
from repro_torch.core.polytope import Affine


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
    """Count real solver invocations made through the planner.

    Every cold-solve path (the blocking plan() and the service's sharded
    workers alike) begins by enumerating its candidate space through
    BankingPlanner.build_space -- the one chokepoint worth counting."""
    calls = []
    real = BankingPlanner.build_space

    def counting(self, prep):
        calls.append(1)
        return real(self, prep)

    monkeypatch.setattr(BankingPlanner, "build_space", counting)
    return calls


# ---------------------------------------------------------------------------
# Cache semantics
# ---------------------------------------------------------------------------


def test_cache_hit_performs_zero_solver_calls(solve_counter):
    planner = BankingPlanner()
    p1 = planner.plan(_reader_program(), "table")
    assert len(solve_counter) == 1 and p1.status == "solved"
    # a structurally identical but freshly-built program -> pure cache hit
    p2 = planner.plan(_reader_program(), "table")
    assert len(solve_counter) == 1          # ZERO additional solver calls
    assert p2.status == "cached"
    assert p2.best.geometry == p1.best.geometry
    assert planner.stats.hits == 1 and planner.stats.solves == 1


def test_mutated_access_re_solves(solve_counter):
    planner = BankingPlanner()
    planner.plan(_reader_program(stride=1), "table")
    planner.plan(_reader_program(stride=2), "table")   # different polytopes
    assert len(solve_counter) == 2
    assert planner.stats.misses == 2 and planner.stats.hits == 0


def test_signature_is_structural_not_nominal():
    """Same polytopes under a different memory name -> same signature."""
    a = program_signature(_reader_program(name="kv_pool"), "kv_pool")
    b = program_signature(_reader_program(name="table"), "table")
    assert a == b
    # ...but solver options are part of the identity
    c = program_signature(_reader_program(name="table"), "table",
                          SolverOptions(n_budget=7))
    assert c != b


def test_opts_and_scorer_key_the_cache(solve_counter):
    planner = BankingPlanner()
    prog = _reader_program()
    planner.plan(prog, "table", opts=SolverOptions(n_budget=8))
    planner.plan(prog, "table", opts=SolverOptions(n_budget=16))
    assert len(solve_counter) == 2
    # same opts, different scorer -> re-rank requires a fresh solve entry
    planner.plan(prog, "table", opts=SolverOptions(n_budget=8),
                 scorer=lambda s: float(s.num_banks))
    assert len(solve_counter) == 3


def test_plan_request_object_entry_point(solve_counter):
    planner = BankingPlanner()
    req = PlanRequest(program=_reader_program(), memory="table")
    plan = planner.plan(req)
    assert plan.best is not None and len(solve_counter) == 1


# ---------------------------------------------------------------------------
# Durability: JSON round-trip + disk cache
# ---------------------------------------------------------------------------


def test_plan_json_roundtrip_preserves_scheme():
    planner = BankingPlanner()
    plan = planner.plan(_reader_program(), "table")
    blob = json.dumps(plan.to_json())            # proves JSON-serializable
    back = BankingPlan.from_json(json.loads(blob))
    assert back.signature == plan.signature
    assert back.scorer_name == plan.scorer_name
    assert back.num_candidates == plan.num_candidates
    assert back.solve_seconds == plan.solve_seconds
    b0, b1 = plan.best, back.best
    assert b1.kind == b0.kind and b1.geometry == b0.geometry
    assert (b1.num_banks, b1.bank_volume, b1.P, b1.pad) == \
        (b0.num_banks, b0.bank_volume, b0.P, b0.pad)
    assert b1.fan_outs == b0.fan_outs and b1.score == b0.score
    assert b1.resources.total.lut == pytest.approx(b0.resources.total.lut)
    # the reloaded plan compiles to an artifact that drives the kernel
    import torch
    from repro_torch.kernels import ref
    from repro_torch.core import compile_plan
    art = compile_plan(back)
    flat = torch.as_tensor(np.random.default_rng(0).normal(size=(256, 4)),
                           dtype=torch.float32)
    table = art.pack(flat)
    idx = torch.as_tensor([0, 5, 200, 131], dtype=torch.int32)
    got = art.gather(table, idx)
    assert (np.asarray(got) == np.asarray(
        ref.banked_gather_reference(flat, idx.long()))).all()


def test_disk_cache_warm_start(tmp_path, solve_counter):
    cold = BankingPlanner(cache_dir=tmp_path)
    plan = cold.plan(_reader_program(), "table")
    assert len(list(tmp_path.glob("*.json"))) == 1
    # a new planner process warm-starts from the persisted plan
    warm = BankingPlanner(cache_dir=tmp_path)
    hit = warm.plan(_reader_program(), "table")
    assert hit.status == "cached-disk"
    assert hit.best.geometry == plan.best.geometry
    assert len(solve_counter) == 1           # only the cold planner solved
    # explicit warm_start() preloads into the in-memory cache
    fresh = BankingPlanner()
    assert fresh.warm_start(tmp_path) == 1
    assert fresh.plan(_reader_program(), "table").status == "cached"
    assert len(solve_counter) == 1


def test_corrupt_disk_plan_falls_back_to_solve(tmp_path, solve_counter):
    BankingPlanner(cache_dir=tmp_path).plan(_reader_program(), "table")
    for f in tmp_path.glob("*.json"):
        f.write_text("{not json")
    repaired = BankingPlanner(cache_dir=tmp_path)
    plan = repaired.plan(_reader_program(), "table")
    assert plan.status == "solved" and len(solve_counter) == 2
    # the re-solve rewrote the damaged file
    assert BankingPlanner(cache_dir=tmp_path).plan(
        _reader_program(), "table").status == "cached-disk"


# ---------------------------------------------------------------------------
# Scorer registry
# ---------------------------------------------------------------------------


def test_scorer_registry_resolution():
    name, fn = resolve_scorer("proxy")
    assert name == "proxy" and fn is None
    name, fn = resolve_scorer(None)
    assert name == "proxy"

    def my_scorer(sol):
        return float(sol.num_banks)

    name, fn = resolve_scorer(my_scorer)
    assert name.startswith("custom:my_scorer:") and fn is my_scorer

    register_scorer("banks", lambda: my_scorer)
    name, fn = resolve_scorer("banks")
    assert name == "banks" and fn is my_scorer


def test_distinct_callable_scorers_do_not_alias(solve_counter):
    """Two different lambdas share __name__; identity must key the cache."""
    planner = BankingPlanner()
    p1 = planner.plan(_reader_program(), "table",
                      scorer=lambda s: float(s.num_banks))
    p2 = planner.plan(_reader_program(), "table",
                      scorer=lambda s: -float(s.num_banks))
    assert len(solve_counter) == 2
    assert [s.num_banks for s in p1.solutions] == \
        sorted(s.num_banks for s in p1.solutions)
    assert [s.num_banks for s in p2.solutions] == \
        sorted((s.num_banks for s in p2.solutions), reverse=True)


def test_cache_hit_is_isolated_and_relabeled(solve_counter):
    planner = BankingPlanner()
    planner.plan(_reader_program(name="kv_pool"), "kv_pool")
    hit = planner.plan(_reader_program(name="table"), "table")
    assert hit.status == "cached" and len(solve_counter) == 1
    assert hit.memory == "table"        # relabeled for the requester
    hit.solutions.clear()               # caller mutation must not poison
    again = planner.plan(_reader_program(name="table"), "table")
    assert again.solutions and len(solve_counter) == 1


def test_unknown_scorer_name_raises():
    with pytest.raises(ValueError, match="unknown scorer 'nope'"):
        resolve_scorer("nope")
    with pytest.raises(ValueError, match="proxy"):
        BankingPlanner().plan(_reader_program(), "table", scorer="nope")


def test_registered_scorer_drives_ranking():
    register_scorer("neg_banks", lambda: (lambda s: -float(s.num_banks)))
    plan = BankingPlanner(scorer="neg_banks").plan(_reader_program(), "table")
    assert plan.scorer_name == "neg_banks"
    banks = [s.num_banks for s in plan.solutions]
    assert banks == sorted(banks, reverse=True)


# ---------------------------------------------------------------------------
# Batched planning
# ---------------------------------------------------------------------------


def test_plan_all_covers_every_memory():
    mem_a = MemorySpec("a", dims=(64,), ports=1)
    mem_b = MemorySpec("b", dims=(32, 32), ports=1)
    prog = Program(
        root=Ctrl("root", Sched.SEQUENTIAL, children=[
            Ctrl("ra", Sched.INNER,
                 counters=[Counter("i", 0, 1, 16, par=4)],
                 accesses=[AccessDecl("a", (Affine.of(i=1),))]),
            Ctrl("rb", Sched.INNER,
                 counters=[Counter("r", 0, 1, 16, par=2),
                           Counter("c", 0, 1, 16)],
                 accesses=[AccessDecl("b", (Affine.of(r=1), Affine.of(c=1)))]),
        ]),
        memories={"a": mem_a, "b": mem_b},
    )
    plans = BankingPlanner().plan_all(prog)
    assert set(plans) == {"a", "b"}
    assert all(p.status == "solved" and p.best is not None
               for p in plans.values())


def test_plan_all_timeout_yields_timeout_plan(monkeypatch):
    import time as time_mod

    real = planner_mod.solve

    def slow_solve(*a, **kw):
        time_mod.sleep(1.5)
        return real(*a, **kw)

    monkeypatch.setattr(planner_mod, "solve", slow_solve)
    plans = BankingPlanner().plan_all(_reader_program(), timeout=0.05)
    assert plans["table"].status == "timeout"
    assert plans["table"].best is None


# ---------------------------------------------------------------------------
# ML scorer persistence (trained pipelines live next to the plan cache)
# ---------------------------------------------------------------------------


def _tiny_ml_scorer():
    from repro_torch.core.cost_model import MLScorer, ResourcePipeline
    from repro_torch.core.features import FEATURE_NAMES

    rng = np.random.default_rng(0)
    X = rng.uniform(1, 8, size=(24, len(FEATURE_NAMES)))
    pipes = {
        k: ResourcePipeline(gbt_params=dict(n_estimators=3)).fit(
            X, rng.uniform(10, 100, size=24))
        for k in ("lut", "ff")
    }
    return MLScorer(pipes), X


def test_ml_scorer_json_roundtrip_predicts_identically():
    from repro_torch.core.cost_model import MLScorer

    scorer, X = _tiny_ml_scorer()
    back = MLScorer.from_json(json.loads(json.dumps(scorer.to_json())))
    for k in scorer.pipelines:
        np.testing.assert_allclose(back.pipelines[k].predict(X),
                                   scorer.pipelines[k].predict(X))
    assert back.weights == scorer.weights


def test_ml_factory_loads_persisted_pipeline_instead_of_training(
        tmp_path, monkeypatch):
    scorer, _ = _tiny_ml_scorer()
    path = tmp_path / "ml_scorer.json"
    path.write_text(json.dumps(scorer.to_json()))

    monkeypatch.setattr(planner_mod, "_ML_SCORER_PATH", path)
    monkeypatch.setattr(planner_mod._ml_scorer_factory, "_cached", None,
                        raising=False)

    def boom():
        raise AssertionError("factory re-trained despite persisted pipeline")

    monkeypatch.setattr(planner_mod, "_train_ml_scorer", boom)
    _, loaded = resolve_scorer("ml")
    assert set(loaded.pipelines) == set(scorer.pipelines)
    # corrupt pipeline file falls back to training
    path.write_text("{not json")
    monkeypatch.setattr(planner_mod._ml_scorer_factory, "_cached", None,
                        raising=False)
    with pytest.raises(AssertionError, match="re-trained"):
        resolve_scorer("ml")


def test_planner_cache_dir_points_ml_scorer_next_to_plans(
        tmp_path, monkeypatch):
    monkeypatch.setattr(planner_mod, "_ML_SCORER_PATH", None)
    BankingPlanner(cache_dir=tmp_path)
    assert planner_mod._ML_SCORER_PATH == tmp_path / "ml_scorer.json"


# ---------------------------------------------------------------------------
# One shared code path: plan() == submit().result()
# ---------------------------------------------------------------------------


def test_plan_is_thin_submit_result(solve_counter):
    """The blocking front door routes through the inline service."""
    planner = BankingPlanner()
    prog = _reader_program(stride=3, count=16, par=4)
    plan = planner.plan(prog, "table")
    assert plan.status == "solved" and len(solve_counter) == 1
    svc = planner.service
    assert svc.planner is planner
    # a submit for the same problem is answered from the plan() solve
    ticket = svc.submit(prog, "table")
    assert ticket.done() and len(solve_counter) == 1
    assert ticket.result().best.geometry == plan.best.geometry
    assert svc.stats.sync_hits >= 1


def test_legacy_free_functions_are_gone():
    import repro_torch.core as core
    assert not hasattr(core, "partition_memory")
    assert not hasattr(core, "partition_all")
    assert not hasattr(core, "BankingReport")


def test_table_row_reads_off_plan():
    plan = BankingPlanner().plan(_reader_program(), "table")
    row = plan.table_row()
    assert row["banks"] == plan.best.num_banks
    assert row["seconds"] == plan.solve_seconds
    assert row["lut"] == pytest.approx(plan.best.resources.total.lut)


def test_family_signature_ignores_solver_options():
    prog = _reader_program()
    planner = BankingPlanner()
    a = planner.plan(prog, "table", opts=SolverOptions(n_budget=8))
    b = planner.plan(prog, "table", opts=SolverOptions(n_budget=16))
    assert a.signature != b.signature      # options key the exact cache
    assert a.family == b.family            # ...but share a family
    c = planner.plan(_reader_program(stride=2), "table")
    assert c.family != a.family            # different polytopes differ
