# tests/test_telemetry.py of the JAX package, run against repro_torch: the same
# cases on the port's plan plane (CPU tensors where a case builds a server).
"""Measured-cost telemetry: observation log aggregation, cross-process
sidecar persistence, the "measured" scorer, demotion (exactly one
speculative re-solve), and the end-to-end self-correction loop --
serve a mis-ranked plan, measure it through Server.tick, demote,
re-solve, hot-swap to a measurably faster scheme."""

import json
import multiprocessing
import os
import time

import numpy as np
import pytest

from repro_torch.core import (AccessDecl, BankingPlanner, Counter, Ctrl,
                        FlatGeometry, MemorySpec, MemoryStore, PlanService,
                        Program, Sched, SolverOptions, compile_geometry)
from repro_torch.core import planner as planner_mod
from repro_torch.core.cost_model import MLScorer, ResourcePipeline
from repro_torch.core.features import FEATURE_NAMES
from repro_torch.core.polytope import Affine
from repro_torch.core.store import DirectoryStore
from repro_torch.core.telemetry import (DATA_OPS, MeasuredCost, MeasuredScorer,
                                  TelemetryConfig, TelemetryLog,
                                  roofline_floor_seconds,
                                  roofline_prior_seconds, scheme_hash,
                                  shape_bucket)


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
    """Counts cold solves at the universal chokepoint."""
    calls = []
    real = BankingPlanner.build_space

    def counting(self, prep):
        calls.append(1)
        return real(self, prep)

    monkeypatch.setattr(BankingPlanner, "build_space", counting)
    return calls


@pytest.fixture
def ml_isolation(monkeypatch, tmp_path):
    """Sandbox the process-wide ml-scorer globals: tests below retrain,
    refresh, and repoint the persisted pipeline without leaking into (or
    inheriting from) the rest of the suite."""
    saved = {k: planner_mod._ml_scorer_factory.__dict__.get(k)
             for k in ("_cached", "_cached_mtime")}
    monkeypatch.setattr(planner_mod, "_ML_SCORER_PATH",
                        tmp_path / "ml_scorer.json")
    for k in ("_cached", "_cached_mtime"):
        planner_mod._ml_scorer_factory.__dict__.pop(k, None)
    yield tmp_path / "ml_scorer.json"
    for k, v in saved.items():
        if v is None:
            planner_mod._ml_scorer_factory.__dict__.pop(k, None)
        else:
            planner_mod._ml_scorer_factory.__dict__[k] = v


# ---------------------------------------------------------------------------
# Records + log aggregation
# ---------------------------------------------------------------------------


def test_measured_cost_aggregation_and_roundtrip():
    rec = MeasuredCost(signature="sig", scheme="s1", backend="torch",
                       op="gather", bucket="8")
    for s in (1.0, 2.0, 3.0, 10.0):
        rec.observe(s)
    assert rec.count == 4 and rec.mean == pytest.approx(4.0)
    assert rec.p50() == pytest.approx(2.5)
    assert rec.p95() > rec.p50()
    other = MeasuredCost(signature="sig", scheme="s1", backend="torch",
                         op="gather", bucket="8")
    other.observe(20.0, prior=0.5)
    rec.merge(other)
    assert rec.count == 5
    assert rec.mean == pytest.approx((1 + 2 + 3 + 10 + 20) / 5)
    assert rec.prior == 0.5
    back = MeasuredCost.from_json(
        json.loads(json.dumps(rec.to_json())))
    assert back.key == rec.key and back.count == rec.count
    assert back.p50() == rec.p50() and back.prior == rec.prior


def test_shape_bucket_pow2_ceiling():
    assert shape_bucket((3,)) == "4"
    assert shape_bucket((4,)) == "4"
    assert shape_bucket((5, 17)) == "8x32"
    assert shape_bucket(()) == "scalar"
    assert shape_bucket(7) == "8"     # scalar count coerces
    assert shape_bucket((1,)) == "1"


def test_scheme_hash_is_structural_and_cached():
    mem = MemorySpec("m", dims=(64,), word_bits=16, ports=1)
    geo = FlatGeometry(N=4, B=8, alpha=(1,), P=(16,))
    a = compile_geometry(mem, geo, backend="numpy")
    b = compile_geometry(mem, geo, backend="numpy")
    assert scheme_hash(a) == scheme_hash(b)          # content, not identity
    assert a._scheme_hash == scheme_hash(a)          # cached on the object
    other = compile_geometry(
        mem, FlatGeometry(N=8, B=8, alpha=(1,), P=(8,)), backend="numpy")
    assert scheme_hash(other) != scheme_hash(a)


def test_log_pending_deltas_and_hydrate_do_not_double_count():
    log = TelemetryLog()
    log.observe("sig", "s1", "torch", "gather", (8,), 1.0, prior=0.25)
    log.observe("sig", "s1", "torch", "gather", (8,), 3.0)
    drained = log.drain()
    assert [r.count for r in drained["sig"]] == [2]
    assert log.drain() == {}                      # deltas cleared
    count, p50 = log.scheme_measured("s1")        # cumulative view intact
    assert count == 2 and p50 == pytest.approx(2.0)
    # hydrating store-side history merges reads without re-flushing
    foreign = MeasuredCost(signature="sig", scheme="s1", backend="torch",
                           op="gather", bucket="8")
    foreign.observe(5.0)
    assert log.hydrate([foreign]) == 1
    count, _ = log.scheme_measured("s1")
    assert count == 3 and log.drain() == {}
    assert log.calibration() == pytest.approx(log.scheme_measured("s1")[1]
                                              / 0.25)


# ---------------------------------------------------------------------------
# Cross-process persistence (concurrent, lossless)
# ---------------------------------------------------------------------------


def _telemetry_worker(dirpath, sig, tag, n):
    from repro_torch.core.store import DirectoryStore as DS
    from repro_torch.core.telemetry import MeasuredCost as MC

    store = DS(dirpath)
    for i in range(n):
        rec = MC(signature=sig, scheme=f"s{tag}", backend="torch",
                 op="gather", bucket="8")
        rec.observe(0.001 * (i + 1))
        store.merge_telemetry(sig, [rec])


def test_two_processes_merge_telemetry_without_loss(tmp_path):
    """Two processes hammering one DirectoryStore sidecar with per-call
    deltas: the read-merge-write under the store lock loses nothing.  The
    workers are spawned, not forked: this process runs service threads
    (and, on a machine with a card, a CUDA context) that a fork would
    copy in an undefined state."""
    n = 20
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_telemetry_worker,
                         args=(str(tmp_path), "sigX", tag, n))
             for tag in ("a", "b")]
    for p in procs:
        p.start()
    for p in procs:
        p.join(60)
        assert p.exitcode == 0
    recs = DirectoryStore(tmp_path).get_telemetry("sigX")
    by_scheme = {r.scheme: r for r in recs}
    assert set(by_scheme) == {"sa", "sb"}
    assert by_scheme["sa"].count == n and by_scheme["sb"].count == n
    assert by_scheme["sa"].mean == pytest.approx(
        0.001 * (n + 1) / 2)


def test_torn_telemetry_sidecar_reads_as_miss_and_heals(tmp_path):
    store = DirectoryStore(tmp_path)
    rec = MeasuredCost(signature="sigY", scheme="s1", backend="torch",
                       op="gather", bucket="4")
    rec.observe(2.0)
    store.merge_telemetry("sigY", [rec])
    path = store.telemetry_path("sigY")
    blob = path.read_text()
    path.write_text(blob[: len(blob) // 2])          # torn mid-write
    assert store.get_telemetry("sigY") == []
    # foreign format is also a miss
    path.write_text(json.dumps({"format": "something-else"}))
    assert store.get_telemetry("sigY") == []
    # the next merge heals the sidecar
    store.merge_telemetry("sigY", [rec.copy()])
    healed = store.get_telemetry("sigY")
    assert len(healed) == 1 and healed[0].count == 1
    assert json.loads(path.read_text())["format"]


def test_memory_store_telemetry_and_delete():
    store = MemoryStore()
    rec = MeasuredCost(signature="sigZ", scheme="s1", backend="torch",
                       op="gather", bucket="4")
    rec.observe(1.0)
    store.merge_telemetry("sigZ", [rec])
    store.merge_telemetry("sigZ", [rec.copy()])
    got = store.get_telemetry("sigZ")
    assert len(got) == 1 and got[0].count == 2
    got[0].observe(9.0)                     # copies: no cache poisoning
    assert store.get_telemetry("sigZ")[0].count == 2


# ---------------------------------------------------------------------------
# Priors + the "measured" scorer
# ---------------------------------------------------------------------------


def test_roofline_prior_orders_schemes_by_serialization():
    mem = MemorySpec("m", dims=(64,), word_bits=16, ports=1)
    free = compile_geometry(mem, FlatGeometry(N=8, B=8, alpha=(1,), P=(8,)),
                            backend="numpy")
    free.fan_outs = (1,)
    slow = compile_geometry(mem, FlatGeometry(N=1, B=1, alpha=(1,), P=(1,)),
                            backend="numpy")
    slow.fan_outs = (8,)                     # fully serialized
    assert roofline_prior_seconds(slow) > 2 * roofline_prior_seconds(free)
    assert roofline_prior_seconds(free) >= roofline_floor_seconds()


def test_measured_scorer_flips_ranking_on_contradicting_measurements():
    """Static prediction ranks A first; once the log holds measurements
    showing A slow and B fast, the measured blend flips the order."""
    plan = BankingPlanner().plan(_reader_program(),
                                 "table", opts=SolverOptions(n_budget=8))
    assert len(plan.solutions) >= 2
    a, b = plan.solutions[0], plan.solutions[1]
    static_rank = {scheme_hash(a): 1.0, scheme_hash(b): 2.0}
    log = TelemetryLog()
    scorer = MeasuredScorer(log=log,
                            static=lambda s: static_rank[scheme_hash(s)])
    assert scorer(a) < scorer(b)             # empty log: static wins
    # hardware disagrees: A measured 10x slower than B
    for _ in range(8):
        log.observe("sig", scheme_hash(a), "torch", "gather", (8,), 1e-3,
                    prior=roofline_prior_seconds(a))
        log.observe("sig", scheme_hash(b), "torch", "gather", (8,), 1e-4,
                    prior=roofline_prior_seconds(b))
    assert scorer(a) > scorer(b)             # ranking flipped
    # a never-measured scheme ranks by calibrated prior, not the static fn
    if len(plan.solutions) > 2:
        c = plan.solutions[2]
        expected = log.calibration() * roofline_prior_seconds(c)
        assert scorer(c) == pytest.approx(expected)


def test_measured_scorer_registered_in_registry():
    from repro_torch.core.planner import resolve_scorer

    name, fn = resolve_scorer("measured")
    assert name == "measured" and isinstance(fn, MeasuredScorer)


# ---------------------------------------------------------------------------
# Demotion: exactly one speculative re-solve
# ---------------------------------------------------------------------------


def test_demotion_triggers_exactly_one_resolve(solve_counter):
    svc = PlanService(store=MemoryStore(), workers=1)
    hub = svc.enable_telemetry(TelemetryConfig(min_observations=4,
                                               demote_ratio=2.0,
                                               flush_every=0))
    plan = svc.submit(_reader_program(), "table",
                      opts=SolverOptions(n_budget=8)).result()
    # the ticket resolves before _finish registers the plan with
    # telemetry; drain returns after the worker's task_done, which follows
    # the register, so no observation below can find the plan unknown
    assert svc.drain(timeout=30)
    assert len(solve_counter) == 1
    art = svc.planner.compile(plan, backend="numpy")
    assert art._telemetry is hub
    # a measured sibling scheme is 100x faster than the served one
    hub.log.observe(plan.signature, "rival-scheme", "numpy", "gather",
                    (8,), 1e-5)
    for _ in range(hub.config.min_observations):
        hub.observe(art, "gather", (8,), 1e-3)
    assert svc.stats.demotions == 1
    assert svc.drain(timeout=60)
    assert len(solve_counter) == 2           # exactly one re-solve
    key = (plan.signature, plan.scorer_name)
    ticket = hub.replacement(key)
    assert ticket is not None and ticket.result() is not None
    assert hub.replacement(key) is None      # pop-once
    # keep hammering: no resubmit storm
    for _ in range(20):
        hub.observe(art, "gather", (8,), 1e-3)
    svc.drain(timeout=60)
    assert svc.stats.demotions == 1 and len(solve_counter) == 2
    assert svc.stats.observations == 4 + 20


def test_no_demotion_without_enough_evidence_or_margin():
    svc = PlanService(store=MemoryStore(), workers=1)
    hub = svc.enable_telemetry(TelemetryConfig(min_observations=8,
                                               demote_ratio=2.0,
                                               flush_every=0))
    plan = svc.submit(_reader_program(), "table",
                      opts=SolverOptions(n_budget=8)).result()
    art = svc.planner.compile(plan, backend="numpy")
    hub.log.observe(plan.signature, "rival-scheme", "numpy", "gather",
                    (8,), 1e-5)
    for _ in range(7):                        # below min_observations
        hub.observe(art, "gather", (8,), 1e-3)
    assert svc.stats.demotions == 0
    # measured but NOT persistently worse than the rival's estimate
    svc2 = PlanService(store=MemoryStore(), workers=1)
    hub2 = svc2.enable_telemetry(TelemetryConfig(min_observations=4,
                                                 demote_ratio=2.0,
                                                 flush_every=0))
    plan2 = svc2.submit(_reader_program(), "table",
                        opts=SolverOptions(n_budget=8)).result()
    art2 = svc2.planner.compile(plan2, backend="numpy")
    hub2.log.observe(plan2.signature, "rival-scheme", "numpy", "gather",
                     (8,), 1e-3)
    for _ in range(8):
        hub2.observe(art2, "gather", (8,), 1.5e-3)   # within 2x of rival
    assert svc2.stats.demotions == 0


# ---------------------------------------------------------------------------
# Online refresh
# ---------------------------------------------------------------------------


def test_refresh_refits_ml_scorer_from_measured_pairs(ml_isolation):
    ml_path = ml_isolation
    svc = PlanService(store=MemoryStore(), workers=1)
    hub = svc.enable_telemetry(TelemetryConfig(flush_every=0))
    plan = svc.submit(_reader_program(), "table",
                      opts=SolverOptions(n_budget=8)).result()
    # the worker registers the plan's features with the hub just after
    # the ticket resolves: wait for it, or refresh() races the worker
    assert svc.drain(30)
    assert hub.refresh() is False             # nothing measured yet
    assert len(plan.solutions) >= 2
    for sol, secs in zip(plan.solutions[:2], (1e-3, 1e-4)):
        for _ in range(4):
            hub.log.observe(plan.signature, scheme_hash(sol), "torch",
                            "gather", (8,), secs,
                            prior=roofline_prior_seconds(sol))
    assert hub.refresh() is True
    assert svc.stats.refreshes == 1
    assert ml_path.exists()
    refit = MLScorer.from_json(json.loads(ml_path.read_text()))
    assert "measured_us" in refit.pipelines
    # the persisted refit IS what the "ml" registry entry now resolves
    resolved = planner_mod._ml_scorer_factory()
    assert "measured_us" in resolved.pipelines


def test_with_pipeline_returns_copy():
    rng = np.random.default_rng(0)
    X = rng.random((24, len(FEATURE_NAMES)))
    pipe = ResourcePipeline(gbt_params=dict(n_estimators=3)).fit(
        X, rng.random(24))
    base = MLScorer({"lut": pipe}, weights={"lut": 1.0})
    grafted = base.with_pipeline("measured_us", pipe, weight=2.0)
    assert "measured_us" in grafted.pipelines
    assert "measured_us" not in base.pipelines       # no mutation
    assert grafted.weights["measured_us"] == 2.0


# ---------------------------------------------------------------------------
# set_ml_scorer_path invalidation + mtime reload
# ---------------------------------------------------------------------------


def _tiny_scorer_json(weight):
    rng = np.random.default_rng(int(weight))
    X = rng.random((24, len(FEATURE_NAMES)))
    pipe = ResourcePipeline(gbt_params=dict(n_estimators=3)).fit(
        X, rng.random(24))
    return MLScorer({"lut": pipe}, weights={"lut": float(weight)}).to_json()


def test_set_ml_scorer_path_invalidates_and_mtime_reloads(ml_isolation,
                                                          tmp_path):
    from repro_torch.core.planner import resolve_scorer, set_ml_scorer_path

    path_a = tmp_path / "a" / "ml_scorer.json"
    path_b = tmp_path / "b" / "ml_scorer.json"
    for p, w in ((path_a, 1.0), (path_b, 2.0)):
        p.parent.mkdir()
        p.write_text(json.dumps(_tiny_scorer_json(w)))
    set_ml_scorer_path(path_a)
    first = resolve_scorer("ml")[1]
    assert first.weights["lut"] == 1.0
    assert resolve_scorer("ml")[1] is first          # cached, same path
    # switching the path must drop the cached scorer
    set_ml_scorer_path(path_b)
    second = resolve_scorer("ml")[1]
    assert second is not first and second.weights["lut"] == 2.0
    # refreshing the file on disk (mtime advances) must reload
    path_b.write_text(json.dumps(_tiny_scorer_json(3.0)))
    bumped = time.time() + 2
    os.utime(path_b, (bumped, bumped))
    third = resolve_scorer("ml")[1]
    assert third is not second and third.weights["lut"] == 3.0
    assert resolve_scorer("ml")[1] is third          # stable again


# ---------------------------------------------------------------------------
# The roofline prior reads the card's constant, not the env
# ---------------------------------------------------------------------------


def test_roofline_bandwidth_is_the_h100_figure_and_leaves_env_alone(
        monkeypatch):
    from repro_torch.core import telemetry
    from repro_torch.launch import roofline

    monkeypatch.setenv("XLA_FLAGS", "--some-user-flag")
    # the NVIDIA H100's copy rate that chip_smoke.py's roofline_probe
    # measured (below the data sheet's 3.35 TB/s); priors and the floor
    # are per-scheme constants over it
    assert telemetry.roofline_bandwidth() == roofline.HBM_BW
    assert 1e12 < roofline.HBM_BW < 3.35e12
    assert telemetry.roofline_floor_seconds() == pytest.approx(
        telemetry.PRIOR_ROWS * 16 / 8.0 / roofline.HBM_BW)
    assert os.environ["XLA_FLAGS"] == "--some-user-flag"


# ---------------------------------------------------------------------------
# Stats surface
# ---------------------------------------------------------------------------


def test_service_stats_as_dict_has_telemetry_counters():
    svc = PlanService(store=MemoryStore())
    d = svc.stats.as_dict()
    for key in ("observations", "refreshes", "demotions", "submits",
                "sync_hits", "solved"):
        assert key in d and d[key] == 0
    svc.stats.observations += 3
    assert svc.stats.as_dict()["observations"] == 3
    json.dumps(svc.stats.as_dict())                  # JSON-serializable


def test_serve_launcher_wires_telemetry_flag(tmp_path, monkeypatch):
    """launch/serve.py --telemetry enables the hub on the service and
    submits the KV plan under scorer="measured" (smoke: wiring only)."""
    import sys

    from repro_torch.core import service as service_mod
    from repro_torch.launch import serve as serve_mod

    seen = {}

    class SpyService(service_mod.PlanService):
        def enable_telemetry(self, config=None, log=None):
            seen["enabled"] = True
            return super().enable_telemetry(config, log)

    class Bail(Exception):
        pass

    def stop(*a, **kw):
        raise Bail()

    monkeypatch.setattr("repro_torch.core.service.PlanService", SpyService)
    monkeypatch.setattr("repro_torch.configs.get_arch", stop, raising=False)
    monkeypatch.setattr(sys, "argv",
                        ["serve", "--arch", "qwen2_7b", "--smoke",
                         "--plan-store", str(tmp_path),
                         "--telemetry", "--stats-interval", "30"])
    with pytest.raises(Bail):
        serve_mod.main()
    assert seen == {"enabled": True}


# ---------------------------------------------------------------------------
# Timing hooks: off by default, measurable when on, ~free when off
# ---------------------------------------------------------------------------


class _SinkSpy:
    def __init__(self):
        self.calls = []

    def observe(self, art, op, shape, seconds):
        self.calls.append((op, tuple(shape), seconds))


def test_timing_hooks_opt_in_and_zero_cost_when_off():
    mem = MemorySpec("m", dims=(64,), word_bits=16, ports=1)
    art = compile_geometry(mem, FlatGeometry(N=4, B=16, alpha=(1,), P=(16,)),
                           backend="numpy")
    table = np.arange(64 * 2, dtype=np.int32).reshape(64, 2)
    packed = np.asarray(art.pack(table, device="cpu"))
    rows = np.arange(8)
    assert art._telemetry is None                    # off by default
    sink = _SinkSpy()
    art.enable_telemetry(sink)
    out = np.asarray(art.gather(packed, rows))
    np.testing.assert_array_equal(out, table[rows])  # identical results
    packed2 = art.scatter(packed, rows, out)
    assert [c[0] for c in sink.calls] == ["gather", "scatter"]
    assert all(c[2] >= 0 for c in sink.calls)
    art.disable_telemetry()
    art.gather(packed2, rows)
    assert len(sink.calls) == 2                      # nothing new logged
    # hooks-off per-call overhead ~ 0: wrapped (no sink) vs raw inner path
    reps = 300

    def median_time(fn):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    direct = median_time(lambda: art._gather(packed, rows))
    wrapped = median_time(lambda: art.gather(packed, rows))
    assert wrapped <= direct * 1.5 + 50e-6


# ---------------------------------------------------------------------------
# End-to-end self-correction
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_server_demotes_mis_ranked_plan_and_hot_swaps(tmp_path,
                                                      ml_isolation,
                                                      monkeypatch):
    """Serve from a deliberately mis-ranked stored plan; measured
    gather/scatter latencies recorded through Server.tick demote it, the
    service re-solves speculatively, and the server hot-swaps to a scheme
    whose measured cost is lower -- ServiceStats counting each step."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core.planner import BankingPlan
    from repro_torch.models import get_model
    from repro_torch.runtime.server import Request, Server, page_ticket, \
        _page_program

    store_dir = tmp_path / "plans"
    # -- plant the mis-ranked plan: the WORST-prior candidate, stored as
    #    the "measured" scorer's answer ----------------------------------
    seed_planner = BankingPlanner(store=DirectoryStore(store_dir))
    opts = SolverOptions(b_candidates=(8, 1), allow_multidim=False)
    plan0 = seed_planner.plan(_page_program(32, 8, 4), "kv_pool", opts=opts)
    assert len(plan0.solutions) >= 2
    bad = max(plan0.solutions, key=roofline_prior_seconds)
    bad_hash = scheme_hash(bad)
    # mis-ranked by construction: its analytic prior alone exceeds the
    # demotion threshold over the conflict-free floor
    assert roofline_prior_seconds(bad) > 2.0 * roofline_floor_seconds()
    planted = BankingPlan(
        memory="kv_pool", signature=plan0.signature, best=bad,
        scorer_name="measured", status="solved", created_at=time.time(),
        opts=opts, family=plan0.family)
    DirectoryStore(store_dir).put(planted)

    svc = PlanService(store=DirectoryStore(store_dir), workers=2)
    hub = svc.enable_telemetry(TelemetryConfig(min_observations=4,
                                               demote_ratio=2.0,
                                               flush_every=8))
    # plain-version CPU timing can't see bank conflicts; inflate the bad
    # scheme's observed latency so measurements contradict its ranking
    # the way real hardware would (plumbing stays fully real)
    real_observe = TelemetryLog.observe

    def skewed(self, signature, scheme, backend, op, shape, seconds,
               prior=0.0):
        if scheme == bad_hash and op in DATA_OPS:
            seconds *= 50.0
        return real_observe(self, signature, scheme, backend, op, shape,
                            seconds, prior=prior)

    monkeypatch.setattr(TelemetryLog, "observe", skewed)

    ticket = page_ticket(None, max_len=32, page=8, readers=4,
                         service=svc, scorer="measured")
    assert ticket.done()                      # planted plan answered it
    assert scheme_hash(ticket.result().best) == bad_hash
    assert svc.stats.sync_hits == 1

    cfg = get_arch("qwen2_7b").reduced()
    cfg = dataclasses.replace(cfg, n_layers=1, d_model=32, d_ff=64,
                              vocab=64, n_heads=2, n_kv_heads=2,
                              head_dim=16)
    server = Server(get_model(cfg), max_batch=2, max_len=32,
                    kv_plan=ticket, device="cpu")
    assert scheme_hash(server._kv_art) == bad_hash   # serving the loser

    rng = np.random.default_rng(0)
    uid = 0
    settle = 6       # post-swap ticks: measure the replacement scheme too
    for _ in range(200):
        if not server.queue and len(server.active) < 2:
            prompt = rng.integers(2, 60, size=3).astype(np.int32)
            server.submit(Request(uid=uid, prompt=prompt, max_new=8))
            uid += 1
        server.tick()
        if svc.stats.demotions and server.swaps:
            settle -= 1
            if settle <= 0:
                break
    # the loop self-corrected: demoted, re-solved, hot-swapped
    assert svc.stats.demotions == 1
    assert svc.stats.observations > 0
    final = server._kv_art
    final_hash = scheme_hash(final)
    assert final_hash != bad_hash
    assert server.swaps >= 1
    # the winner is measurably faster than the demoted loser
    bad_count, bad_p50 = hub.log.scheme_measured(bad_hash)
    new_count, new_p50 = hub.log.scheme_measured(final_hash)
    assert bad_count >= 4 and new_count > 0
    assert new_p50 < bad_p50
    # the loser lost its cache slot everywhere
    store = DirectoryStore(store_dir)
    replacement_plan = store.get(plan0.signature, "measured")
    assert replacement_plan is not None
    assert scheme_hash(replacement_plan.best) != bad_hash
    # observations persisted through the sidecar (flush cadence + final)
    hub.flush()
    persisted = store.get_telemetry(plan0.signature)
    assert any(r.scheme == bad_hash for r in persisted)
    # and the accumulated (features, measured) pairs refresh the ml model
    assert hub.refresh() is True
    assert svc.stats.refreshes >= 1
    assert ml_isolation.exists()
