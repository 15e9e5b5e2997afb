# tests/test_store.py of the JAX package, run against repro_torch: the same
# cases on the port's plan plane (CPU tensors where a case builds a server).
"""Plan stores: cross-process DirectoryStore (lock contention, torn JSON
as a miss, legacy cache_dir layout equivalence) and MemoryStore."""

import json
import os
import threading
import time

import pytest

from repro_torch.core import (AccessDecl, BankingPlanner, Counter, Ctrl,
                        MemorySpec, Program, Sched, SolverOptions)
from repro_torch.core.polytope import Affine
from repro_torch.core.store import DirectoryStore, FileLock, MemoryStore


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
    """Counts cold solves at the universal chokepoint (candidate-space
    enumeration) -- every solve path passes through build_space."""
    calls = []
    real = BankingPlanner.build_space

    def counting(self, prep):
        calls.append(1)
        return real(self, prep)

    monkeypatch.setattr(BankingPlanner, "build_space", counting)
    return calls


# ---------------------------------------------------------------------------
# MemoryStore
# ---------------------------------------------------------------------------


def test_memory_store_roundtrip_and_family():
    planner = BankingPlanner(store=MemoryStore())
    a = planner.plan(_reader_program(), "table",
                     opts=SolverOptions(n_budget=8))
    store = planner.store
    assert store.get(a.signature, a.scorer_name).signature == a.signature
    assert store.get("nope", "proxy") is None
    assert store.get_artifact(a.signature, a.scorer_name, "torch") is None
    art = planner.compile(a)
    assert store.get_artifact(a.signature, a.scorer_name,
                              "torch").signature == art.signature
    near = store.find_family(a.family)
    assert near is not None and near.signature == a.signature
    assert store.find_family(a.family,
                             exclude_signature=a.signature) is None


def test_memory_store_shared_between_planners(solve_counter):
    store = MemoryStore()
    BankingPlanner(store=store).plan(_reader_program(), "table")
    hit = BankingPlanner(store=store).plan(_reader_program(), "table")
    assert hit.status == "cached-disk" and len(solve_counter) == 1


# ---------------------------------------------------------------------------
# DirectoryStore: legacy layout equivalence
# ---------------------------------------------------------------------------


def test_directory_store_uses_legacy_cache_dir_layout(tmp_path,
                                                      solve_counter):
    """A directory written through cache_dir= reads through DirectoryStore
    and vice versa -- same files, same warm-start behaviour."""
    old = BankingPlanner(cache_dir=tmp_path)
    plan = old.plan(_reader_program(), "table")
    old.compile(plan)
    assert isinstance(old.store, DirectoryStore)   # cache_dir IS a store now
    # the store API reads what cache_dir wrote, at the documented paths
    store = DirectoryStore(tmp_path)
    assert store.plan_path(plan.signature, "proxy").exists()
    assert store.artifact_path(plan.signature, "proxy", "torch").exists()
    got = store.get(plan.signature, "proxy")
    assert got.best.geometry == plan.best.geometry
    assert store.get_artifact(plan.signature, "proxy",
                              "torch").layout == old.compile(plan).layout
    # a second planner over the same directory: disk hit, zero solves
    warm = BankingPlanner(store=DirectoryStore(tmp_path))
    hit = warm.plan(_reader_program(), "table")
    assert hit.status == "cached-disk" and len(solve_counter) == 1
    # warm_start() preloads plans + artifacts from a store or a path
    fresh = BankingPlanner()
    assert fresh.warm_start(tmp_path) == 2
    assert fresh.plan(_reader_program(), "table").status == "cached"
    assert len(solve_counter) == 1
    # ...and single-file warm starts work for both file kinds
    solo = BankingPlanner()
    assert solo.warm_start(store.plan_path(plan.signature, "proxy")) == 1
    assert solo.warm_start(
        store.artifact_path(plan.signature, "proxy", "torch")) == 1
    solo.compile(solo.plan(_reader_program(), "table"))
    assert solo.stats.compiles == 0 and solo.stats.compile_hits == 1


def test_torn_json_reads_as_miss_and_heals(tmp_path, solve_counter):
    """A partially-written plan file (torn write, crashed process) is a
    miss -- the reader re-solves and the write path repairs the entry."""
    planner = BankingPlanner(cache_dir=tmp_path)
    plan = planner.plan(_reader_program(), "table")
    store = DirectoryStore(tmp_path)
    path = store.plan_path(plan.signature, "proxy")
    blob = path.read_text()
    path.write_text(blob[: len(blob) // 2])       # torn mid-write
    assert store.get(plan.signature, "proxy") is None
    repaired = BankingPlanner(cache_dir=tmp_path)
    again = repaired.plan(_reader_program(), "table")
    assert again.status == "solved" and len(solve_counter) == 2
    assert json.loads(path.read_text())["signature"] == plan.signature
    # foreign / wrong-format JSON is also just a miss
    path.write_text(json.dumps({"format": "something-else"}))
    assert store.get(plan.signature, "proxy") is None


# ---------------------------------------------------------------------------
# Eviction + signature versioning
# ---------------------------------------------------------------------------


def test_size_capped_lru_eviction(tmp_path):
    """A max_bytes store evicts least-recently-used entries (by mtime)
    after each write; recently-read entries are touched and survive."""
    probe = DirectoryStore(tmp_path)
    planner = BankingPlanner(store=probe)
    plans = [planner.plan(_reader_program(stride=s), "table",
                          opts=SolverOptions(n_budget=6, max_solutions=4))
             for s in (1, 2, 3)]
    sizes = [probe.plan_path(p.signature, "proxy").stat().st_size
             for p in plans]
    # cap fits roughly two entries -> writing a third must evict one
    capped = DirectoryStore(tmp_path, max_bytes=sizes[0] + sizes[1]
                            + sizes[2] // 2)
    # age the files oldest-first so LRU order is deterministic
    now = time.time()
    for i, p in enumerate(plans):
        path = capped.plan_path(p.signature, "proxy")
        os.utime(path, (now - 100 + i, now - 100 + i))
    # reading the OLDEST entry freshens it...
    assert capped.get(plans[0].signature, "proxy") is not None
    # ...so the write-triggered eviction takes the now-oldest instead
    capped.put(plans[0])
    assert capped.get(plans[1].signature, "proxy") is None      # evicted
    assert capped.get(plans[0].signature, "proxy") is not None  # touched
    total = sum(f.stat().st_size for f in tmp_path.glob("bp*.json"))
    assert total <= capped.max_bytes


def test_sweep_collects_stale_signature_versions(tmp_path):
    """sweep() removes entries whose filename signature carries a stale
    SIGNATURE_VERSION prefix -- and nothing else (foreign files like the
    persisted ml scorer share the directory)."""
    store = DirectoryStore(tmp_path)
    planner = BankingPlanner(store=store)
    plan = planner.plan(_reader_program(), "table",
                        opts=SolverOptions(n_budget=6, max_solutions=4))
    live = store.plan_path(plan.signature, "proxy")
    stale_sig = "bp0-" + plan.signature.split("-", 1)[1]
    stale = tmp_path / f"{stale_sig}.proxy.json"
    stale.write_text(live.read_text())
    stale_art = tmp_path / f"{stale_sig}.proxy.torch.compiled.json"
    stale_art.write_text("{}")
    foreign = tmp_path / "ml_scorer.json"
    foreign.write_text("{}")
    assert store.sweep() == 2
    assert not stale.exists() and not stale_art.exists()
    assert live.exists() and foreign.exists()
    assert store.get(plan.signature, "proxy") is not None
    assert store.sweep() == 0        # idempotent


def test_serve_launcher_wires_store_cap(tmp_path, monkeypatch):
    """launch/serve.py --plan-store-max-mb builds a capped store and
    sweeps it at startup (smoke: flag parsing + wiring only)."""
    import sys

    from repro_torch.launch import serve as serve_mod

    built = {}
    real_store = serve_mod.__dict__.get("DirectoryStore")  # noqa: F841

    class SpyStore(DirectoryStore):
        def __init__(self, path, **kw):
            super().__init__(path, **kw)
            built["max_bytes"] = self.max_bytes

        def sweep(self):
            built["swept"] = True
            return super().sweep()

    class Bail(Exception):
        pass

    def stop(*a, **kw):
        raise Bail()

    monkeypatch.setattr("repro_torch.core.store.DirectoryStore", SpyStore)
    monkeypatch.setattr("repro_torch.configs.get_arch", stop, raising=False)
    monkeypatch.setattr(sys, "argv",
                        ["serve", "--arch", "qwen2_7b", "--smoke",
                         "--plan-store", str(tmp_path),
                         "--plan-store-max-mb", "2"])
    with pytest.raises(Bail):
        serve_mod.main()
    assert built == {"max_bytes": 2 * 2 ** 20, "swept": True}


# ---------------------------------------------------------------------------
# Lock file
# ---------------------------------------------------------------------------


def test_file_lock_mutual_exclusion(tmp_path):
    lock_path = tmp_path / "x.lock"
    counter = {"v": 0}
    errors = []

    def bump():
        try:
            for _ in range(25):
                with FileLock(lock_path, timeout=10.0):
                    v = counter["v"]
                    time.sleep(0.0002)       # widen the race window
                    counter["v"] = v + 1
        except BaseException as e:  # pragma: no cover - failure reporting
            errors.append(e)

    threads = [threading.Thread(target=bump) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert counter["v"] == 100
    assert not lock_path.exists()           # released


def test_stale_lock_is_broken_not_deadlocked(tmp_path):
    lock_path = tmp_path / "x.lock"
    lock_path.write_text("999999")          # a crashed holder's leftover
    old = time.time() - 3600
    os.utime(lock_path, (old, old))
    with FileLock(lock_path, timeout=2.0, stale_seconds=30.0):
        pass                                 # acquired by breaking the stale


def test_lock_timeout_raises(tmp_path):
    lock_path = tmp_path / "x.lock"
    with FileLock(lock_path, timeout=5.0):
        inner = FileLock(lock_path, timeout=0.05, stale_seconds=3600.0)
        with pytest.raises(TimeoutError):
            inner.acquire()


# ---------------------------------------------------------------------------
# Cross-process concurrency (two planners = two "processes" on one dir)
# ---------------------------------------------------------------------------


def test_two_planners_share_one_directory_concurrently(tmp_path):
    """Several planners hammer one DirectoryStore with the same and with
    distinct problems concurrently: every plan resolves, the shared files
    stay valid JSON, and the store ends deduplicated by signature."""
    programs = [_reader_program(stride=s) for s in (1, 2, 3)]
    planners = [BankingPlanner(store=DirectoryStore(tmp_path))
                for _ in range(2)]
    results, errors = [], []

    def worker(i):
        try:
            p = planners[i % 2].plan(programs[i % 3], "table")
            results.append(p)
        except BaseException as e:  # pragma: no cover - failure reporting
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(results) == 8
    assert all(p.best is not None for p in results)
    # same stride -> same signature, regardless of which planner solved it
    sigs = {}
    for p in results:
        sigs.setdefault(p.signature, set()).add(p.best.geometry)
    assert len(sigs) == 3
    assert all(len(geos) == 1 for geos in sigs.values())
    # every persisted file is whole, valid JSON in the legacy layout
    files = [f for f in tmp_path.glob("*.json")]
    assert len([f for f in files if not f.name.endswith(".compiled.json")]) \
        == 3
    for f in files:
        assert json.loads(f.read_text())["signature"]
    # and a third "process" warm-starts entirely from the shared directory
    third = BankingPlanner(store=DirectoryStore(tmp_path))
    for prog in programs:
        assert third.plan(prog, "table").status == "cached-disk"
