"""Pluggable plan stores: plans and compiled artifacts shared across
planners -- and across *processes*.

``BankingPlanner`` used to own its durability story directly: an in-memory
dict fronting a directory of ``<signature>.<scorer>.json`` plans (and
``*.compiled.json`` artifacts).  That worked for one process warm-starting
the next, but the service front door (:mod:`repro_torch.core.service`) needs the
same plans visible to many planners at once -- several serving processes
sharing one plan directory, a solve in one process answering submits in
another.  This module factors the storage layer out behind a small ABC:

* :class:`MemoryStore` -- a thread-safe in-process dict; the default when
  no durability is requested.
* :class:`DirectoryStore` -- a directory of JSON plans using **exactly the
  layout the planner's old ``cache_dir=`` wrote** (``<sig>.<scorer>.json``
  beside ``<sig>.<scorer>.<backend>.compiled.json``), so existing plan
  directories keep working.  Writes go through a lock file (O_CREAT|O_EXCL,
  the only primitive that is atomic on every POSIX filesystem including
  NFS) plus the existing tmp-file + rename dance; reads take no lock and
  tolerate torn or partial JSON as a cache miss -- a reader racing a
  writer re-solves rather than crashing.

Stores also index plans by **family** -- the problem signature *minus* the
solver options -- which is what lets the service's stale-while-revalidate
policy answer a submit whose options drifted from a stored near-match
while the exact solve runs in the background.
"""

from __future__ import annotations

import abc
import json
import os
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple, Union

from .artifact import CompiledBankingPlan

# JSON syntax/shape problems a torn or foreign file can produce; every
# store read path treats these as a miss.
_MISS_ERRORS = (ValueError, KeyError, TypeError, json.JSONDecodeError,
                OSError)


def _safe(scorer_name: str) -> str:
    """Scorer names may embed ':' / '/' (custom callables); keep the file
    layout identical to what ``BankingPlanner(cache_dir=...)`` wrote."""
    return scorer_name.replace(":", "_").replace("/", "_")


class PlanStore(abc.ABC):
    """Where durable plans (and their compiled artifacts) live.

    Keys are (canonical signature, scorer name) for plans and
    (signature, scorer name, backend) for artifacts; ``find_family`` serves
    the stale-while-revalidate near-match lookup.  Implementations must be
    safe to call from multiple threads; :class:`DirectoryStore` is also
    safe across processes.
    """

    # -- plans ---------------------------------------------------------------
    @abc.abstractmethod
    def get(self, signature: str, scorer_name: str):
        """The stored plan, or ``None`` (damaged entries read as None)."""

    @abc.abstractmethod
    def put(self, plan) -> None:
        """Persist ``plan`` (keyed by its signature + scorer_name)."""

    # -- compiled artifacts ---------------------------------------------------
    @abc.abstractmethod
    def get_artifact(self, signature: str, scorer_name: str,
                     backend: str) -> Optional[CompiledBankingPlan]:
        ...

    @abc.abstractmethod
    def put_artifact(self, artifact: CompiledBankingPlan) -> None:
        ...

    # -- enumeration / near-match ---------------------------------------------
    @abc.abstractmethod
    def plans(self) -> Iterable:
        """Every readable plan (damaged entries skipped)."""

    @abc.abstractmethod
    def artifacts(self) -> Iterable[CompiledBankingPlan]:
        """Every readable compiled artifact (damaged entries skipped)."""

    def find_family(self, family: str, *,
                    exclude_signature: str = "") -> Optional["object"]:
        """Newest stored plan of the same problem *family* (same memory +
        access polytopes, any solver options/scorer) -- the near-match that
        stale-while-revalidate serves while the exact solve runs."""
        if not family:
            return None
        best = None
        for plan in self.plans():
            if (getattr(plan, "family", "") == family
                    and plan.signature != exclude_signature
                    and plan.best is not None):
                if best is None or plan.created_at > best.created_at:
                    best = plan
        return best

    # -- telemetry sidecar ------------------------------------------------------
    def get_telemetry(self, signature: str) -> list:
        """Persisted :class:`~repro_torch.core.telemetry.MeasuredCost` records
        for one plan signature ([] when the store keeps none)."""
        return []

    def merge_telemetry(self, signature: str, records) -> None:
        """Fold observation *deltas* into the stored records for
        ``signature`` (no-op for stores without telemetry support)."""

    # -- certificate sidecar ----------------------------------------------------
    def get_certificate(self, signature: str, scorer_name: str):
        """Persisted conflict certificate for one plan (``None`` when the
        store keeps none)."""
        return None

    def put_certificate(self, signature: str, scorer_name: str,
                        cert: dict) -> None:
        """Persist a conflict certificate beside its plan (no-op for
        stores without certificate support)."""

    # -- joint-plan sidecar ------------------------------------------------------
    def get_joint(self, signature: str):
        """Persisted :class:`~repro_torch.core.jointplan.JointPlan` for one
        ``jp1-`` joint signature (``None`` when the store keeps none)."""
        return None

    def put_joint(self, plan) -> None:
        """Persist a whole-model joint plan (no-op for stores without
        joint-plan support)."""

    # -- demotion ---------------------------------------------------------------
    def delete(self, signature: str, scorer_name: str) -> None:
        """Drop a stored plan and its compiled artifacts -- how demotion
        evicts a loser (no-op for stores without delete support)."""


# ---------------------------------------------------------------------------
# In-process store
# ---------------------------------------------------------------------------


class MemoryStore(PlanStore):
    """Thread-safe in-process store (the no-durability default)."""

    def __init__(self):
        self._plans: Dict[Tuple[str, str], object] = {}
        self._artifacts: Dict[Tuple[str, str, str], CompiledBankingPlan] = {}
        self._telemetry: Dict[str, Dict[tuple, object]] = {}
        self._certs: Dict[Tuple[str, str], dict] = {}
        self._joint: Dict[str, object] = {}
        self._lock = threading.Lock()

    def get(self, signature: str, scorer_name: str):
        with self._lock:
            return self._plans.get((signature, scorer_name))

    def put(self, plan) -> None:
        with self._lock:
            self._plans[(plan.signature, plan.scorer_name)] = plan

    def get_artifact(self, signature: str, scorer_name: str,
                     backend: str) -> Optional[CompiledBankingPlan]:
        with self._lock:
            return self._artifacts.get((signature, scorer_name, backend))

    def put_artifact(self, artifact: CompiledBankingPlan) -> None:
        with self._lock:
            self._artifacts[(artifact.signature, artifact.scorer_name,
                             artifact.backend)] = artifact

    def plans(self) -> Iterable:
        with self._lock:
            return list(self._plans.values())

    def artifacts(self) -> Iterable[CompiledBankingPlan]:
        with self._lock:
            return list(self._artifacts.values())

    def get_telemetry(self, signature: str) -> list:
        with self._lock:
            table = self._telemetry.get(signature, {})
            return [rec.copy() for rec in table.values()]

    def merge_telemetry(self, signature: str, records) -> None:
        with self._lock:
            table = self._telemetry.setdefault(signature, {})
            for rec in records:
                mine = table.get(rec.key)
                if mine is None:
                    table[rec.key] = rec.copy()
                else:
                    mine.merge(rec)

    def get_certificate(self, signature: str, scorer_name: str):
        with self._lock:
            return self._certs.get((signature, scorer_name))

    def put_certificate(self, signature: str, scorer_name: str,
                        cert: dict) -> None:
        with self._lock:
            self._certs[(signature, scorer_name)] = cert

    def get_joint(self, signature: str):
        with self._lock:
            return self._joint.get(signature)

    def put_joint(self, plan) -> None:
        with self._lock:
            self._joint[plan.signature] = plan

    def delete(self, signature: str, scorer_name: str) -> None:
        with self._lock:
            self._plans.pop((signature, scorer_name), None)
            self._certs.pop((signature, scorer_name), None)
            for key in [k for k in self._artifacts
                        if k[0] == signature and k[1] == scorer_name]:
                self._artifacts.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()
            self._artifacts.clear()
            self._telemetry.clear()
            self._certs.clear()
            self._joint.clear()


# ---------------------------------------------------------------------------
# Cross-process store: a directory of JSON plans behind a lock file
# ---------------------------------------------------------------------------


class FileLock:
    """Advisory lock file via O_CREAT|O_EXCL -- atomic on any POSIX fs.

    Writers take it so two processes never interleave a read-modify-write
    on the same key; readers don't (they rely on tmp+rename atomicity and
    treat torn JSON as a miss).  A lock older than ``stale_seconds`` is
    broken: the holder crashed, and plans are re-derivable, so liveness
    beats strict exclusion here.
    """

    def __init__(self, path: Union[str, Path], *, timeout: float = 10.0,
                 stale_seconds: float = 30.0, poll: float = 0.005):
        self.path = Path(path)
        self.timeout = timeout
        self.stale_seconds = stale_seconds
        self.poll = poll

    def acquire(self) -> None:
        deadline = time.monotonic() + self.timeout
        while True:
            try:
                fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                self._break_if_stale()
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"could not acquire {self.path} within "
                        f"{self.timeout}s")
                time.sleep(self.poll)
            else:
                os.write(fd, str(os.getpid()).encode())
                os.close(fd)
                return

    def _break_if_stale(self) -> None:
        try:
            age = time.time() - self.path.stat().st_mtime
        except OSError:
            return  # already released
        if age > self.stale_seconds:
            try:
                self.path.unlink()
            except OSError:
                pass  # someone else broke it first

    def release(self) -> None:
        try:
            self.path.unlink()
        except OSError:
            pass

    def __enter__(self) -> "FileLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class DirectoryStore(PlanStore):
    """Plans shared across processes through a directory of JSON files.

    File layout is byte-compatible with the planner's legacy ``cache_dir``:
    ``<signature>.<scorer>.json`` for plans,
    ``<signature>.<scorer>.<backend>.compiled.json`` for artifacts -- a
    directory written by either API serves the other.  All writes are
    lock-file-guarded tmp+rename; reads are lock-free and treat unreadable
    or torn files as misses.

    ``max_bytes`` caps the store: after every write, least-recently-used
    entries (by mtime -- reads touch their file, so a hot entry stays
    young) are evicted until the plan/artifact files fit the cap.
    ``sweep()`` garbage-collects entries written under a stale
    ``SIGNATURE_VERSION`` -- their signatures can never be probed again,
    so they are dead weight after a version bump.

    Conflict certificates live in a ``certs/`` sidecar (same layout as
    ``telemetry/``, outside the LRU cap).  With ``verify_hydrated=True``
    -- what a ``PlanService`` armed with ``verify=`` sets -- every plan
    hydrated from disk must come with a certificate that re-checks and
    matches the plan's scheme; anything else reads as a miss and
    re-solves, so a poisoned or pre-verification entry can never serve.
    """

    LOCK_NAME = ".store.lock"

    def __init__(self, path: Union[str, Path], *, lock_timeout: float = 10.0,
                 lock_stale_seconds: float = 30.0,
                 max_bytes: Optional[int] = None,
                 verify_hydrated: bool = False):
        self.verify_hydrated = verify_hydrated
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self._lock_timeout = lock_timeout
        self._lock_stale = lock_stale_seconds
        self.max_bytes = max_bytes
        # family -> (created_at, signature, scorer_name), rebuilt only
        # when the directory mtime moves (see find_family)
        self._family_index: Dict[str, Tuple[float, str, str]] = {}
        self._family_mtime = -1
        self._index_lock = threading.Lock()

    def _lock(self) -> FileLock:
        return FileLock(self.path / self.LOCK_NAME,
                        timeout=self._lock_timeout,
                        stale_seconds=self._lock_stale)

    # -- paths (legacy planner cache_dir layout) -------------------------------
    def plan_path(self, signature: str, scorer_name: str) -> Path:
        return self.path / f"{signature}.{_safe(scorer_name)}.json"

    def artifact_path(self, signature: str, scorer_name: str,
                      backend: str) -> Path:
        return self.path / (f"{signature}.{_safe(scorer_name)}."
                            f"{backend}.compiled.json")

    # -- plans ---------------------------------------------------------------
    def get(self, signature: str, scorer_name: str):
        from .planner import BankingPlan

        p = self.plan_path(signature, scorer_name)
        try:
            plan = BankingPlan.from_json(json.loads(p.read_text()))
        except _MISS_ERRORS:
            return None  # absent, torn, or foreign file: a miss
        if self.verify_hydrated and not self._hydrate_verified(plan):
            return None  # unverifiable entry: treat as a miss, re-solve
        self._touch(p)
        return plan

    def _hydrate_verified(self, plan) -> bool:
        """Re-verify a hydrated plan against its persisted certificate."""
        if plan.best is None:
            return True  # failed solves carry no scheme to refute
        cert = self.get_certificate(plan.signature, plan.scorer_name)
        if cert is None:
            return False
        from ..analysis.certify import (certificate_matches_plan,
                                        check_certificate)
        ok, _reason = check_certificate(cert)
        return ok and certificate_matches_plan(cert, plan)

    def put(self, plan) -> None:
        path = self.plan_path(plan.signature, plan.scorer_name)
        self._write_locked(path, plan.to_json())

    # -- artifacts -------------------------------------------------------------
    def get_artifact(self, signature: str, scorer_name: str,
                     backend: str) -> Optional[CompiledBankingPlan]:
        p = self.artifact_path(signature, scorer_name, backend)
        try:
            art = CompiledBankingPlan.from_json(json.loads(p.read_text()))
        except _MISS_ERRORS:
            return None
        self._touch(p)
        return art

    def put_artifact(self, artifact: CompiledBankingPlan) -> None:
        path = self.artifact_path(artifact.signature, artifact.scorer_name,
                                  artifact.backend)
        self._write_locked(path, artifact.to_json())

    # -- telemetry sidecar ------------------------------------------------------
    def telemetry_path(self, signature: str) -> Path:
        return self.path / "telemetry" / f"{signature}.json"

    def get_telemetry(self, signature: str) -> list:
        """Lock-free read of one signature's telemetry sidecar -- same
        torn-JSON-is-a-miss discipline as plan reads."""
        from .telemetry import TELEMETRY_FORMAT, MeasuredCost

        p = self.telemetry_path(signature)
        try:
            d = json.loads(p.read_text())
            if d.get("format") != TELEMETRY_FORMAT:
                return []
            return [MeasuredCost.from_json(r) for r in d["records"]]
        except _MISS_ERRORS:
            return []

    def merge_telemetry(self, signature: str, records) -> None:
        """Read-merge-write of the sidecar under the store lock, so two
        processes flushing observations concurrently lose nothing.  A
        torn sidecar is abandoned (observations are cheap to re-earn);
        the merged write heals it."""
        from .telemetry import TELEMETRY_FORMAT, MeasuredCost

        records = list(records)
        if not records:
            return
        path = self.telemetry_path(signature)
        try:
            with self._lock():
                table: Dict[tuple, object] = {}
                try:
                    d = json.loads(path.read_text())
                    if d.get("format") == TELEMETRY_FORMAT:
                        for r in d["records"]:
                            rec = MeasuredCost.from_json(r)
                            table[rec.key] = rec
                except _MISS_ERRORS:
                    table = {}  # absent or torn: start fresh
                for rec in records:
                    mine = table.get(rec.key)
                    if mine is None:
                        table[rec.key] = rec.copy()
                    else:
                        mine.merge(rec)
                payload = {"format": TELEMETRY_FORMAT,
                           "records": [r.to_json() for r in table.values()]}
                path.parent.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(path.suffix + f".tmp{os.getpid()}")
                tmp.write_text(json.dumps(payload))
                tmp.replace(path)
        except (TimeoutError, OSError):
            pass  # best-effort, like every other durable write here

    # -- certificate sidecar ----------------------------------------------------
    def certificate_path(self, signature: str, scorer_name: str) -> Path:
        return (self.path / "certs"
                / f"{signature}.{_safe(scorer_name)}.json")

    def get_certificate(self, signature: str, scorer_name: str):
        """Lock-free read of one plan's certificate sidecar -- torn or
        foreign JSON reads as None, same discipline as plan reads."""
        p = self.certificate_path(signature, scorer_name)
        try:
            return json.loads(p.read_text())
        except _MISS_ERRORS:
            return None

    def put_certificate(self, signature: str, scorer_name: str,
                        cert: dict) -> None:
        """Atomic tmp+rename write under the store lock, mirroring the
        telemetry sidecar (certs/ sits outside the LRU byte cap)."""
        path = self.certificate_path(signature, scorer_name)
        try:
            with self._lock():
                path.parent.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(path.suffix + f".tmp{os.getpid()}")
                tmp.write_text(json.dumps(cert, indent=1, sort_keys=True))
                tmp.replace(path)
        except (TimeoutError, OSError):
            pass  # best-effort, like every other durable write here

    # -- joint-plan sidecar ------------------------------------------------------
    def joint_path(self, signature: str) -> Path:
        return self.path / "joint" / f"{signature}.json"

    def get_joint(self, signature: str):
        """Lock-free read of one joint plan -- torn or foreign JSON
        reads as None, same discipline as plan reads.  ``joint/`` holds
        ``jp1-*`` whole-model selections, outside the plan LRU cap."""
        from .jointplan import JointPlan

        p = self.joint_path(signature)
        try:
            plan = JointPlan.from_json(json.loads(p.read_text()))
        except _MISS_ERRORS:
            return None
        self._touch(p)
        plan.status = "cached-disk"
        return plan

    def put_joint(self, plan) -> None:
        """Atomic tmp+rename write under the store lock, mirroring the
        certificate sidecar."""
        path = self.joint_path(plan.signature)
        try:
            with self._lock():
                path.parent.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(path.suffix + f".tmp{os.getpid()}")
                tmp.write_text(json.dumps(plan.to_json(), indent=1,
                                          sort_keys=True))
                tmp.replace(path)
        except (TimeoutError, OSError):
            pass  # best-effort, like every other durable write here

    # -- demotion ---------------------------------------------------------------
    def delete(self, signature: str, scorer_name: str) -> None:
        """Unlink a plan and its compiled artifacts (demotion eviction).
        The telemetry sidecar survives -- measurements stay evidence;
        the certificate goes with the scheme it certified."""
        try:
            with self._lock():
                try:
                    self.plan_path(signature, scorer_name).unlink()
                except OSError:
                    pass
                try:
                    self.certificate_path(signature, scorer_name).unlink()
                except OSError:
                    pass
                pattern = f"{signature}.{_safe(scorer_name)}.*.compiled.json"
                for f in self.path.glob(pattern):
                    try:
                        f.unlink()
                    except OSError:
                        pass
        except (TimeoutError, OSError):
            pass

    @staticmethod
    def _touch(path: Path) -> None:
        """Freshen mtime on a read hit, so LRU eviction spares hot
        entries.  Best-effort: a read-only store still serves."""
        try:
            os.utime(path)
        except OSError:
            pass

    def _write_locked(self, path: Path, payload: dict) -> None:
        blob = json.dumps(payload, indent=1, sort_keys=True)
        try:
            with self._lock():
                tmp = path.with_suffix(path.suffix + f".tmp{os.getpid()}")
                tmp.write_text(blob)
                tmp.replace(path)
                self._evict_locked()
        except (TimeoutError, OSError):
            pass  # durability is best-effort; in-memory caches still hold

    # -- eviction + versioning ---------------------------------------------------
    def _entries(self):
        """(path, mtime, size) of every plan/artifact file.  Foreign
        files sharing the directory (``ml_scorer.json``, the lock, tmp
        leftovers) are never eviction candidates."""
        out = []
        for f in self.path.glob("bp*.json"):
            try:
                st = f.stat()
            except OSError:
                continue
            out.append((f, st.st_mtime, st.st_size))
        return out

    def _evict_locked(self) -> int:
        """Drop least-recently-used entries until under ``max_bytes``.
        Caller holds the store lock."""
        if self.max_bytes is None:
            return 0
        entries = self._entries()
        total = sum(size for _, _, size in entries)
        removed = 0
        for f, _, size in sorted(entries, key=lambda e: e[1]):
            if total <= self.max_bytes:
                break
            try:
                f.unlink()
            except OSError:
                continue  # another process got there first
            total -= size
            removed += 1
        return removed

    def sweep(self) -> int:
        """Garbage-collect entries whose ``SIGNATURE_VERSION`` is stale.

        Signatures embed the version in their prefix (``bp<V>-``); a
        version bump makes every older entry unreachable -- no probe
        will ever hash to its key again -- so they only waste the size
        budget.  Returns the number of files removed.
        """
        from .planner import SIGNATURE_VERSION

        live = f"bp{SIGNATURE_VERSION}-"
        removed = 0
        try:
            with self._lock():
                for f, _, _ in self._entries():
                    if not f.name.startswith(live):
                        try:
                            f.unlink()
                            removed += 1
                        except OSError:
                            pass
        except (TimeoutError, OSError):
            pass
        return removed

    # -- enumeration -----------------------------------------------------------
    def plans(self) -> Iterable:
        from .planner import BankingPlan

        for f in sorted(self.path.glob("*.json")):
            if f.name.endswith(".compiled.json"):
                continue
            try:
                yield BankingPlan.from_json(json.loads(f.read_text()))
            except _MISS_ERRORS:
                continue

    def artifacts(self) -> Iterable[CompiledBankingPlan]:
        for f in sorted(self.path.glob("*.compiled.json")):
            try:
                yield CompiledBankingPlan.from_json(json.loads(f.read_text()))
            except _MISS_ERRORS:
                continue

    # -- near-match index --------------------------------------------------------
    def find_family(self, family: str, *,
                    exclude_signature: str = ""):
        """Same-family near-match via a directory-mtime-invalidated index.

        The base-class scan would deserialize every plan (rebuilding its
        resolution graphs) on every cold submit; here the raw JSON is
        skimmed once per directory change for (family, created_at,
        signature) and only the chosen plan is actually loaded.
        """
        if not family:
            return None
        self._refresh_family_index()
        with self._index_lock:
            hit = self._family_index.get(family)
        if hit is None:
            return None
        if hit[1] == exclude_signature:
            # the newest family member is the excluded one; fall back to
            # the (rare) full scan for an older sibling
            return super().find_family(family,
                                       exclude_signature=exclude_signature)
        return self.get(hit[1], hit[2])

    def _refresh_family_index(self) -> None:
        try:
            mtime = self.path.stat().st_mtime_ns
        except OSError:
            return
        with self._index_lock:
            if mtime == self._family_mtime:
                return
        index: Dict[str, Tuple[float, str, str]] = {}
        for f in self.path.glob("*.json"):
            if f.name.endswith(".compiled.json"):
                continue
            try:
                d = json.loads(f.read_text())
                fam = d.get("family", "")
                if not fam or d.get("best") is None:
                    continue
                entry = (float(d.get("created_at", 0.0)),
                         d["signature"], d.get("scorer_name", "proxy"))
            except _MISS_ERRORS:
                continue
            if fam not in index or entry > index[fam]:
                index[fam] = entry
        with self._index_lock:
            self._family_mtime = mtime
            self._family_index = index


def as_store(store_or_path) -> Optional[PlanStore]:
    """Coerce ``None`` / a PlanStore / a directory path to a PlanStore."""
    if store_or_path is None or isinstance(store_or_path, PlanStore):
        return store_or_path
    return DirectoryStore(store_or_path)


__all__ = [
    "DirectoryStore",
    "FileLock",
    "MemoryStore",
    "PlanStore",
    "as_store",
]
