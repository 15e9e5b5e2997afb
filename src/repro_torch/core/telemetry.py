"""Measured-cost telemetry: close the cost-model loop on real hardware.

The Sec-3.5 ML cost model ranks partitioning schemes from *static*
features -- it never learns that a scheme the hardware proved slow should
lose its cache slot (ROADMAP open item 3).  This module is the missing
feedback half:

* :class:`MeasuredCost` -- one aggregated observation record, keyed by
  plan signature + **scheme hash** (a content hash of the geometry, so the
  same scheme measured under any plan informs every ranking) + backend +
  op + (T, R) shape bucket, carrying count / mean / bounded samples for
  p50 / p95.
* :class:`TelemetryLog` -- the in-process observation log.  ``observe``
  updates both a cumulative view (what scorers and demotion read) and a
  **pending-delta** view that :meth:`drain` hands to the store layer, so
  repeated cross-process merges never double-count.
* :func:`roofline_prior_seconds` -- an analytic bytes-moved / bandwidth
  prior (constants lifted from ``launch/roofline.py``) with serialization,
  crossbar and resolution-tree overhead terms, so schemes never yet run
  still rank against measured ones in comparable units.
* :class:`MeasuredScorer` -- the ``"measured"`` scorer-registry entry:
  blends observed latency with the calibrated roofline prior
  (``w = n/(n+k)`` confidence weighting); with an empty log it falls back
  to the static GBT model, so it is always a drop-in for ``"ml"``.
* :class:`ServiceTelemetry` -- the hub a :class:`PlanService` enables:
  instruments compiled artifacts with opt-in timing hooks, registers
  served plans, flushes the log through the plan store's ``telemetry/``
  sidecar, periodically refits ``ml_scorer.json`` from accumulated
  (features, measured) pairs, and **demotes** stored plans whose measured
  cost persistently exceeds the best alternative -- evicting the loser
  and resubmitting a speculative re-solve whose replacement ticket the
  serving runtime adopts between decode ticks.
"""

from __future__ import annotations

import hashlib
import json
import math
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from .planner import register_scorer

TELEMETRY_FORMAT = "measured-cost/v1"

# ops that move table data (tick timings ride along but never feed
# scheme-vs-scheme comparisons: a whole tick is not a gather)
DATA_OPS = ("gather", "scatter")

# roofline-prior overhead coefficients: a fan-in-F crossbar port costs
# ~F/2 extra muxing per access, and the BA/BO resolution tree deepens
# with log2(banks).  Chosen so conflict-free schemes stay well under the
# default demotion ratio of their ideal floor.
XBAR_OVERHEAD = 0.5
TREE_OVERHEAD = 0.125

# canonical row count the prior is quoted at -- priors are per-*scheme*
# constants so ratios between schemes are exact, not per-shape estimates
PRIOR_ROWS = 64

_MAX_SAMPLES = 64


def roofline_bandwidth() -> float:
    """HBM bytes/s behind the roofline prior: ``launch/roofline.py``'s
    ``HBM_BW``, the H100's measured copy rate, read once and cached.
    Priors are per-scheme constants over it, so the rankings they give do
    not depend on the figure, only their absolute value does."""
    cached = roofline_bandwidth.__dict__.get("_bw")
    if cached is None:
        from ..launch.roofline import HBM_BW

        cached = float(HBM_BW)
        roofline_bandwidth.__dict__["_bw"] = cached
    return cached


def scheme_hash(obj) -> str:
    """Content hash of a scheme's geometry -- the telemetry key that lets
    a measurement taken on one compiled artifact inform the ranking of
    the structurally identical candidate in any later solve.

    Accepts a ``BankingSolution`` or a ``CompiledBankingPlan`` (both carry
    ``kind`` / ``geometry`` / ``P`` / ``duplicates``); cached on the object.
    """
    cached = getattr(obj, "_scheme_hash", None)
    if cached is not None:
        return cached
    g = obj.geometry
    if obj.kind == "flat":
        geo = ("flat", g.N, g.B, tuple(g.alpha))
    else:
        geo = ("multidim", tuple(g.Ns), tuple(g.Bs), tuple(g.alphas))
    payload = repr((geo, tuple(obj.P), getattr(obj, "duplicates", 1)))
    h = hashlib.sha256(payload.encode()).hexdigest()[:16]
    try:
        obj._scheme_hash = h
    except (AttributeError, TypeError):
        pass  # frozen/slotted objects just re-hash
    return h


def shape_bucket(shape) -> str:
    """Pow2-ceiled bucket label for a gather/scatter index shape, so a
    (3,) and a (4,) call aggregate into one record instead of fragmenting
    the log per request count."""
    try:
        dims = tuple(int(d) for d in shape)
    except TypeError:
        dims = (int(shape),)
    if not dims:
        return "scalar"
    return "x".join(str(1 << max(0, (d - 1).bit_length())) for d in dims)


def roofline_floor_seconds() -> float:
    """The ideal conflict-free latency floor: canonical bytes moved over
    HBM bandwidth, no serialization, no crossbar, no resolution tree."""
    return PRIOR_ROWS * 16 / 8.0 / roofline_bandwidth()


def roofline_prior_seconds(scheme) -> float:
    """Analytic latency prior for one scheme, in seconds.

    bytes-moved / bandwidth (canonical ``PRIOR_ROWS`` accesses), scaled by
    the scheme's serialization factor (max fan-out: conflicting accesses
    replay the port) and by crossbar + resolution-tree overhead -- so
    never-run schemes rank in the same units measurements arrive in.
    """
    mem = getattr(scheme, "memory", None)
    word_bits = getattr(mem, "word_bits", None) or 16
    banks = getattr(scheme, "num_banks", None)
    if banks is None:
        banks = getattr(scheme, "n_banks", 1)
    banks = max(1, int(banks))
    fan_outs = tuple(getattr(scheme, "fan_outs", ()) or ())
    serial = max(fan_outs) if fan_outs else 1
    fan_in = max(1, int(getattr(scheme, "max_fan_in", 1)))
    base = PRIOR_ROWS * word_bits / 8.0 / roofline_bandwidth()
    return base * serial * (1.0 + XBAR_OVERHEAD * (fan_in - 1)
                            + TREE_OVERHEAD * math.log2(banks))


# ---------------------------------------------------------------------------
# Observation records
# ---------------------------------------------------------------------------


@dataclass
class MeasuredCost:
    """Aggregated latency observations for one (signature, scheme,
    backend, op, shape-bucket) cell.

    ``count``/``mean`` are exact over every observation; ``samples`` is a
    bounded sketch (deterministic slot replacement past ``_MAX_SAMPLES``)
    that p50/p95 read.  ``prior`` records the analytic roofline prior of
    the measured scheme, which is what calibrates priors of never-run
    schemes into measured-seconds units.
    """

    signature: str
    scheme: str
    backend: str
    op: str
    bucket: str
    count: int = 0
    mean: float = 0.0
    prior: float = 0.0
    samples: List[float] = field(default_factory=list)

    @property
    def key(self) -> Tuple[str, str, str, str]:
        return (self.scheme, self.backend, self.op, self.bucket)

    def observe(self, seconds: float, prior: float = 0.0) -> None:
        seconds = float(seconds)
        self.count += 1
        self.mean += (seconds - self.mean) / self.count
        if prior > 0.0:
            self.prior = float(prior)
        if len(self.samples) < _MAX_SAMPLES:
            self.samples.append(seconds)
        else:
            self.samples[self.count % _MAX_SAMPLES] = seconds

    def merge(self, other: "MeasuredCost") -> None:
        """Fold another record for the same key in (store-side merge of
        cross-process deltas): counts add, means weight, samples top up."""
        total = self.count + other.count
        if total:
            self.mean = ((self.mean * self.count
                          + other.mean * other.count) / total)
        self.count = total
        for s in other.samples:
            if len(self.samples) >= _MAX_SAMPLES:
                break
            self.samples.append(float(s))
        if other.prior > 0.0:
            self.prior = other.prior

    def p50(self) -> float:
        return float(np.median(self.samples)) if self.samples else self.mean

    def p95(self) -> float:
        if not self.samples:
            return self.mean
        return float(np.percentile(self.samples, 95))

    def copy(self) -> "MeasuredCost":
        return MeasuredCost(signature=self.signature, scheme=self.scheme,
                            backend=self.backend, op=self.op,
                            bucket=self.bucket, count=self.count,
                            mean=self.mean, prior=self.prior,
                            samples=list(self.samples))

    def to_json(self) -> dict:
        return {
            "signature": self.signature,
            "scheme": self.scheme,
            "backend": self.backend,
            "op": self.op,
            "bucket": self.bucket,
            "count": self.count,
            "mean": self.mean,
            "prior": self.prior,
            "samples": list(self.samples),
        }

    @staticmethod
    def from_json(d: dict) -> "MeasuredCost":
        return MeasuredCost(
            signature=d["signature"], scheme=d["scheme"],
            backend=d["backend"], op=d["op"], bucket=d["bucket"],
            count=int(d.get("count", 0)), mean=float(d.get("mean", 0.0)),
            prior=float(d.get("prior", 0.0)),
            samples=[float(s) for s in d.get("samples", ())],
        )


class TelemetryLog:
    """Thread-safe per-process observation log.

    Every ``observe`` lands twice: in the cumulative records (what
    :class:`MeasuredScorer` and demotion read) and in a pending-delta
    table that :meth:`drain` empties for the store layer -- so flushing
    the same log repeatedly merges only *new* observations into the
    shared ``telemetry/`` sidecar, never re-counting old ones.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._records: Dict[Tuple, MeasuredCost] = {}
        self._pending: Dict[Tuple, MeasuredCost] = {}

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def observe(self, signature: str, scheme: str, backend: str, op: str,
                shape, seconds: float, prior: float = 0.0) -> MeasuredCost:
        bucket = shape if isinstance(shape, str) else shape_bucket(shape)
        key = (signature, scheme, backend, op, bucket)
        with self._lock:
            rec = self._records.get(key)
            if rec is None:
                rec = self._records[key] = MeasuredCost(
                    signature=signature, scheme=scheme, backend=backend,
                    op=op, bucket=bucket)
            rec.observe(seconds, prior)
            pend = self._pending.get(key)
            if pend is None:
                pend = self._pending[key] = MeasuredCost(
                    signature=signature, scheme=scheme, backend=backend,
                    op=op, bucket=bucket)
            pend.observe(seconds, prior)
        return rec

    def observe_artifact(self, art, op: str, shape,
                         seconds: float) -> MeasuredCost:
        """Record one timed call on a compiled artifact, tagging the
        record with the artifact's analytic prior (the calibration
        anchor)."""
        return self.observe(art.signature, scheme_hash(art), art.backend,
                            op, shape, seconds,
                            prior=roofline_prior_seconds(art))

    # -- queries -------------------------------------------------------------
    def records(self, *, signature: Optional[str] = None,
                scheme: Optional[str] = None,
                ops: Optional[Tuple[str, ...]] = None) -> List[MeasuredCost]:
        with self._lock:
            recs = list(self._records.values())
        return [r for r in recs
                if (signature is None or r.signature == signature)
                and (scheme is None or r.scheme == scheme)
                and (ops is None or r.op in ops)]

    def scheme_measured(self, scheme: str, *,
                        signature: Optional[str] = None,
                        ops: Tuple[str, ...] = DATA_OPS
                        ) -> Tuple[int, Optional[float]]:
        """(total observations, count-weighted p50) for one scheme."""
        recs = [r for r in self.records(signature=signature, scheme=scheme,
                                        ops=ops) if r.count > 0]
        if not recs:
            return 0, None
        total = sum(r.count for r in recs)
        return total, sum(r.p50() * r.count for r in recs) / total

    def best_rival(self, signature: str, exclude_scheme: str, *,
                   ops: Tuple[str, ...] = DATA_OPS
                   ) -> Optional[Tuple[str, float]]:
        """The fastest *measured* sibling scheme under the same plan
        signature -- demotion's strongest evidence when one exists."""
        schemes = {r.scheme for r in self.records(signature=signature,
                                                  ops=ops)
                   if r.count > 0 and r.scheme != exclude_scheme}
        best: Optional[Tuple[str, float]] = None
        for s in schemes:
            _, p50 = self.scheme_measured(s, signature=signature, ops=ops)
            if p50 is not None and (best is None or p50 < best[1]):
                best = (s, p50)
        return best

    def calibration(self) -> float:
        """Median measured/prior ratio -- the factor that converts
        analytic priors into this host's measured-seconds units.  1.0
        with no evidence."""
        ratios = [r.p50() / r.prior
                  for r in self.records(ops=DATA_OPS)
                  if r.count > 0 and r.prior > 0.0]
        return float(np.median(ratios)) if ratios else 1.0

    def has_measurements(self, ops: Tuple[str, ...] = DATA_OPS) -> bool:
        with self._lock:
            return any(r.count > 0 and r.op in ops
                       for r in self._records.values())

    # -- store exchange --------------------------------------------------------
    def drain(self) -> Dict[str, List[MeasuredCost]]:
        """Take (and clear) the pending deltas, grouped by signature --
        what :meth:`ServiceTelemetry.flush` hands to
        ``store.merge_telemetry``.  Cumulative records are untouched."""
        with self._lock:
            pend, self._pending = self._pending, {}
        out: Dict[str, List[MeasuredCost]] = {}
        for rec in pend.values():
            out.setdefault(rec.signature, []).append(rec)
        return out

    def hydrate(self, records: Iterable[MeasuredCost]) -> int:
        """Merge store-side records (other processes' history) into the
        cumulative view.  Never touches the pending deltas, so hydrated
        history is not re-flushed."""
        n = 0
        with self._lock:
            for rec in records:
                key = (rec.signature, rec.scheme, rec.backend, rec.op,
                       rec.bucket)
                mine = self._records.get(key)
                if mine is None:
                    self._records[key] = rec.copy()
                else:
                    mine.merge(rec)
                n += 1
        return n

    def to_json(self) -> dict:
        with self._lock:
            recs = [r.to_json() for r in self._records.values()]
        return {"format": TELEMETRY_FORMAT, "records": recs}

    @staticmethod
    def from_json(d: dict) -> "TelemetryLog":
        if d.get("format") != TELEMETRY_FORMAT:
            raise ValueError(f"not a telemetry log: {d.get('format')!r}")
        log = TelemetryLog()
        log.hydrate(MeasuredCost.from_json(r) for r in d["records"])
        return log


_DEFAULT_LOG: Optional[TelemetryLog] = None
_DEFAULT_LOG_LOCK = threading.Lock()


def default_telemetry_log() -> TelemetryLog:
    """Process-wide log backing ``scorer="measured"`` outside a service
    (a :class:`ServiceTelemetry` hub rebinds scorers to its own log)."""
    global _DEFAULT_LOG
    with _DEFAULT_LOG_LOCK:
        if _DEFAULT_LOG is None:
            _DEFAULT_LOG = TelemetryLog()
        return _DEFAULT_LOG


# ---------------------------------------------------------------------------
# The "measured" scorer
# ---------------------------------------------------------------------------


class MeasuredScorer:
    """Rank schemes by observed latency, calibrated priors, or the static
    GBT model -- in that order of evidence.

    * a scheme with ``n`` observations scores
      ``w * p50 + (1 - w) * cal * prior`` with ``w = n / (n + k)`` --
      measurement dominates as evidence accumulates;
    * a never-run scheme scores ``cal * prior`` (its analytic roofline
      prior scaled by the log's measured/prior calibration);
    * with an empty log the static scorer ranks (the persisted/trained
      ``"ml"`` pipeline unless one is passed explicitly), so
      ``scorer="measured"`` is safe from the very first cold solve.
    """

    __name__ = "measured"

    def __init__(self, log: Optional[TelemetryLog] = None,
                 static: Optional[Callable] = None, k: float = 4.0):
        self.log = log if log is not None else default_telemetry_log()
        self.static = static
        self.k = float(k)

    def with_log(self, log: TelemetryLog) -> "MeasuredScorer":
        """The same scorer reading a different log (how a service hub
        rebinds registry-resolved scorers to its private log)."""
        return MeasuredScorer(log=log, static=self.static, k=self.k)

    def _static(self) -> Optional[Callable]:
        if self.static is not None:
            return self.static
        try:
            from . import planner as planner_mod

            factory = planner_mod._ml_scorer_factory
            if factory.__dict__.get("_cached") is None:
                path = planner_mod._ML_SCORER_PATH
                if path is None or not path.exists():
                    # no trained model anywhere: the factory would train
                    # the corpus GBT from scratch -- never block a
                    # serving-path solve on that; the resource proxy /
                    # roofline prior rank until refresh() persists one
                    return None
            self.static = factory()
        except Exception:
            return None
        return self.static

    def __call__(self, sol) -> float:
        log = self.log
        sh = scheme_hash(sol)
        count, p50 = log.scheme_measured(sh)
        if count and p50 is not None:
            w = count / (count + self.k)
            return (w * p50
                    + (1.0 - w) * log.calibration()
                    * roofline_prior_seconds(sol))
        if log.has_measurements():
            return log.calibration() * roofline_prior_seconds(sol)
        static = self._static()
        if static is not None:
            return float(static(sol))
        if sol.resources is not None:   # proxy-of-last-resort
            return float(sol.resources.total.weighted())
        return roofline_prior_seconds(sol)


register_scorer("measured", MeasuredScorer)


# ---------------------------------------------------------------------------
# The service hub: instrument -> observe -> flush / refresh / demote
# ---------------------------------------------------------------------------


@dataclass
class TelemetryConfig:
    """Knobs for the feedback loop.

    ``min_observations``: measured evidence required before a plan may be
    demoted.  ``demote_ratio``: the served scheme's measured p50 must
    exceed the best alternative's (measured or calibrated-prior) estimate
    by this factor.  ``flush_every`` / ``refresh_every``: observations
    between store flushes / ``ml_scorer.json`` refits (0 disables the
    periodic refit; :meth:`ServiceTelemetry.refresh` still works on
    demand).
    """

    min_observations: int = 8
    demote_ratio: float = 2.0
    flush_every: int = 32
    refresh_every: int = 0
    sample_limit: int = _MAX_SAMPLES


class ServiceTelemetry:
    """The measured-cost hub one :class:`~repro_torch.core.service.PlanService`
    owns (see :meth:`PlanService.enable_telemetry`).

    Wiring: the planner instruments every artifact it compiles
    (:meth:`instrument` attaches this hub as the artifact's timing sink);
    the service registers every plan it answers (:meth:`register` captures
    the served scheme, its prior, and the ranked runner-up's prior while
    the in-process solutions list is still attached); gather / scatter /
    tick timings arrive through :meth:`observe`, which feeds the log,
    bumps ``ServiceStats.observations``, flushes to the store's
    ``telemetry/`` sidecar every ``flush_every`` observations, and runs
    the demotion check.  Demotion fires **exactly once** per (signature,
    scorer): the stored loser is evicted and its prepared request
    resubmitted at high priority; the serving runtime polls
    :meth:`replacement` between ticks and hot-swaps when the re-solve
    lands.
    """

    def __init__(self, service=None, planner=None,
                 config: Optional[TelemetryConfig] = None,
                 log: Optional[TelemetryLog] = None):
        self.config = config if config is not None else TelemetryConfig()
        self.log = log if log is not None else TelemetryLog()
        self.service = service
        self.planner = (planner if planner is not None
                        else getattr(service, "planner", None))
        self._lock = threading.Lock()
        self._plans: Dict[Tuple[str, str], dict] = {}
        self._features: Dict[str, np.ndarray] = {}
        self._demoted: set = set()
        self._replacements: Dict[Tuple[str, str], object] = {}
        self._hydrated: set = set()
        self._since_flush = 0
        self._since_refresh = 0

    # -- registration ----------------------------------------------------------
    def register(self, prep, plan) -> None:
        """Note a plan the service just answered with: remember the served
        scheme's hash + prior, the ranked runner-up's prior (only fresh
        solves still carry ``solutions``), and static features for the
        refresh path; hydrate any persisted telemetry for the signature."""
        if plan is None or plan.best is None:
            return
        key = (plan.signature, plan.scorer_name)
        entry = {
            "prep": prep,
            "scheme": scheme_hash(plan.best),
            "prior": roofline_prior_seconds(plan.best),
        }
        for sol in plan.solutions[1:]:
            sh = scheme_hash(sol)
            if sh != entry["scheme"]:
                entry["runner_scheme"] = sh
                entry["runner_prior"] = roofline_prior_seconds(sol)
                break
        with self._lock:
            self._plans[key] = entry
        for sol in ([plan.best] + list(plan.solutions))[:16]:
            sh = scheme_hash(sol)
            with self._lock:
                if sh in self._features:
                    continue
            try:
                from .features import extract_features
                x = extract_features(sol)
            except Exception:
                continue
            with self._lock:
                self._features.setdefault(sh, x)
        self._hydrate(plan.signature)

    def _hydrate(self, signature: str) -> None:
        store = getattr(self.planner, "store", None)
        if store is None:
            return
        with self._lock:
            if signature in self._hydrated:
                return
            self._hydrated.add(signature)
        recs = store.get_telemetry(signature)
        if recs:
            self.log.hydrate(recs)

    def instrument(self, art) -> None:
        """Attach this hub as ``art``'s timing sink (opt-in hooks on
        gather/scatter).  The trivial fallback has no signature to key
        observations under, so it stays unhooked."""
        if art is not None and art.signature:
            art.enable_telemetry(self)

    def adapt_scorer(self, name: str, fn):
        """Rebind a registry-resolved :class:`MeasuredScorer` to this
        hub's log, so a service's solves rank on the service's own
        measurements rather than the process-default log."""
        if isinstance(fn, MeasuredScorer) and fn.log is not self.log:
            return fn.with_log(self.log)
        return fn

    # -- observation -----------------------------------------------------------
    def observe(self, art, op: str, shape, seconds: float) -> None:
        """One timed call (the artifact hooks and ``Server.tick`` both
        land here).  Log it, then run the flush / refresh / demote checks
        outside the log lock."""
        self.log.observe_artifact(art, op, shape, seconds)
        with self._lock:
            self._since_flush += 1
            self._since_refresh += 1
            do_flush = (self.config.flush_every > 0
                        and self._since_flush >= self.config.flush_every)
            if do_flush:
                self._since_flush = 0
            do_refresh = (self.config.refresh_every > 0
                          and self._since_refresh
                          >= self.config.refresh_every)
            if do_refresh:
                self._since_refresh = 0
        svc = self.service
        if svc is not None:
            with svc._lock:
                svc.stats.bump("observations")
            metrics = svc.metrics
            if metrics is not None:
                metrics.observe(f"observed_{op}_us", seconds * 1e6)
        if do_flush:
            self.flush()
        if do_refresh:
            self.refresh()
        if op in DATA_OPS:
            self._maybe_demote(art)

    # -- persistence -----------------------------------------------------------
    def flush(self) -> int:
        """Drain pending deltas into the store's telemetry sidecar.
        Returns the number of records merged (0 without a store: deltas
        keep accumulating for a later flush)."""
        store = getattr(self.planner, "store", None)
        if store is None:
            return 0
        drained = self.log.drain()
        n = 0
        for sig, recs in drained.items():
            store.merge_telemetry(sig, recs)
            n += len(recs)
        return n

    # -- online refresh --------------------------------------------------------
    def refresh(self) -> bool:
        """Refit the persisted ML scorer from accumulated (features,
        measured-microseconds) pairs.

        Fits a :class:`~repro_torch.core.cost_model.ResourcePipeline` on every
        scheme with both static features (captured at register time) and
        measurements, grafts it onto the current ``"ml"`` scorer as a
        ``measured_us`` resource, and persists the result to the
        ``ml_scorer.json`` path -- the mtime advance makes every later
        ``"ml"`` resolution (mtime reload) pick it up.
        Returns False when fewer than two schemes are measured.
        """
        with self._lock:
            feats = dict(self._features)
        pairs = []
        for sh, x in feats.items():
            count, p50 = self.log.scheme_measured(sh)
            if count and p50 is not None:
                pairs.append((x, p50 * 1e6))
        if len(pairs) < 2:
            return False
        from . import planner as planner_mod
        from .cost_model import MLScorer, ResourcePipeline

        X = np.asarray([p[0] for p in pairs], dtype=float)
        y = np.asarray([p[1] for p in pairs], dtype=float)
        pipe = ResourcePipeline(
            gbt_params=dict(n_estimators=8, min_leaf=1)).fit(X, y)
        with planner_mod._ML_TRAIN_LOCK:
            base = planner_mod._ml_scorer_factory.__dict__.get("_cached")
            if isinstance(base, MLScorer):
                scorer = base.with_pipeline("measured_us", pipe, weight=1.0)
            else:
                scorer = MLScorer({"measured_us": pipe},
                                  weights={"measured_us": 1.0})
            planner_mod._ml_scorer_factory.__dict__["_cached"] = scorer
            path = planner_mod._ML_SCORER_PATH
            if path is not None:
                try:
                    path.parent.mkdir(parents=True, exist_ok=True)
                    tmp = path.with_suffix(".json.tmp")
                    tmp.write_text(json.dumps(scorer.to_json()))
                    tmp.replace(path)
                    planner_mod._ml_scorer_factory.__dict__[
                        "_cached_mtime"] = path.stat().st_mtime_ns
                except OSError:
                    pass  # persistence best-effort, like training's
        svc = self.service
        if svc is not None:
            with svc._lock:
                svc.stats.bump("refreshes")
        return True

    # -- demotion --------------------------------------------------------------
    def _demotion_threshold(self, key: Tuple[str, str],
                            entry: dict) -> Optional[float]:
        """Best alternative estimate, strongest evidence first: a measured
        sibling's p50; else the registered runner-up's calibrated prior;
        else the calibrated conflict-free floor."""
        signature = key[0]
        rival = self.log.best_rival(signature,
                                    exclude_scheme=entry["scheme"])
        if rival is not None:
            return rival[1]
        cal = self.log.calibration()
        runner = entry.get("runner_prior")
        if runner:
            return cal * runner
        return cal * roofline_floor_seconds()

    def _maybe_demote(self, art) -> None:
        key = (art.signature, art.scorer_name)
        with self._lock:
            entry = self._plans.get(key)
            if entry is None or key in self._demoted:
                return
        if scheme_hash(art) != entry["scheme"]:
            return   # not the stored best (already swapped / promoted)
        count, p50 = self.log.scheme_measured(entry["scheme"],
                                              signature=art.signature)
        if count < self.config.min_observations or p50 is None:
            return
        threshold = self._demotion_threshold(key, entry)
        if threshold is None or threshold <= 0.0:
            return
        if p50 <= self.config.demote_ratio * threshold:
            return
        with self._lock:
            if key in self._demoted:     # exactly-once under racing ticks
                return
            self._demoted.add(key)
        svc = self.service
        planner = self.planner
        if planner is not None:
            planner.evict(*key)
        if svc is not None:
            with svc._lock:
                svc.stats.bump("demotions")
            tr = svc.tracer
            if tr is not None:
                # a demotion is an anomaly the flight recorder should
                # dump: a stored plan measured slower than its rival
                tr.note_anomaly("demotion", detail=art.signature[:16])
            # speculative re-solve through the normal revalidation path:
            # the eviction above turned this into a cold submit, and the
            # scorer (rebound to this hub's log) now knows the loser lost
            ticket = svc.submit_prepared(entry["prep"], priority=-1)
            with self._lock:
                self._replacements[key] = ticket

    def replacement(self, key: Tuple[str, str]):
        """Pop the demotion re-solve ticket for ``key``, if one is
        waiting -- the serving runtime polls this between decode ticks
        and adopts the ticket like its original one."""
        with self._lock:
            return self._replacements.pop(key, None)


__all__ = [
    "DATA_OPS",
    "MeasuredCost",
    "MeasuredScorer",
    "ServiceTelemetry",
    "TELEMETRY_FORMAT",
    "TelemetryConfig",
    "TelemetryLog",
    "default_telemetry_log",
    "roofline_prior_seconds",
    "scheme_hash",
    "shape_bucket",
]
