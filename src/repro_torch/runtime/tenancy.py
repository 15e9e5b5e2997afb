"""Multi-tenant planning plane: QoS classes, admission control, fair share.

One :class:`~repro_torch.core.service.PlanService` (and one plan store, and one
solve fabric) is meant to serve MANY consumers -- every ``Server`` in a
fleet, every sharding bridge, every batch re-plan job.  The moment those
consumers share a solver, a noisy one can starve the rest: a batch tenant
flooding cold solves pushes an interactive tenant's ticket behind seconds
of queue.  This module gives the service a **tenant dimension**:

* :class:`QoSClass` -- a named service level.  ``priority`` is the ticket
  priority *band* the tenant's submits land in (lower bands drain first,
  strictly), ``weight`` is its fair-share weight *within* a band, and the
  quota knobs bound how much of the shared plane one tenant may hold:
  ``max_inflight`` (queued + solving cold solves), ``max_deferred``
  (admission backlog before shedding), ``shard_budget`` (per-solve
  fan-out cap) and ``fabric_lease_cap`` (concurrent remote leases per
  solve, so one tenant's solve can't occupy every worker's lease
  window).
* :class:`TenantRegistry` -- named tenants bound to QoS classes.  The
  ``"default"`` tenant always exists (permissive: no quotas, band 0,
  weight 1), so untagged submits behave exactly as before tenancy.
* :class:`AdmissionController` -- the gate on ``PlanService.submit``.
  An over-quota cold solve is **deferred**, not dropped: the ticket is
  honest about it (``status == "deferred"``, ``ticket.deferred``), its
  fallback artifact still serves immediately, and the solve queues
  automatically when one of the tenant's in-flight solves finishes.
  Past ``max_deferred`` the submit is **shed**: the ticket fails with a
  concrete :class:`AdmissionError` (``result()`` raises; the fallback
  still executes) -- never a silent drop.
* :class:`FairShareQueue` -- a drop-in for the service's
  ``queue.PriorityQueue`` over ``(priority, seq, payload, ticket)``
  items.  Bands are strict (an interactive-band entry always drains
  before a batch-band one); *within* a band, tenants drain by weighted
  stride scheduling (a weight-8 tenant gets ~8x the pops of a weight-1
  tenant under contention); within one tenant's band the order is
  **deterministic FIFO** (the monotone submit sequence number breaks
  every tie -- equal-priority submits solve in submit order).

``PlanService(tenants=TenantRegistry(...))`` wires all of it in;
``submit(..., tenant="name")`` tags a submit;
``service.stats.for_tenant("name")`` is the tenant's exact
:class:`~repro_torch.core.service.ServiceStats` slice (every counter sums
across slices to the global value).  ``launch/serve_fleet.py`` runs the
whole story: three servers with different model configs, one shared
service, a deliberately noisy batch tenant, bounded interactive latency.

This module imports nothing from ``repro_torch.core`` (the service imports
*it*), so it stays cycle-free and importable from worker processes.
"""

from __future__ import annotations

import heapq
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple, Union

DEFAULT_TENANT = "default"

# One pop's stride is _STRIDE / weight: a tenant's accumulated "pass"
# advances slower the heavier its weight, so it wins more pops.
_STRIDE = 1024.0


class AdmissionError(RuntimeError):
    """A submit refused by admission control (tenant over quota with a
    full deferral backlog).  The ticket that carries it still serves its
    fallback artifact -- shedding is honest, never silent."""


@dataclass(frozen=True)
class QoSClass:
    """A named service level (see module docstring for the knobs)."""

    name: str
    priority: int = 0                       # ticket priority band offset
    weight: float = 1.0                     # fair share within the band
    max_inflight: Optional[int] = None      # queued+solving cold solves
    max_deferred: Optional[int] = None      # deferral backlog before shed
    shard_budget: Optional[int] = None      # per-solve fan-out cap
    fabric_lease_cap: Optional[int] = None  # concurrent remote leases


#: The stock classes.  ``interactive`` drains first and fans out freely;
#: ``batch`` sits a band behind with bounded fan-out; ``best_effort``
#: drains last, one shard per solve, two solves in flight.  ``default``
#: is the pre-tenancy behavior: band 0, no quotas.
QOS_CLASSES: Dict[str, QoSClass] = {
    "interactive": QoSClass("interactive", priority=0, weight=8.0),
    "batch": QoSClass("batch", priority=10, weight=2.0, max_inflight=8,
                      shard_budget=2, fabric_lease_cap=4),
    "best_effort": QoSClass("best_effort", priority=20, weight=1.0,
                            max_inflight=2, shard_budget=1,
                            fabric_lease_cap=2),
    DEFAULT_TENANT: QoSClass(DEFAULT_TENANT),
}


def resolve_qos(qos: Union[str, QoSClass]) -> QoSClass:
    if isinstance(qos, QoSClass):
        return qos
    try:
        return QOS_CLASSES[qos]
    except KeyError:
        raise ValueError(f"unknown QoS class {qos!r}; one of "
                         f"{sorted(QOS_CLASSES)} (or pass a QoSClass)")


class Tenant:
    """One registered consumer of the shared planning plane."""

    def __init__(self, name: str, qos: QoSClass):
        self.name = name
        self.qos = qos
        self.registered_at = time.time()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<Tenant {self.name} qos={self.qos.name}>"


class TenantRegistry:
    """Named tenants -> QoS classes.  The ``"default"`` tenant always
    exists; unknown tenant names resolve by auto-registering under
    ``default_qos`` so untagged or ad-hoc submits are never refused --
    they just get the permissive default treatment (and their own stats
    slice)."""

    def __init__(self, default_qos: Union[str, QoSClass] = DEFAULT_TENANT):
        self._lock = threading.Lock()
        self.default_qos = resolve_qos(default_qos)
        self._tenants: Dict[str, Tenant] = {
            DEFAULT_TENANT: Tenant(DEFAULT_TENANT, QOS_CLASSES[DEFAULT_TENANT]),
        }

    def register(self, name: str,
                 qos: Union[str, QoSClass] = "batch") -> Tenant:
        """Register (or re-class) a tenant; idempotent."""
        q = resolve_qos(qos)
        with self._lock:
            tenant = self._tenants.get(name)
            if tenant is None:
                tenant = Tenant(name, q)
                self._tenants[name] = tenant
            else:
                tenant.qos = q
            return tenant

    def get(self, name: str) -> Tenant:
        with self._lock:
            return self._tenants[name]

    def resolve(self, name: Optional[str]) -> Tenant:
        """The tenant for a submit's ``tenant=`` value (None = default,
        unknown names auto-register under ``default_qos``)."""
        if name is None:
            name = DEFAULT_TENANT
        with self._lock:
            tenant = self._tenants.get(name)
            if tenant is None:
                tenant = Tenant(name, self.default_qos)
                self._tenants[name] = tenant
            return tenant

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._tenants


class AdmissionController:
    """Per-tenant in-flight quota with an ordered deferral backlog.

    ``try_acquire`` claims one in-flight slot (False when the tenant is
    at ``max_inflight``); ``defer`` parks the over-quota entry (False
    when the backlog is at ``max_deferred`` -- the caller sheds);
    ``release`` frees a slot and returns the deferred entries that can
    be queued NOW (oldest first, each with a freshly acquired slot).
    """

    def __init__(self, registry: TenantRegistry):
        self.registry = registry
        # a MetricsRegistry (PlanService.enable_tracing assigns it):
        # deferral-backlog depth lands as a gauge on every change
        self.metrics = None
        self._lock = threading.Lock()
        self._inflight: Dict[str, int] = {}
        self._deferred: Dict[str, Deque] = {}

    def _try_acquire_locked(self, name: str) -> bool:
        cap = self.registry.resolve(name).qos.max_inflight
        have = self._inflight.get(name, 0)
        if cap is not None and have >= cap:
            return False
        self._inflight[name] = have + 1
        return True

    def try_acquire(self, name: str) -> bool:
        with self._lock:
            return self._try_acquire_locked(name)

    def defer(self, name: str, entry) -> bool:
        cap = self.registry.resolve(name).qos.max_deferred
        with self._lock:
            backlog = self._deferred.setdefault(name, deque())
            if cap is not None and len(backlog) >= cap:
                return False
            backlog.append(entry)
            depth = len(backlog)
        if self.metrics is not None:
            self.metrics.set_gauge("deferred_backlog", depth, tenant=name)
        return True

    def release(self, name: str) -> List:
        """Free one of ``name``'s in-flight slots; promote as much of
        its deferral backlog as the freed capacity allows."""
        out: List = []
        with self._lock:
            self._inflight[name] = max(0, self._inflight.get(name, 0) - 1)
            backlog = self._deferred.get(name)
            while backlog and self._try_acquire_locked(name):
                out.append(backlog.popleft())
            depth = len(backlog) if backlog else 0
        if self.metrics is not None and out:
            self.metrics.set_gauge("deferred_backlog", depth, tenant=name)
        return out

    def inflight(self, name: str) -> int:
        with self._lock:
            return self._inflight.get(name, 0)

    def pending(self) -> int:
        """Total deferred entries across every tenant."""
        with self._lock:
            return sum(len(d) for d in self._deferred.values())

    def pending_for(self, name: str) -> int:
        with self._lock:
            return len(self._deferred.get(name, ()))


class FairShareQueue:
    """Priority-band + weighted-fair-share queue over the service's
    ``(priority, seq, payload, ticket)`` items (see module docstring).

    Drop-in for the subset of ``queue.PriorityQueue`` the service uses:
    ``put`` / blocking ``get`` / ``task_done`` / ``qsize`` /
    ``unfinished_tasks``.  The tenant of an item is read off its
    ticket's ``tenant`` attribute (items without one -- e.g. the
    shutdown sentinel -- drain under the default tenant).
    """

    def __init__(self, registry: Optional[TenantRegistry] = None):
        self._registry = registry
        # a MetricsRegistry (PlanService.enable_tracing assigns it):
        # queue depth as a gauge, pops as a per-tenant counter
        self.metrics = None
        self._cond = threading.Condition()
        self._heaps: Dict[str, List[Tuple]] = {}
        self._pass: Dict[str, float] = {}
        self._size = 0
        self._unfinished = 0

    @staticmethod
    def _tenant_of(item) -> str:
        ticket = item[3] if len(item) > 3 else None
        return getattr(ticket, "tenant", None) or DEFAULT_TENANT

    def _weight(self, name: str) -> float:
        if self._registry is None:
            return 1.0
        return max(1e-6, float(self._registry.resolve(name).qos.weight))

    def put(self, item) -> None:
        name = self._tenant_of(item)
        with self._cond:
            heap = self._heaps.setdefault(name, [])
            if not heap:
                # (re)activation: start at the active minimum pass so a
                # long-idle tenant can't monopolize the next N pops
                active = [self._pass[t] for t, h in self._heaps.items()
                          if h and t in self._pass]
                floor = min(active) if active else 0.0
                self._pass[name] = max(self._pass.get(name, 0.0), floor)
            heapq.heappush(heap, item)
            self._size += 1
            self._unfinished += 1
            self._cond.notify()
            depth = self._size
        if self.metrics is not None:
            self.metrics.set_gauge("queue_depth", depth)

    def get(self):
        with self._cond:
            while self._size == 0:
                self._cond.wait()
            heads = {t: h[0] for t, h in self._heaps.items() if h}
            band = min(head[0] for head in heads.values())
            contenders = [t for t, head in heads.items() if head[0] == band]
            # weighted stride within the band; pass ties break by the
            # head's submit seq -- fully deterministic drain order
            name = min(contenders,
                       key=lambda t: (self._pass.get(t, 0.0), heads[t][1]))
            item = heapq.heappop(self._heaps[name])
            self._pass[name] = (self._pass.get(name, 0.0)
                                + _STRIDE / self._weight(name))
            self._size -= 1
            depth = self._size
        if self.metrics is not None:
            self.metrics.set_gauge("queue_depth", depth)
            self.metrics.inc("queue_pops", tenant=name)
        return item

    def task_done(self) -> None:
        with self._cond:
            self._unfinished -= 1

    @property
    def unfinished_tasks(self) -> int:
        return self._unfinished

    def qsize(self) -> int:
        with self._cond:
            return self._size


__all__ = [
    "AdmissionController",
    "AdmissionError",
    "DEFAULT_TENANT",
    "FairShareQueue",
    "QOS_CLASSES",
    "QoSClass",
    "Tenant",
    "TenantRegistry",
    "resolve_qos",
]
