"""SolveFabric: remote shard workers with live cut broadcast.

The cold solve is a shardable pipeline -- ``CandidateSpace`` enumerates,
``SolveShard``s evaluate anywhere, one ``SolutionReducer`` merges -- and
``evaluate_parallel`` runs the work-unit/cut protocol over a local process
pool.  This module lifts the same protocol onto **remote worker
processes** (one reducer, many hosts) so huge multi-memory programs solve
at wire speed:

* The fabric listens on a socket; ``python -m
  repro_torch.launch.solve_worker <host:port>`` attaches any number of
  worker processes (run it on N hosts to attach N hosts to one service).
  A worker evaluates with numpy on the host and never touches the card.
* Each solve ships its :class:`~repro_torch.core.candidates.CandidateSpace`
  **once** per worker (``space_to_wire``), then **leases** small work
  units -- candidate index lists -- against it.  A worker keeps the
  rebuilt space (and its conflict cache) for the solve's lifetime, so
  memoized residue analyses span all of that worker's leases.
* Scored :class:`~repro_torch.core.solver.BankingSolution` streams flow
  back incrementally (``events_to_wire`` batches) into the single
  :class:`~repro_torch.core.candidates.SolutionReducer`, so
  ``ticket.best_so_far()`` and server promotions work identically
  whether shards ran in-process or on three other machines.
* **Cut broadcast**: whenever the reducer publishes a new section cut,
  the fabric pushes the snapshot to every worker with an in-flight
  lease of that solve (and stamps it on every future lease), so remote
  shards prune beyond-cut candidates as aggressively as the monolithic
  search.  Dispatch itself is cut-filtered too: once a cap is provably
  reached, none of that section's remaining candidates are ever leased.
* **Fault tolerance**: a worker that dies (EOF) or times out has its
  leases requeued with that worker *excluded*; a unit no live worker
  may take is evaluated locally by the driving thread, so the solve
  always converges to the exact monolithic answer.
* **Backpressure**: each worker holds at most ``lease_window``
  outstanding leases; further units queue at the fabric until a lease
  drains.

Wire format: 4-byte big-endian length + pickled dict frames, the same
framing, frame kinds and keys as the JAX package's fabric.  The payloads
are pickled objects of *this* package (a space or a solution names its
module), so a fabric and its workers come from one package: a worker of
the JAX package does not serve a driver of this one, nor the other way
round.  Workers are trusted peers of the service (pickle!) -- bind the
fabric to a private interface.
"""

from __future__ import annotations

import os
import pickle
import queue
import socket
import struct
import subprocess
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .candidates import (
    CandidateSpace,
    SolutionReducer,
    evaluate,
    events_from_wire,
    shard_from_indices,
    space_to_wire,
)

_LEN = struct.Struct("!I")
# Hard ceiling audited BEFORE any allocation or unpickle: a corrupt or
# hostile peer announcing a huge length prefix must not make the reader
# allocate it.  64 MiB clears the biggest wired candidate space by two
# orders of magnitude; raise via max_frame= on read_frame if a future
# payload legitimately outgrows it.
_MAX_FRAME = 64 << 20
_WIRE_PROTO = pickle.HIGHEST_PROTOCOL


# ---------------------------------------------------------------------------
# Framing (shared with launch/solve_worker.py)
# ---------------------------------------------------------------------------


def write_frame(sock: socket.socket, msg: dict,
                lock: Optional[threading.Lock] = None) -> None:
    blob = pickle.dumps(msg, protocol=_WIRE_PROTO)
    data = _LEN.pack(len(blob)) + blob
    if lock is not None:
        with lock:
            sock.sendall(data)
    else:
        sock.sendall(data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise EOFError("peer closed the connection")
        buf += chunk
    return buf


def read_frame(sock: socket.socket,
               max_frame: int = _MAX_FRAME) -> dict:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if n > max_frame:
        # audit the length prefix before allocating anything for it
        raise ValueError(f"frame of {n} bytes exceeds the "
                         f"{max_frame}-byte wire bound")
    return pickle.loads(_recv_exact(sock, n))


# ---------------------------------------------------------------------------
# Book-keeping
# ---------------------------------------------------------------------------


@dataclass
class FabricStats:
    """Cumulative counters across every solve this fabric ran."""

    solves: int = 0
    leases: int = 0
    requeues: int = 0         # leases re-issued after worker death/timeout
    cut_broadcasts: int = 0   # cut snapshots pushed to in-flight workers
    results_frames: int = 0   # result batches received off the wire
    evaluated: int = 0        # candidate evaluations reported by workers
    local_evaluated: int = 0  # orphan units evaluated by the driving thread
    workers_joined: int = 0
    workers_lost: int = 0
    cert_rejected: int = 0    # result batches refused by a solve's verifier
    heartbeats: int = 0       # liveness frames received from workers


@dataclass
class FabricReport:
    """Per-solve accounting, returned by :meth:`SolveFabric.solve`."""

    leases: int = 0
    requeues: int = 0
    cut_broadcasts: int = 0
    evaluated: int = 0
    local_evaluated: int = 0
    workers_used: int = 0
    workers_lost: int = 0    # deaths of workers holding this solve's leases
    cert_rejected: int = 0   # result batches refused by the verifier
    heartbeats: int = 0      # hb frames from workers holding our leases
    peak_leases: int = 0     # max concurrently outstanding leases


@dataclass
class _Unit:
    """One leasable work unit: a contiguous candidate index run, plus
    the workers excluded from taking it (they died or timed out holding
    its lease)."""

    indices: Tuple[int, ...]
    excluded: frozenset = frozenset()


@dataclass
class _Lease:
    lease_id: int
    unit: _Unit
    solve: "_FabricSolve"
    worker_id: int
    issued_at: float
    # perf_counter twin of issued_at: trace spans live on the
    # perf_counter clock, and worker-side spans rebase onto this
    issued_pc: float = 0.0


class _Worker:
    def __init__(self, wid: int, sock: socket.socket, addr):
        self.wid = wid
        self.sock = sock
        self.addr = addr
        self.send_lock = threading.Lock()
        # all scheduler traffic goes through one ordered queue drained
        # by a dedicated sender thread, so a worker can never see a
        # lease before the space frame it depends on
        self.sendq: "queue.Queue" = queue.Queue()
        self.outstanding: Dict[int, _Lease] = {}
        self.spaces: set = set()      # solve_ids whose space was shipped
        self.alive = True
        self.last_seen = time.monotonic()  # any frame refreshes this
        self.hb_seen = False          # worker speaks the heartbeat frame


class _FabricSolve:
    def __init__(self, solve_id: int, space: CandidateSpace,
                 reducer: SolutionReducer, verifier=None,
                 lease_cap: Optional[int] = None, trace=None):
        self.solve_id = solve_id
        self.space = space
        self.reducer = reducer
        self.verifier = verifier          # untrusted-result gate (or None)
        self.lease_cap = lease_cap        # max concurrent leases (QoS)
        self.trace = trace                # (Tracer, trace_id) or None
        self.payload = space_to_wire(space)
        self.pending: deque = deque()
        self.outstanding: Dict[int, _Lease] = {}
        self.cuts_sent: Dict[int, int] = {}
        self.report = FabricReport()
        self.workers_used: set = set()
        self.finished = False


# ---------------------------------------------------------------------------
# The fabric
# ---------------------------------------------------------------------------


class SolveFabric:
    """Coordinator for remote shard workers (see module docstring).

    Parameters
    ----------
    listen : ``(host, port)`` to accept workers on (port 0 = ephemeral)
    chunk : default candidates per lease (per-solve override via
        ``solve(chunk=...)``)
    lease_window : max outstanding leases per worker (backpressure)
    lease_timeout : seconds before an unanswered lease is requeued with
        the slow worker excluded
    hb_timeout : seconds of total silence (no frame of any kind) after
        which a worker that HAS sent heartbeat frames is declared dead
        and dropped -- far cheaper than waiting out ``lease_timeout``,
        since workers heartbeat every couple of seconds
        (``solve_worker.py --hb-interval``).  Workers that never sent a
        heartbeat (older clients) are exempt and only age out via the
        lease timeout.
    broadcast_cuts : distribute reducer cuts (lease stamping, mid-flight
        broadcast, and dispatch-time filtering); disable only to measure
        what the cut protocol saves
    """

    def __init__(self, listen: Tuple[str, int] = ("127.0.0.1", 0), *,
                 chunk: int = 32, lease_window: int = 2,
                 lease_timeout: float = 60.0,
                 hb_timeout: float = 10.0,
                 broadcast_cuts: bool = True):
        self.chunk = max(1, int(chunk))
        self.lease_window = max(1, int(lease_window))
        self.lease_timeout = float(lease_timeout)
        self.hb_timeout = float(hb_timeout)
        self.broadcast_cuts = broadcast_cuts
        self.stats = FabricStats()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._workers: Dict[int, _Worker] = {}
        self._leases: Dict[int, _Lease] = {}
        self._solves: Dict[int, _FabricSolve] = {}
        self._next_worker = iter(range(1 << 62)).__next__
        self._next_lease = iter(range(1 << 62)).__next__
        self._next_solve = iter(range(1 << 62)).__next__
        self._shutdown = False
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(listen)
        self._listener.listen(64)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="fabric-accept")
        self._accept_thread.start()

    # -- addressing / membership ---------------------------------------------
    @property
    def address(self) -> str:
        """``host:port`` workers attach to (``solve_worker.py`` argv)."""
        host, port = self._listener.getsockname()[:2]
        return f"{host}:{port}"

    @property
    def workers_alive(self) -> int:
        with self._lock:
            return sum(1 for w in self._workers.values() if w.alive)

    def wait_for_workers(self, n: int, timeout: float = 30.0) -> bool:
        """Block until ``n`` workers are attached (True) or time out."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while sum(1 for w in self._workers.values() if w.alive) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(left)
        return True

    # -- accept / read loops --------------------------------------------------
    def _accept_loop(self) -> None:
        while True:
            try:
                sock, addr = self._listener.accept()
            except OSError:
                return                    # listener closed: shutting down
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._cond:
                if self._shutdown:
                    sock.close()
                    return
                worker = _Worker(self._next_worker(), sock, addr)
                self._workers[worker.wid] = worker
                self.stats.workers_joined += 1
                self._cond.notify_all()
            threading.Thread(target=self._read_loop, args=(worker,),
                             daemon=True,
                             name=f"fabric-read-{worker.wid}").start()
            threading.Thread(target=self._send_loop, args=(worker,),
                             daemon=True,
                             name=f"fabric-send-{worker.wid}").start()
            with self._cond:
                self._pump()

    def _send_loop(self, worker: _Worker) -> None:
        """Drain the worker's ordered send queue (None = stop)."""
        while True:
            msg = worker.sendq.get()
            if msg is None:
                return
            try:
                write_frame(worker.sock, msg, worker.send_lock)
            except OSError:
                self._drop_worker(worker)
                return

    def _read_loop(self, worker: _Worker) -> None:
        try:
            while True:
                msg = read_frame(worker.sock)
                t = msg.get("t")
                if t == "results":
                    self._on_results(worker, msg)
                elif t == "done":
                    self._on_done(worker, msg)
                elif t == "error":
                    self._on_error(worker, msg)
                elif t == "hb":
                    self._on_hb(worker)
                # "join" is informational (pid/host for debugging)
        except Exception:
            # dead socket, poisoned frame, or a handler error (e.g. a
            # custom scorer raising inside reducer.add): in every case
            # the worker must be dropped so its leases requeue instead
            # of burning the full lease timeout on a deaf connection
            pass
        self._drop_worker(worker)

    # -- message handling -----------------------------------------------------
    def _touch_worker(self, worker: _Worker) -> None:
        """Any frame proves the worker alive: refresh EVERY lease it
        holds (a queued second lease must not time out while the worker
        is legitimately busy on its first).  Caller holds the lock."""
        now = time.monotonic()
        worker.last_seen = now
        for lease in worker.outstanding.values():
            lease.issued_at = now

    def _on_hb(self, worker: _Worker) -> None:
        """A heartbeat proves the PROCESS alive -- it refreshes worker
        liveness but deliberately NOT lease ``issued_at``: a worker that
        heartbeats while hung on a lease must still lose that lease to
        the lease timeout.  The frames are counted per solve the worker
        holds leases for, so ``ServiceStats.fabric_heartbeats`` can
        attribute them to tenants."""
        with self._lock:
            worker.last_seen = time.monotonic()
            worker.hb_seen = True
            self.stats.heartbeats += 1
            for solve in {lease.solve for lease in
                          worker.outstanding.values()}:
                solve.report.heartbeats += 1

    def _on_results(self, worker: _Worker, msg: dict) -> None:
        with self._lock:
            lease = self._leases.get(msg["lease_id"])
            self.stats.results_frames += 1
            self._touch_worker(worker)
        if lease is None:
            return                        # late frame of a requeued lease
        solve = lease.solve
        # decode + verify + reduce outside the fabric lock: certifying
        # and scoring can be heavy
        events = list(events_from_wire(msg["payload"]))
        if solve.verifier is not None:
            rejection = solve.verifier(events)
            if rejection is not None:
                # untrusted result failed certification: drop the whole
                # batch, take the lease away, and requeue its unit with
                # this worker excluded -- the unit re-runs elsewhere (or
                # locally on the driving thread), so the solve still
                # converges to the exact monolithic answer
                with self._cond:
                    solve.report.cert_rejected += 1
                    self.stats.cert_rejected += 1
                    live = self._leases.pop(lease.lease_id, None)
                    if live is not None:
                        worker.outstanding.pop(lease.lease_id, None)
                        self._requeue(live)
                        self._pump()
                        self._cond.notify_all()
                if solve.trace is not None:
                    tr, tid = solve.trace
                    tr.instant(tid, "cert-reject",
                               worker=worker.wid,
                               lease_id=lease.lease_id)
                    tr.note_anomaly("cert-rejection",
                                    detail=f"worker-{worker.wid}")
                return
        for ev in events:
            solve.reducer.add(ev)
        self._publish_cuts(solve)

    def _publish_cuts(self, solve: _FabricSolve) -> None:
        """Push newly published reducer cuts to workers holding leases
        of this solve."""
        if not self.broadcast_cuts:
            return
        cuts = solve.reducer.cuts()
        targets: List[_Worker] = []
        with self._lock:
            if len(cuts) == len(solve.cuts_sent) or solve.finished:
                return                    # cuts only ever appear
            solve.cuts_sent = cuts
            seen = set()
            for lease in solve.outstanding.values():
                w = self._workers.get(lease.worker_id)
                if w is not None and w.alive and w.wid not in seen:
                    seen.add(w.wid)
                    targets.append(w)
            solve.report.cut_broadcasts += 1
            self.stats.cut_broadcasts += 1
        if solve.trace is not None:
            tr, tid = solve.trace
            tr.instant(tid, "cut-broadcast", workers=len(targets),
                       cuts=len(cuts))
        for w in targets:
            w.sendq.put({"t": "cuts", "solve_id": solve.solve_id,
                         "cuts": cuts})

    def _on_done(self, worker: _Worker, msg: dict) -> None:
        with self._cond:
            self._touch_worker(worker)
            lease = self._leases.pop(msg["lease_id"], None)
            if lease is None:
                return                    # lease was requeued already
            worker.outstanding.pop(lease.lease_id, None)
            lease.solve.outstanding.pop(lease.lease_id, None)
            n = int(msg.get("evaluated", 0))
            lease.solve.report.evaluated += n
            self.stats.evaluated += n
            self._pump()
            self._cond.notify_all()
        trace = lease.solve.trace
        if trace is not None:
            tr, tid = trace
            # the driver-side lease span (issue -> done) plus whatever
            # spans the worker measured locally, rebased onto the
            # lease's issue time so the whole tree shares one clock
            tr.record(tid, "lease", lease.issued_pc,
                      time.perf_counter(), worker=lease.worker_id,
                      lease_id=lease.lease_id, evaluated=n)
            tr.add_remote_spans(tid, msg.get("spans"),
                                base=lease.issued_pc,
                                origin=f"worker-{lease.worker_id}")

    def _on_error(self, worker: _Worker, msg: dict) -> None:
        with self._cond:
            lease = self._leases.pop(msg["lease_id"], None)
            if lease is None:
                return
            worker.outstanding.pop(lease.lease_id, None)
            self._requeue(lease)
            self._pump()
            self._cond.notify_all()

    def _drop_worker(self, worker: _Worker) -> None:
        with self._cond:
            if not worker.alive:
                return
            worker.alive = False
            self._workers.pop(worker.wid, None)
            self.stats.workers_lost += 1
            # the loss belongs to the solves that held leases on this
            # worker -- concurrent solves must not each claim it
            hit: Dict[int, _FabricSolve] = {}
            for lease in list(worker.outstanding.values()):
                self._leases.pop(lease.lease_id, None)
                self._requeue(lease)
                hit[lease.solve.solve_id] = lease.solve
            for solve in hit.values():
                solve.report.workers_lost += 1
            worker.outstanding.clear()
            self._pump()
            self._cond.notify_all()
        worker.sendq.put(None)            # stop the sender thread
        try:
            worker.sock.close()
        except OSError:
            pass

    def _requeue(self, lease: _Lease) -> None:
        """Give a failed lease's unit back to the queue, excluding the
        worker it failed on (caller holds the lock)."""
        solve = lease.solve
        solve.outstanding.pop(lease.lease_id, None)
        if solve.finished:
            return
        unit = _Unit(indices=lease.unit.indices,
                     excluded=lease.unit.excluded | {lease.worker_id})
        solve.pending.appendleft(unit)
        solve.report.requeues += 1
        self.stats.requeues += 1
        if solve.trace is not None:
            tr, tid = solve.trace
            tr.instant(tid, "requeue", worker=lease.worker_id,
                       lease_id=lease.lease_id,
                       units=len(unit.indices))

    # -- scheduling -----------------------------------------------------------
    def _cut_filter(self, solve: _FabricSolve,
                    indices: Sequence[int]) -> List[int]:
        """Drop candidates provably beyond a published cut (dispatch-time
        pruning; racy reads are safe -- cuts only ever appear)."""
        if not self.broadcast_cuts:      # measurement mode: no cut help
            return list(indices)
        cuts = solve.reducer.cuts()
        if not cuts:
            return list(indices)
        space = solve.space
        out = []
        for i in indices:
            cand = space.candidates[i]
            cut = cuts.get(cand.section)
            if cut is None or cand.index <= cut:
                out.append(i)
        return out

    def _pump(self) -> None:
        """Assign pending units to workers with lease capacity (caller
        holds the lock).  Frames go onto each worker's ordered send
        queue -- never blocking here, and always space-before-lease."""
        for solve in self._solves.values():
            if solve.finished:
                continue
            still_pending: deque = deque()
            while solve.pending:
                if (solve.lease_cap is not None
                        and len(solve.outstanding) >= solve.lease_cap):
                    # QoS cap: this solve may not hold more concurrent
                    # leases -- other solves' units still dispatch
                    break
                unit = solve.pending.popleft()
                target = None
                capacity = False
                for w in self._workers.values():
                    if (w.alive
                            and len(w.outstanding) < self.lease_window):
                        capacity = True
                        if w.wid not in unit.excluded:
                            target = w
                            break
                if target is None:
                    still_pending.append(unit)
                    if not capacity:
                        break             # no capacity anywhere: stop
                    continue              # only exclusions blocked this
                                          # unit: later ones may still go
                indices = self._cut_filter(solve, unit.indices)
                if not indices:
                    continue              # whole unit beyond the cuts
                lease = _Lease(lease_id=self._next_lease(), unit=unit,
                               solve=solve, worker_id=target.wid,
                               issued_at=time.monotonic(),
                               issued_pc=time.perf_counter())
                self._leases[lease.lease_id] = lease
                target.outstanding[lease.lease_id] = lease
                solve.outstanding[lease.lease_id] = lease
                solve.workers_used.add(target.wid)
                solve.report.leases += 1
                solve.report.peak_leases = max(solve.report.peak_leases,
                                               len(solve.outstanding))
                self.stats.leases += 1
                if solve.solve_id not in target.spaces:
                    target.spaces.add(solve.solve_id)
                    target.sendq.put({"t": "space",
                                      "solve_id": solve.solve_id,
                                      "payload": solve.payload})
                frame = {
                    "t": "lease", "solve_id": solve.solve_id,
                    "lease_id": lease.lease_id, "indices": indices,
                    "cuts": (solve.cuts_sent if self.broadcast_cuts
                             else {}),
                }
                if solve.trace is not None:
                    # trace_id rides the wire; workers that predate the
                    # key ignore it, and their done frames simply carry
                    # no spans back
                    frame["trace"] = solve.trace[1]
                target.sendq.put(frame)
            still_pending.extend(solve.pending)
            solve.pending = still_pending

    def _check_timeouts(self, solve: _FabricSolve) -> None:
        now = time.monotonic()
        # heartbeat liveness first: a worker that speaks the hb frame
        # and then goes silent (process death, network partition) is
        # dropped after hb_timeout instead of burning the much longer
        # lease_timeout.  Collect under the lock, drop outside it
        # (_drop_worker takes the condition itself).
        with self._lock:
            silent = [w for w in self._workers.values()
                      if w.alive and w.hb_seen
                      and now - w.last_seen > self.hb_timeout]
        for w in silent:
            self._drop_worker(w)
        with self._cond:
            for lease in list(solve.outstanding.values()):
                if now - lease.issued_at > self.lease_timeout:
                    self._leases.pop(lease.lease_id, None)
                    w = self._workers.get(lease.worker_id)
                    if w is not None:
                        w.outstanding.pop(lease.lease_id, None)
                    self._requeue(lease)
            self._pump()

    def _orphan_units(self, solve: _FabricSolve) -> List[_Unit]:
        """Units no live worker may take (caller holds the lock)."""
        alive = {w.wid for w in self._workers.values() if w.alive}
        out, keep = [], deque()
        for unit in solve.pending:
            if not alive or alive <= unit.excluded:
                out.append(unit)
            else:
                keep.append(unit)
        solve.pending = keep
        return out

    # -- the driver -----------------------------------------------------------
    def solve(self, space: CandidateSpace, *,
              reducer: Optional[SolutionReducer] = None,
              scorer=None, chunk: Optional[int] = None,
              verifier=None,
              lease_cap: Optional[int] = None,
              trace=None) -> FabricReport:
        """Evaluate ``space`` across the attached workers, merging every
        stream into ``reducer`` (one is created when omitted -- read the
        merged result off ``reducer.finalize()``).  Blocks until every
        candidate is accounted for; the calling thread doubles as the
        fallback evaluator for units no live worker may take, so the
        solve converges even if every worker dies mid-flight.

        ``verifier`` gates every remote result batch before it reaches
        the reducer: called with the decoded event list, ``None`` means
        accept, anything else rejects the batch and requeues its unit
        away from the sending worker (``FabricReport.cert_rejected``).
        Locally evaluated orphan units bypass it -- they never crossed
        the trust boundary.  Build one with
        ``repro_torch.analysis.make_batch_verifier(space)``.

        ``lease_cap`` bounds this solve's CONCURRENT outstanding leases
        (a low-QoS tenant's solve may not occupy every worker's lease
        window while an interactive solve waits); ``None`` = unbounded.

        ``trace`` is ``(tracer, trace_id)`` from the submitting
        service: the id is stamped on every lease frame (workers echo
        their measured spans on the done frame), and the driver records
        serialize / lease / requeue / cut-broadcast / local-eval spans
        under it -- the whole distributed solve stitches into ONE trace.
        """
        red = reducer if reducer is not None else SolutionReducer(
            space, scorer=scorer)
        step = max(1, int(chunk) if chunk is not None else self.chunk)
        n = len(space)
        # encoding the space (pickle + zlib) can take a while for big
        # problems: do it before touching the fabric lock so concurrent
        # solves' result intake and dispatch never stall behind it
        t_ser = time.perf_counter()
        solve = _FabricSolve(self._next_solve(), space, red,
                             verifier=verifier, lease_cap=lease_cap,
                             trace=trace)
        if trace is not None:
            trace[0].record(trace[1], "serialize", t_ser,
                            time.perf_counter(),
                            bytes=len(solve.payload), candidates=n)
        for lo in range(0, n, step):
            solve.pending.append(
                _Unit(indices=tuple(range(lo, min(lo + step, n)))))
        with self._cond:
            if self._shutdown:
                raise RuntimeError("SolveFabric is shut down")
            self._solves[solve.solve_id] = solve
            self.stats.solves += 1
            self._pump()
        try:
            while True:
                with self._cond:
                    if red.complete() or (not solve.pending
                                          and not solve.outstanding):
                        break
                    self._cond.wait(0.05)
                self._check_timeouts(solve)
                with self._lock:
                    orphans = self._orphan_units(solve)
                for unit in orphans:      # evaluate locally: always converge
                    idxs = self._cut_filter(solve, unit.indices)
                    if not idxs:
                        continue
                    local = 0
                    t_loc = time.perf_counter()
                    for ev in evaluate(shard_from_indices(space, idxs),
                                       gate=red):
                        red.add(ev)
                        local += 1
                    if trace is not None:
                        trace[0].record(trace[1], "local-eval", t_loc,
                                        time.perf_counter(),
                                        units=len(idxs), evaluated=local)
                    with self._lock:
                        solve.report.local_evaluated += local
                        self.stats.local_evaluated += local
        finally:
            retire: List[_Worker] = []
            with self._cond:
                solve.finished = True
                solve.pending.clear()
                for lease in list(solve.outstanding.values()):
                    self._leases.pop(lease.lease_id, None)
                    w = self._workers.get(lease.worker_id)
                    if w is not None:
                        w.outstanding.pop(lease.lease_id, None)
                solve.outstanding.clear()
                self._solves.pop(solve.solve_id, None)
                for w in self._workers.values():
                    if solve.solve_id in w.spaces and w.alive:
                        retire.append(w)
                solve.report.workers_used = len(solve.workers_used)
                self._cond.notify_all()
            for w in retire:
                w.sendq.put({"t": "retire", "solve_id": solve.solve_id})
        return solve.report

    # -- lifecycle ------------------------------------------------------------
    def shutdown(self) -> None:
        with self._cond:
            if self._shutdown:
                return
            self._shutdown = True
            workers = list(self._workers.values())
            self._cond.notify_all()
        try:
            self._listener.close()
        except OSError:
            pass
        for w in workers:
            try:
                write_frame(w.sock, {"t": "shutdown"}, w.send_lock)
            except OSError:
                pass
            w.sendq.put(None)
            try:
                w.sock.close()
            except OSError:
                pass

    def __enter__(self) -> "SolveFabric":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


# ---------------------------------------------------------------------------
# Local worker helper (tests, benchmarks, the quickstart demo)
# ---------------------------------------------------------------------------


def spawn_local_workers(address: str, n: int, *,
                        python: Optional[str] = None,
                        hb_interval: Optional[float] = None
                        ) -> List[subprocess.Popen]:
    """Launch ``n`` solve-worker subprocesses attached to ``address``.

    The callers' ``src`` root is prepended to the children's
    ``PYTHONPATH`` so the workers resolve the same ``repro_torch`` tree as
    this process.  ``hb_interval`` overrides the workers' heartbeat
    cadence (seconds).  Remember to ``terminate()`` them (and
    ``wait()``).
    """
    import repro_torch

    # namespace-package safe: __path__ always exists, __file__ may not
    src = os.path.dirname(os.path.abspath(list(repro_torch.__path__)[0]))
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    argv = [python or sys.executable, "-m",
            "repro_torch.launch.solve_worker", address]
    if hb_interval is not None:
        argv += ["--hb-interval", str(hb_interval)]
    return [subprocess.Popen(argv, env=env) for _ in range(n)]


__all__ = [
    "FabricReport",
    "FabricStats",
    "SolveFabric",
    "read_frame",
    "spawn_local_workers",
    "write_frame",
]
