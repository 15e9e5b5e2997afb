"""Remote solve worker: attach this host's CPU to a SolveFabric.

    python -m repro_torch.launch.solve_worker HOST:PORT [--procs N]

Connects to the fabric a serving launcher opened with ``--fabric``
(``launch/serve.py`` and ``launch/serve_fleet.py`` print the address),
receives candidate spaces and work-unit leases over the wire protocol,
evaluates them through the exact same
:func:`repro_torch.core.candidates.evaluate` pipeline the in-process pool
uses, and streams scored solution batches back.  Run it on N hosts to
attach N hosts to one service.

Cut updates broadcast by the service land in a :class:`CutGate`, so a
lease already being evaluated prunes beyond-cut candidates mid-stream
-- the remote analogue of the in-process reducer gate.

Evaluation is pure numpy on the host.  The package's ``__init__`` imports
``torch``, so a worker takes a few seconds to start, but it never touches
the card: ``main`` hides every CUDA device from the process before any
work arrives, so no worker holds a CUDA context (and its memory) beside
the servers that share the card.
"""

from __future__ import annotations

import argparse
import os
import queue
import socket
import threading
import time
from typing import Dict

from ..core.candidates import (
    CandidateSpace,
    CutGate,
    evaluate,
    events_to_wire,
    shard_from_indices,
    space_from_wire,
)
from ..core.fabric import read_frame, write_frame
from ..core.tracing import spans_to_wire

RESULT_BATCH = 8      # events per result frame: keeps cuts/best-so-far fresh
HB_INTERVAL = 2.0     # seconds between heartbeat frames (0 disables)


def run_worker(address: str, *, result_batch: int = RESULT_BATCH,
               hb_interval: float = HB_INTERVAL) -> None:
    """Serve leases from the fabric at ``address`` until it goes away.

    A daemon thread sends a tiny ``{"t": "hb"}`` frame every
    ``hb_interval`` seconds so the fabric can detect this process dying
    (or partitioning) within ``hb_timeout`` instead of waiting out a
    full lease timeout.  Heartbeats prove the *process* alive, not lease
    progress -- a hung evaluation still loses its lease on time.
    """
    host, _, port = address.rpartition(":")
    sock = socket.create_connection((host or "127.0.0.1", int(port)))
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    send_lock = threading.Lock()
    write_frame(sock, {"t": "join", "pid": os.getpid(),
                       "host": socket.gethostname()}, send_lock)

    spaces: Dict[int, CandidateSpace] = {}
    gates: Dict[int, CutGate] = {}
    leases: "queue.Queue" = queue.Queue()
    stop = threading.Event()

    def heartbeat() -> None:
        while not stop.wait(hb_interval):
            try:
                write_frame(sock, {"t": "hb"}, send_lock)
            except OSError:
                return                    # fabric went away: main loop ends

    if hb_interval > 0:
        threading.Thread(target=heartbeat, daemon=True,
                         name="fabric-hb").start()

    def reader() -> None:
        # cuts and retirements apply IMMEDIATELY (mid-evaluation); only
        # leases queue behind the current one
        try:
            while True:
                msg = read_frame(sock)
                t = msg.get("t")
                if t == "space":
                    sid = msg["solve_id"]
                    spaces[sid] = space_from_wire(msg["payload"])
                    gates[sid] = CutGate()
                elif t == "lease":
                    leases.put(msg)
                elif t == "cuts":
                    gate = gates.get(msg["solve_id"])
                    if gate is not None:
                        gate.update(msg["cuts"])
                elif t == "retire":
                    spaces.pop(msg["solve_id"], None)
                    gate = gates.pop(msg["solve_id"], None)
                    if gate is not None:
                        gate.cancel()     # stop any straggling lease
                elif t == "shutdown":
                    break
        except Exception:
            # EOF, dead socket, or an undecodable frame: all mean this
            # fabric is no longer usable from here
            pass
        finally:
            # ALWAYS unblock the main loop -- a reader death must end
            # the process, never hang it on leases.get()
            leases.put(None)

    threading.Thread(target=reader, daemon=True, name="fabric-reader").start()

    while True:
        msg = leases.get()
        if msg is None:
            break
        sid, lid = msg["solve_id"], msg["lease_id"]
        space, gate = spaces.get(sid), gates.get(sid)
        try:
            if space is None or gate is None:
                # no space for this lease (solve retired while queued,
                # or frames raced): NACK so the fabric REQUEUES the unit
                # rather than counting it complete
                write_frame(sock, {"t": "error", "lease_id": lid,
                                   "error": f"no space for solve {sid}"},
                            send_lock)
                continue
            gate.update(msg.get("cuts") or {})
            # a traced lease carries the driver's trace_id: measure the
            # eval and result-wire stages locally (perf_counter, relative
            # to lease receipt) and echo them on the done frame so the
            # driver stitches them into ONE trace
            traced = msg.get("trace") is not None
            t_lease = time.perf_counter()
            wire_s = 0.0
            shard = shard_from_indices(space, msg["indices"])
            batch, evaluated = [], 0
            t_eval = time.perf_counter()
            for ev in evaluate(shard, gate=gate):
                batch.append(ev)
                evaluated += 1
                if len(batch) >= result_batch:
                    t_w = time.perf_counter()
                    write_frame(sock, {"t": "results", "lease_id": lid,
                                       "payload": events_to_wire(batch)},
                                send_lock)
                    wire_s += time.perf_counter() - t_w
                    batch = []
            if batch:
                t_w = time.perf_counter()
                write_frame(sock, {"t": "results", "lease_id": lid,
                                   "payload": events_to_wire(batch)},
                            send_lock)
                wire_s += time.perf_counter() - t_w
            done = {"t": "done", "lease_id": lid, "evaluated": evaluated}
            if traced:
                now = time.perf_counter()
                done["spans"] = spans_to_wire([
                    {"name": "w-lease", "start": t_lease, "end": now,
                     "attrs": {"pid": os.getpid(),
                               "wire_ms": round(wire_s * 1e3, 3)}},
                    {"name": "w-eval", "start": t_eval, "end": now,
                     "attrs": {"evaluated": evaluated,
                               "units": len(msg["indices"])}},
                ], t_lease)
            write_frame(sock, done, send_lock)
        except OSError:
            break                         # fabric went away
        except Exception as e:            # solver bug: report, keep serving
            try:
                write_frame(sock, {"t": "error", "lease_id": lid,
                                   "error": repr(e)}, send_lock)
            except OSError:
                break
    stop.set()
    try:
        sock.close()
    except OSError:
        pass


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="attach solve worker process(es) to a SolveFabric")
    ap.add_argument("address", help="HOST:PORT the fabric listens on "
                                    "(launch/serve.py --fabric and "
                                    "launch/serve_fleet.py --fabric print "
                                    "it)")
    ap.add_argument("--procs", type=int, default=1,
                    help="worker processes to run from this invocation "
                         "(each gets its own connection and lease window)")
    ap.add_argument("--hb-interval", type=float, default=HB_INTERVAL,
                    help="seconds between liveness heartbeat frames "
                         "(0 disables; the fabric then falls back to "
                         "lease timeouts for dead-worker detection)")
    args = ap.parse_args(argv)
    # the worker evaluates numpy only: a CUDA context here would take card
    # memory from the servers (an unpickled CUDA tensor, say)
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    if args.procs <= 1:
        run_worker(args.address, hb_interval=args.hb_interval)
        return
    import multiprocessing as mp

    procs = [mp.Process(target=run_worker, args=(args.address,),
                        kwargs={"hb_interval": args.hb_interval})
             for _ in range(args.procs)]
    for p in procs:
        p.start()
    for p in procs:
        p.join()


if __name__ == "__main__":
    main()
