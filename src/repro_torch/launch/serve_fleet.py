"""Fleet launcher: MANY servers, ONE planning plane.

    PYTHONPATH=src python -m repro_torch.launch.serve_fleet
    PYTHONPATH=src python -m repro_torch.launch.serve_fleet --smoke \
        --device cpu [--fabric]

Runs three ``Server`` instances with genuinely different model configs
-- a dense transformer (qwen2_7b), an MoE (olmoe_1b_7b), and an SSM
(mamba2_370m) -- against ONE shared :class:`PlanService`, one shared
plan store, and (with ``--fabric``) one shared solve fabric.  Each
server is a registered **tenant** with its own QoS class
(:mod:`repro_torch.runtime.tenancy`):

* ``interactive`` -- drains first; its KV-pool ticket must not sit
  behind anyone's batch work.
* ``batch`` -- a band behind, quota-capped; with ``--noise N`` it also
  floods N unique cold solves first, so the pool is *saturated* before
  the interactive server ever submits (the starvation scenario QoS
  exists to prevent).
* ``best_effort`` -- last band, one shard per solve, two in flight;
  over-quota submits defer (fallback artifact still serves -- the
  server starts ticking regardless) and a full backlog sheds honestly.

Every server serves synthetic traffic concurrently, one thread each, all
on one ``--device`` (default ``cuda``: the three models share one card),
then the launcher prints per-tenant ticket latency and the per-tenant
stats slices -- which sum, counter for counter, to the global
``service.stats`` -- and exits 1 when they do not.

``--tenants name:qos:arch,...`` overrides the fleet composition.  With
``--fabric`` the cold solves run on solve workers attached to the fleet's
fabric (``python -m repro_torch.launch.solve_worker HOST:PORT``); a caller
of :func:`main` may hand in a fabric it opened and attached workers to.
"""

from __future__ import annotations

import argparse
import threading
import time

# (tenant, qos class, arch id): a transformer, an MoE, and an SSM --
# three genuinely different model families on one planning plane
DEFAULT_FLEET = (
    ("interactive", "interactive", "qwen2_7b"),
    ("batch", "batch", "olmoe_1b_7b"),
    ("best_effort", "best_effort", "mamba2_370m"),
)


def _noise_program(i: int, dims: int = 4096):
    """A unique cold banking problem (per ``i``): solver saturation."""
    from ..core import AccessDecl, Counter, Ctrl, MemorySpec, Program, Sched
    from ..core.polytope import Affine
    mem = MemorySpec(f"noise{i}", dims=(dims,), word_bits=32, ports=1)
    return Program(
        root=Ctrl(
            "reader", Sched.INNER,
            counters=[Counter("i", start=0, step=1, count=32 + i, par=8)],
            accesses=[AccessDecl(mem.name, (Affine.of(i=1),), label="rd")],
        ),
        memories={mem.name: mem},
    ), mem.name


def run_tenant(service, name: str, arch: str, offset: int, *,
               smoke: bool = False, requests: int = 4, max_batch: int = 2,
               max_len: int = 64, max_new: int = 4, seed: int = 0,
               device="cuda"):
    """One server of the fleet, from submit to drain: its KV-pool ticket
    submitted under tenant ``name`` on ``service``, ``requests`` synthetic
    prompts from ``seed + offset``.  Returns the tenant's result line, the
    server and its requests (their ``out`` tokens)."""
    import numpy as np

    from ..configs import get_arch
    from ..models import get_model
    from ..runtime.server import Request, Server, page_ticket

    cfg = get_arch(arch)
    if smoke:
        cfg = cfg.reduced()
    model = get_model(cfg)
    # distinct max_len per server: each tenant poses its OWN
    # banking problem (no cross-tenant dedup in this demo)
    max_len = max_len + 16 * offset
    t0 = time.perf_counter()
    ticket = page_ticket(cfg, max_len=max_len, page=min(16, max_len // 4),
                         readers=max_batch, service=service, tenant=name)
    submit_ms = (time.perf_counter() - t0) * 1e3
    server = Server(model, max_batch=max_batch, max_len=max_len,
                    kv_plan=ticket, device=device, seed=seed)
    rng = np.random.default_rng(seed + offset)
    reqs = []
    for uid in range(requests):
        prompt = rng.integers(2, cfg.vocab - 1,
                              size=int(rng.integers(3, 8))).astype(np.int32)
        reqs.append(Request(uid=uid, prompt=prompt, max_new=max_new))
        server.submit(reqs[-1])
    t1 = time.perf_counter()
    server.run(max_ticks=5000)
    if server.device.type == "cuda":
        import torch
        torch.cuda.synchronize(server.device)
    serve_s = time.perf_counter() - t1
    ticket.wait(timeout=120)
    result = {
        "arch": arch,
        "submit_ms": round(submit_ms, 2),
        "ticket_latency_s": (
            round(ticket.resolved_at - ticket.submitted_at, 3)
            if ticket.resolved_at is not None else None),
        "ticket_status": ticket.status,
        "deferred": ticket.deferred,
        "ticks": server.ticks,
        "serve_s": round(serve_s, 2),
        "swaps": server.swaps,
    }
    return result, server, reqs


def main(argv=None, fabric=None):
    ap = argparse.ArgumentParser(
        description="run a multi-tenant server fleet over ONE PlanService")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs (CPU-sized)")
    ap.add_argument("--tenants", default=None,
                    help="fleet spec name:qos:arch[,name:qos:arch...] "
                         "(default: interactive/batch/best_effort over "
                         "qwen2_7b/olmoe_1b_7b/mamba2_370m)")
    ap.add_argument("--requests", type=int, default=4,
                    help="synthetic requests per server")
    ap.add_argument("--max-batch", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=4)
    ap.add_argument("--noise", type=int, default=6,
                    help="unique cold solves the batch tenant floods "
                         "BEFORE the fleet submits (solver saturation)")
    ap.add_argument("--workers", type=int, default=2,
                    help="shared service worker-pool width")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where every server's model, cache and record "
                         "table live (default cuda; fails without a card)")
    ap.add_argument("--plan-store", default=None,
                    help="shared DirectoryStore path (one store for the "
                         "whole fleet)")
    ap.add_argument("--fabric", action="store_true",
                    help="open a shared SolveFabric listener and print "
                         "the address to attach solve workers to")
    ap.add_argument("--fabric-wait-workers", type=int, default=0)
    ap.add_argument("--stats-interval", type=float, default=0.0,
                    help="print global + per-tenant stats every N seconds")
    ap.add_argument("--trace-dir", default=None,
                    help="enable plan-plane tracing; the flight recorder "
                         "dumps Chrome trace_event JSON here on exit and "
                         "on anomalies")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics, /traces and /stats on "
                         "127.0.0.1:PORT (0 = ephemeral)")
    args = ap.parse_args(argv)

    import json

    from ..core.fabric import SolveFabric
    from ..core.service import PlanService
    from ..core.store import DirectoryStore
    from ..runtime.tenancy import TenantRegistry

    fleet = []
    for spec in (args.tenants.split(",") if args.tenants
                 else [":".join(f) for f in DEFAULT_FLEET]):
        name, qos, arch = spec.split(":")
        fleet.append((name, qos, arch))

    # ---- the ONE shared planning plane --------------------------------
    store = DirectoryStore(args.plan_store) if args.plan_store else None
    own_fabric = args.fabric and fabric is None
    if own_fabric:
        fabric = SolveFabric()
        print(f"shared solve fabric on {fabric.address} -- attach with: "
              f"python -m repro_torch.launch.solve_worker {fabric.address}")
        if args.fabric_wait_workers:
            fabric.wait_for_workers(args.fabric_wait_workers, timeout=30.0)
            print(f"fabric: {fabric.workers_alive} workers attached")
    registry = TenantRegistry()
    for name, qos, _ in fleet:
        registry.register(name, qos)
    service = PlanService(
        store=store, workers=args.workers,
        executor="fabric" if fabric is not None else "pool",
        fabric=fabric, tenants=registry)
    print("tenants:", ", ".join(f"{n} (qos={q}, arch={a})"
                                for n, q, a in fleet))
    obs_server = None
    if args.trace_dir is not None or args.metrics_port is not None:
        service.enable_tracing(trace_dir=args.trace_dir)
        if args.metrics_port is not None:
            from ..core.tracing import start_observability_server
            obs_server = start_observability_server(
                service.metrics, service.recorder, tracer=service.tracer,
                port=args.metrics_port)
            host_, port_ = obs_server.server_address[:2]
            print(f"metrics: http://{host_}:{port_}/metrics")

    if args.stats_interval > 0:
        def _stats_loop():
            # per-tenant slices nest under "tenants"; live fabric
            # heartbeat/lease counters ride along when a fabric is up
            while True:
                time.sleep(args.stats_interval)
                line = service.stats.as_dict()
                if fabric is not None:
                    line["fabric"] = {
                        "workers_alive": fabric.workers_alive,
                        "heartbeats": fabric.stats.heartbeats,
                        "leases": fabric.stats.leases,
                    }
                print("stats:", json.dumps(line))
        threading.Thread(target=_stats_loop, daemon=True,
                         name="fleet-stats").start()

    # ---- saturate first: the batch tenant floods unique cold solves ---
    noise_name = next((n for n, q, _ in fleet if q == "batch"),
                      fleet[-1][0])
    noise_tickets = []
    for i in range(args.noise):
        program, memory = _noise_program(i)
        noise_tickets.append(service.submit(
            program, memory, use_cache=False, tenant=noise_name))
    n_deferred = sum(1 for t in noise_tickets if t.deferred)
    if noise_tickets:
        print(f"noise: {len(noise_tickets)} unique cold solves from "
              f"{noise_name!r} ({n_deferred} deferred by admission; every "
              f"ticket's fallback artifact is still servable)")

    # ---- the fleet: one thread per server, one service under all ------
    results = {}
    errors = {}

    servers, requests = {}, {}

    def run_server(name: str, arch: str, offset: int) -> None:
        try:
            results[name], servers[name], requests[name] = run_tenant(
                service, name, arch, offset, smoke=args.smoke,
                requests=args.requests, max_batch=args.max_batch,
                max_len=args.max_len, max_new=args.max_new, seed=args.seed,
                device=args.device)
        except Exception as e:      # surfaced after the join below
            errors[name] = e

    threads = [threading.Thread(target=run_server, args=(n, a, i),
                                name=f"fleet-{n}")
               for i, (n, _, a) in enumerate(fleet)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, e in errors.items():
        raise SystemExit(f"server {name!r} failed: {e!r}")

    service.drain(timeout=120)
    for t in noise_tickets:
        t.wait(timeout=120)

    # ---- report -------------------------------------------------------
    print()
    for name, _, _ in fleet:
        print(f"{name:>12}: {json.dumps(results[name])}")
    stats = service.stats.as_dict()
    slices = stats.pop("tenants", {})
    print("\nglobal stats:", json.dumps({k: v for k, v in stats.items()
                                         if v}))
    for name, s in slices.items():
        print(f"  {name:>12}:", json.dumps({k: v for k, v in s.items()
                                            if v}))
    # the slices MUST sum to the global counters -- the acceptance
    # property serve_fleet demonstrates live
    mismatched = [k for k, v in stats.items()
                  if v != sum(s.get(k, 0) for s in slices.values())]
    print("slice reconciliation:",
          "exact" if not mismatched else f"MISMATCH on {mismatched}")
    if service.recorder is not None and args.trace_dir is not None \
            and service.recorder.traces():
        import os as os_mod
        path = service.recorder.dump(
            os_mod.path.join(args.trace_dir, "fleet_trace.json"))
        print(f"tracing: {len(service.recorder.traces())} ticket "
              f"traces -> {path}")
    if obs_server is not None:
        obs_server.shutdown()
    if own_fabric:
        fabric.shutdown()
    service.shutdown()
    if mismatched:
        raise SystemExit(1)
    return {"results": results, "servers": servers, "requests": requests,
            "service": service, "stats": stats, "slices": slices,
            "noise": noise_tickets}


if __name__ == "__main__":
    main()
