"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Runs the continuous-batching server against synthetic requests and reports
throughput; ``--smoke`` uses the reduced config (CPU-sized).

The KV-pool banking problem goes through the async PlanService front
door: the server starts on the ticket's fallback artifact (no solver
wait) and hot-swaps to the solved layout between decode ticks.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b --joint
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
        --smoke --device cpu --requests 8 --max-batch 4 \\
        --plan-store /path/to/store --telemetry --verify store

With ``--fabric`` the cold solve runs on REMOTE shard workers: the
launcher opens a :class:`~repro_torch.core.fabric.SolveFabric` listener
(``--fabric-listen host:port``) and prints the address; attach any
number of hosts with

    PYTHONPATH=src python -m repro_torch.launch.solve_worker HOST:PORT

and the server's best-so-far promotions / solved hot-swap work exactly
as in-process -- the shards just ran somewhere else.

Any family that ``models.get_model`` builds serves: the dense transformers,
the MoE family (its expert buffer filled by the ``moe_dispatch`` kernel on
the card), the Mamba2 SSM and the Zamba2 hybrid (one shared attention
block).  The server prefills a request through the decode step, one token
at a time, so the SSM families run their O(1) recurrence here and not the
chunked scan of their ``prefill``.  Cold solves run on the service's
in-process worker pool, or on the fabric's workers with ``--fabric``.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model, the cache and the record table "
                         "live (default cuda; fails without a card)")
    ap.add_argument("--fabric", action="store_true",
                    help="run cold solves on remote shard workers: opens a "
                         "SolveFabric listener and prints the address to "
                         "attach solve_worker processes to")
    ap.add_argument("--fabric-listen", default="127.0.0.1:0",
                    help="host:port the fabric accepts workers on "
                         "(port 0 = ephemeral; bind a private interface)")
    ap.add_argument("--fabric-wait-workers", type=int, default=0,
                    help="block up to 30s for this many workers before "
                         "serving (0 = serve immediately; a fabric with no "
                         "workers falls back to the in-process pool)")
    ap.add_argument("--plan-store", default=None,
                    help="directory shared across serving processes; a warm "
                         "store answers the submit before the first tick")
    ap.add_argument("--plan-store-max-mb", type=float, default=None,
                    help="size-cap the plan store: LRU entries are evicted "
                         "past this many MB, and stale SIGNATURE_VERSION "
                         "entries are swept at startup")
    ap.add_argument("--telemetry", action="store_true",
                    help="measured-cost feedback: time every banked "
                         "gather/scatter and decode tick, rank the KV plan "
                         "with scorer=\"measured\", persist observations "
                         "in the plan store's telemetry/ sidecar, and "
                         "demote + re-solve plans the measurements prove "
                         "slow")
    ap.add_argument("--verify", choices=("off", "store", "all"),
                    default="off",
                    help="static verification: lint the KV-pool program "
                         "before solving and certify solver output before "
                         "it is cached (certificates persist beside stored "
                         "plans, which re-verify on hydrate); \"all\" also "
                         "certifies every result batch remote fabric "
                         "workers stream back, rejecting forged ones")
    ap.add_argument("--tenant", default=None,
                    help="tenant name this server submits under on a "
                         "shared multi-tenant service (per-tenant stats "
                         "slice, quotas, QoS band; see --qos and "
                         "launch/serve_fleet.py for the fleet story)")
    ap.add_argument("--qos", default=None,
                    choices=("interactive", "batch", "best_effort",
                             "default"),
                    help="QoS class to register --tenant under "
                         "(default: the registry's permissive default)")
    ap.add_argument("--joint", action="store_true",
                    help="whole-model joint planning: ONE submit_joint "
                         "covers every banked memory this architecture "
                         "serves through (kv_pool + moe_dispatch / "
                         "ssm_state), co-selected under a shared "
                         "resource budget; the server promotes ALL "
                         "pools to the joint layouts atomically "
                         "between decode ticks")
    ap.add_argument("--budget-bram", type=int, default=None,
                    help="joint budget: cap the summed BRAM draw "
                         "across the model's memories")
    ap.add_argument("--budget-luts", type=float, default=None,
                    help="joint budget: cap the summed LUT draw")
    ap.add_argument("--budget-banks", type=int, default=None,
                    help="joint budget: cap total physical banks "
                         "(duplicates included)")
    ap.add_argument("--stats-interval", type=float, default=0.0,
                    help="print the service's stats counters (observations/"
                         "refreshes/demotions included, per-tenant slices "
                         "nested under \"tenants\") every N seconds "
                         "while serving (0 = off)")
    ap.add_argument("--trace-dir", default=None,
                    help="enable plan-plane tracing and write Chrome "
                         "trace_event JSON here: the completed-ticket "
                         "flight recorder dumps on exit, anomalies "
                         "(latency SLO, cert rejection, demotion) dump "
                         "as they happen -- load the files in "
                         "chrome://tracing or Perfetto")
    ap.add_argument("--trace-slo-ms", type=float, default=None,
                    help="flight-recorder latency SLO: a ticket slower "
                         "than this many ms end-to-end dumps its trace "
                         "as an anomaly (requires --trace-dir or "
                         "--metrics-port)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics (Prometheus text), /traces "
                         "(Chrome trace JSON) and /stats (registry "
                         "snapshot) on 127.0.0.1:PORT from a stdlib "
                         "HTTP thread (0 = ephemeral, address printed)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..configs import get_arch
    from ..core.fabric import SolveFabric
    from ..core.service import PlanService
    from ..core.store import DirectoryStore
    from ..models import get_model
    from ..runtime.server import Request, Server, joint_ticket, page_ticket

    # plan store + fabric first: sweeping stale-version entries, binding
    # the worker listener, and building the service all overlap the
    # model build below
    store = None
    if args.plan_store:
        max_bytes = (int(args.plan_store_max_mb * 2 ** 20)
                     if args.plan_store_max_mb is not None else None)
        store = DirectoryStore(args.plan_store, max_bytes=max_bytes)
        swept = store.sweep()
        if swept:
            print(f"plan store: swept {swept} stale-version entries")
    fabric = None
    if args.fabric:
        host, _, port = args.fabric_listen.rpartition(":")
        fabric = SolveFabric(listen=(host or "127.0.0.1", int(port)))
        print(f"solve fabric listening on {fabric.address} -- attach "
              f"workers with: python -m repro_torch.launch.solve_worker "
              f"{fabric.address}")
        if args.fabric_wait_workers:
            if fabric.wait_for_workers(args.fabric_wait_workers,
                                       timeout=30.0):
                print(f"fabric: {fabric.workers_alive} workers attached")
            else:
                print("fabric: workers did not attach in time; cold "
                      "solves fall back to the in-process pool")
    tenants = None
    if args.tenant:
        from ..runtime.tenancy import TenantRegistry
        tenants = TenantRegistry()
        tenants.register(args.tenant, args.qos or "default")
        print(f"tenant {args.tenant!r} registered "
              f"(qos={args.qos or 'default'})")
    observe = (args.trace_dir is not None or args.metrics_port is not None
               or args.trace_slo_ms is not None)
    service = None
    if store is not None or fabric is not None or args.telemetry \
            or args.verify != "off" or tenants is not None or observe:
        service = PlanService(
            store=store,
            executor="fabric" if fabric is not None else "pool",
            fabric=fabric,
            verify=args.verify,
            tenants=tenants)
    obs_server = None
    if observe:
        service.enable_tracing(slo_ms=args.trace_slo_ms,
                               trace_dir=args.trace_dir)
        if args.trace_dir is not None:
            print(f"tracing: flight recorder armed, Chrome trace dumps "
                  f"land in {args.trace_dir}"
                  + (f" (SLO {args.trace_slo_ms:g} ms)"
                     if args.trace_slo_ms is not None else ""))
        if args.metrics_port is not None:
            from ..core.tracing import start_observability_server
            obs_server = start_observability_server(
                service.metrics, service.recorder, tracer=service.tracer,
                port=args.metrics_port)
            host_, port_ = obs_server.server_address[:2]
            print(f"metrics: http://{host_}:{port_}/metrics "
                  f"(also /traces, /stats)")
    if args.verify != "off":
        print(f"verification armed ({args.verify}): lint gate + "
              f"independent conflict certification"
              + (" + fabric batch checking" if args.verify == "all" else ""))
    if args.telemetry:
        service.enable_telemetry()
        print("telemetry: measured-cost feedback enabled "
              "(scorer=measured, demotion armed)")
    if args.stats_interval > 0 and service is not None:
        import json as json_mod
        import threading

        def _stats_loop():
            # per-tenant slices nest under "tenants" and the fabric's
            # live counters (heartbeats included) under "fabric" on
            # EVERY periodic line, not just the exit report; with
            # tracing on, the MetricsRegistry gauges ride along too
            while True:
                time.sleep(args.stats_interval)
                line = service.stats.as_dict()
                if fabric is not None:
                    fs = fabric.stats
                    line["fabric"] = {
                        "workers_alive": fabric.workers_alive,
                        "heartbeats": fs.heartbeats,
                        "leases": fs.leases,
                        "requeues": fs.requeues,
                        "evaluated": fs.evaluated,
                    }
                if service.metrics is not None:
                    snap = service.metrics.snapshot()
                    if snap.get("gauges"):
                        line["gauges"] = snap["gauges"]
                print("stats:", json_mod.dumps(line))

        threading.Thread(target=_stats_loop, daemon=True,
                         name="serve-stats").start()

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    model = get_model(cfg)

    # submit -> ticket: model build and solver overlap; the server's first
    # tick runs from the fallback artifact if the solve hasn't landed
    t_submit = time.perf_counter()
    if args.joint:
        from ..core.jointplan import ResourceBudget
        budget = None
        if (args.budget_bram is not None or args.budget_luts is not None
                or args.budget_banks is not None):
            budget = ResourceBudget(bram=args.budget_bram,
                                    lut=args.budget_luts,
                                    banks=args.budget_banks)
        ticket = joint_ticket(cfg, max_len=args.max_len,
                              page=min(16, args.max_len // 4),
                              readers=args.max_batch, service=service,
                              budget=budget,
                              scorer="measured" if args.telemetry else None,
                              tenant=args.tenant)
        print(f"submitted joint plan ({len(ticket.members) or 'cached'} "
              f"memories) in "
              f"{(time.perf_counter() - t_submit) * 1e3:.2f} ms "
              f"(ticket: {ticket.status})")
    else:
        ticket = page_ticket(cfg, max_len=args.max_len,
                             page=min(16, args.max_len // 4),
                             readers=args.max_batch, service=service,
                             scorer="measured" if args.telemetry else None,
                             tenant=args.tenant)
        print(f"submitted KV-pool plan in "
              f"{(time.perf_counter() - t_submit) * 1e3:.2f} ms "
              f"(ticket: {ticket.status})")
    server = Server(model, max_batch=args.max_batch, max_len=args.max_len,
                    kv_plan=ticket, device=args.device, seed=args.seed)
    print("serving from:", server.pager.artifact.describe())
    print(f"page pool: {server.pager.slots} slots x "
          f"{server.pager.pages_per_slot} pages x "
          f"{server.pager.page_size} tokens")

    rng = np.random.default_rng(args.seed)
    for uid in range(args.requests):
        prompt = rng.integers(2, cfg.vocab - 1,
                              size=int(rng.integers(3, 8))).astype(np.int32)
        server.submit(Request(uid=uid, prompt=prompt, max_new=args.max_new))
    t0 = time.perf_counter()
    server.run(max_ticks=5000)
    if server.device.type == "cuda":
        torch.cuda.synchronize(server.device)
    dt = time.perf_counter() - t0
    total_tokens = args.requests * args.max_new
    if server.promotions:
        print(f"promoted to best-so-far layouts {server.promotions}x "
              f"before the search drained")
    if server.swaps:
        print(f"hot-swapped to solved layout after tick <= {server.ticks}: "
              f"{server.pager.artifact.describe()}")
    if args.joint:
        if server.joint_promotions or server.joint_swaps:
            print(f"joint: {server.joint_promotions} coherent all-pool "
                  f"promotions, {server.joint_swaps} final swaps "
                  f"(generations {server.generations}, "
                  f"coherent={server.coherent})")
        if ticket.done():
            jp = ticket.result()
            print(f"joint selection: fits={jp.fits()} "
                  f"feasible={jp.feasible} "
                  f"total={jp.total_use.as_dict()}")
    where = (torch.cuda.get_device_name(server.device)
             if server.device.type == "cuda" else "the host CPU")
    print(f"served {args.requests} requests ({total_tokens} tokens) in "
          f"{server.ticks} ticks, {dt:.1f}s "
          f"({total_tokens/dt:.1f} tok/s on {where})")
    if service is not None and service.stats.fabric_solves:
        print(f"fabric: {service.stats.fabric_solves} remote solves, "
              f"{service.stats.fabric_leases} leases, "
              f"{service.stats.fabric_cut_broadcasts} cut broadcasts, "
              f"{service.stats.fabric_requeues} requeues")
    if args.verify != "off" and service is not None:
        s = service.stats
        print(f"verification: {s.certified} certified, "
              f"{s.cert_failures} refused, {s.cert_rejected} fabric "
              f"batches rejected, {s.lint_errors} lint refusals")
    if args.tenant and service is not None:
        import json as json_mod
        slice_ = service.stats.for_tenant(args.tenant)
        print(f"tenant {args.tenant!r} stats:",
              json_mod.dumps({k: v for k, v
                              in slice_.as_dict(False).items() if v}))
    if args.telemetry and service is not None \
            and service.telemetry is not None:
        flushed = service.telemetry.flush()
        s = service.stats
        print(f"telemetry: {s.observations} observations "
              f"({flushed} flushed at exit), {s.refreshes} scorer "
              f"refreshes, {s.demotions} demotions")
    if service is not None and service.recorder is not None:
        rec = service.recorder
        n_anom = len(rec.anomalies())
        if args.trace_dir is not None and rec.traces():
            import os as os_mod
            path = rec.dump(os_mod.path.join(args.trace_dir,
                                             "serve_trace.json"))
            print(f"tracing: {len(rec.traces())} ticket traces "
                  f"({n_anom} anomalies) -> {path}")
        elif n_anom:
            print(f"tracing: {n_anom} anomalies recorded "
                  f"(pass --trace-dir to keep the dumps)")
    if obs_server is not None:
        obs_server.shutdown()
    if fabric is not None:
        fabric.shutdown()
    return server


if __name__ == "__main__":
    main()
