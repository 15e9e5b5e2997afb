"""Quickstart: the submit -> ticket -> compile -> execute flow of the plan
service, on one device.

1. **Submit**: ``PlanService.submit`` poses the banking problem and returns
   a ``PlanTicket`` at once; the solver runs on a worker pool.
2. **Execute now**: ``ticket.fallback()`` is an always-available compiled
   artifact (one bank, no solver work): pack a table and gather through
   the banked-gather kernel while the solve is in flight.
3. **Hot-swap**: once the ticket is done, ``ticket.artifact()`` is the
   solved ``CompiledBankingPlan``; unpack from the fallback layout, repack
   into the solved one, and gather the same rows.

Then: a batched gather (one launch for a stacked index matrix), a warm
resubmit, the sharded search streaming its best-so-far, the candidate
space enumerated by hand, telemetry with a measured demotion, lint ->
solve -> certify with a forged scheme refuted, the same solve on a
``SolveFabric`` of two worker processes, two tenants under QoS classes,
joint planning of two memories under one budget, and tracing with a
Chrome-trace dump and Prometheus ``/metrics``.

The table and the indices are tensors on ``--device`` (default ``cuda``,
which raises without a card): there the gathers through the fallback and
the solved artifact launch the banked-gather kernel.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.core import (AccessDecl, Counter, Ctrl, MemorySpec,
                              PlanService, Program, Sched)
from repro_torch.core.polytope import Affine
from repro_torch.device import resolve_device
from repro_torch.kernels import ref


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    device = resolve_device(ap.parse_args(argv).device)

    # A 1-D table read by 8 vectorized lanes each cycle (Fig. 1 flow).
    mem = MemorySpec("table", dims=(256,), word_bits=32, ports=1)
    program = Program(
        root=Ctrl(
            "reader", Sched.INNER,
            counters=[Counter("i", start=0, step=1, count=32, par=8)],
            accesses=[AccessDecl("table", (Affine.of(i=1),), label="rd")],
        ),
        memories={"table": mem},
    )

    # SUBMIT: returns a ticket, not a plan -- the solve is backgrounded.
    # (Pass store="plans/" to share solved plans across processes.)
    service = PlanService(workers=2)
    ticket = service.submit(program, "table")
    print(f"submitted: signature={ticket.signature} status={ticket.status}")

    # EXECUTE NOW: the fallback artifact needs no solver -- serve from it.
    D = 16
    flat = torch.as_tensor(np.random.default_rng(0).normal(size=(256, D)),
                           dtype=torch.float32, device=device)
    fb = ticket.fallback()
    print("fallback :", fb.describe())
    table = fb.pack(flat)
    idx = torch.tensor([0, 7, 63, 101, 255, 128, 33, 200],
                       dtype=torch.int32, device=device)
    first = fb.gather(table, idx)
    want = ref.banked_gather_reference(flat, idx)
    assert torch.equal(first, want)
    print("served from the fallback while the solver ran: exact ✓")

    # HOT-SWAP: block for the solved plan (a server would poll done()
    # between ticks), repack, and gather identically through the solved
    # resolution circuit -- the compiled BA/BO arithmetic runs in front of
    # the kernel's load, where an FPGA would put the circuit.
    plan = ticket.result(timeout=60)
    print(f"solved   : {plan.num_candidates} candidates in "
          f"{plan.solve_seconds*1e3:.1f} ms (scorer={plan.scorer_name})")
    art = ticket.artifact()
    print("artifact :", art.describe())
    table = art.pack(fb.unpack(table))        # logical rows survive the swap
    got = art.gather(table, idx)
    assert torch.equal(got, first)
    print(f"hot-swapped to {art.n_banks} banks: identical gather ✓")

    # Batched execution: a stacked (T, R) index matrix -- e.g. one decode
    # tick's reads for every active sequence -- is ONE kernel launch.
    ticks = torch.stack([idx[:4], idx[4:]])   # (2 row-sets, 4 rows each)
    batched = art.gather(table, ticks)
    assert batched.shape == (2, 4, D)
    print(f"batched gather over {tuple(ticks.shape)} indices: one kernel "
          f"launch ✓")

    # Structurally identical resubmit: answered before the ticket returns.
    again = service.submit(program, "table")
    print(f"resubmit : done={again.done()} status={again.result().status} "
          f"(service stats: {service.stats})")
    raw = plan.best.raw_ops
    print(f"raw mul/div/mod left in resolution arithmetic: {raw} "
          f"(DSP-free: {plan.best.dsp_free})")

    # The sharded search, progressively: a cold resubmit (use_cache=False)
    # fanned over 4 shards streams its best-so-far through the ticket --
    # a server would promote its layout on each improvement and still get
    # the identical final winner from result().
    live = service.submit(program, "table", use_cache=False, shard_budget=4)
    trajectory = []
    while not live.wait(0.0005):
        best = live.best_so_far()
        if best is not None and (not trajectory
                                 or best.score != trajectory[-1]):
            trajectory.append(best.score)
    final = live.result(timeout=60)
    print(f"sharded  : best-so-far scores {trajectory} -> "
          f"winner {final.best.score:.1f} "
          f"({service.stats.shards_spawned} shards, "
          f"{service.stats.best_promotions} promotions)")
    assert final.best.geometry == plan.best.geometry

    # The same space, enumerated by hand (what the service does inside):
    from repro_torch.core import CandidateSpace, build_groups, unroll
    up = unroll(program)
    space = CandidateSpace(mem, build_groups(up, "table"), up.iterators)
    shards = space.shards(4)
    print(f"space    : {len(space)} candidates in "
          f"{len(space.sections)} sections -> "
          f"shards of {[len(s) for s in shards]}")

    # MEASURE -> REFRESH -> DEMOTE: enable telemetry and the service
    # times the artifacts it hands out, persists the observations
    # through the plan store (telemetry/ sidecar under a DirectoryStore),
    # and self-corrects rankings the hardware contradicts.
    hub = service.enable_telemetry()
    measured_plan = service.submit(program, "table",
                                   scorer="measured").result(timeout=60)
    m_art = service.planner.compile(measured_plan, backend="numpy")
    packed = m_art.pack(flat.cpu()).numpy()
    for _ in range(4):
        m_art.gather(packed, idx.cpu().numpy())   # each call is measured
    print(f"telemetry: {service.stats.observations} timed calls in the "
          f"log ({len(hub.log)} distinct (scheme, op, shape) records)")
    # the hardware disagrees with the ranking: a rival scheme measures
    # 100x faster, and the served scheme keeps proving slow -> the
    # service demotes it and re-solves speculatively, exactly once
    hub.log.observe(measured_plan.signature, "rival-scheme", "numpy",
                    "gather", (8,), 1e-5)
    for _ in range(hub.config.min_observations):
        hub.observe(m_art, "gather", (8,), 1e-3)
    replacement = hub.replacement((measured_plan.signature, "measured"))
    print(f"demotion : {service.stats.demotions} demoted, re-solve "
          f"ticket={replacement.status if replacement else None} "
          f"(a Server polls hub.replacement() and hot-swaps mid-serve)")
    # with enough measured schemes, hub.refresh() refits the persisted
    # ml_scorer.json from (features, measured-us) pairs -- the paper's
    # ML cost model, now trained by your own hardware.

    # LINT -> SOLVE -> CERTIFY: nothing is taken on faith.  The lint
    # pass vets the Program before any solve queues; verify="store"
    # re-proves the solver's chosen scheme conflict-free through an
    # INDEPENDENT decision procedure (lattice + residue witnesses, not
    # the solver's sumset DP) and persists the machine-checkable
    # certificate beside the plan; verify="all" extends the same check
    # to every remote fabric result batch.
    import dataclasses

    from repro_torch.analysis import (certify_plan, certify_solution,
                                check_certificate, lint_program)
    report = lint_program(program, "table")
    print(f"lint     : ok={report.ok} "
          f"({len(report.diagnostics)} findings)")
    verified = service.submit(program, "table", use_cache=False,
                              verify="store").result(timeout=60)
    res = certify_plan(verified, up.iterators)
    ok, _why = check_certificate(res.certificate)
    print(f"certify  : {res.pairs_checked} access pairs re-decided in "
          f"{res.seconds*1e3:.1f} ms -> verdict={res.certificate.verdict} "
          f"(independent recheck: {ok})")
    # ...and a forged scheme is refuted with a concrete collision that
    # renders as a standalone pytest case (Counterexample.to_pytest):
    forged = dataclasses.replace(
        verified.best,
        geometry=dataclasses.replace(verified.best.geometry, N=1, B=1))
    refuted = certify_solution(forged, build_groups(up, "table"),
                               up.iterators)
    assert not refuted.ok and refuted.counterexample is not None
    print(f"refuted  : forged single-bank scheme -> "
          f"{refuted.counterexample.describe()}")

    # DISTRIBUTED: the identical search, but the shards run in OTHER
    # PROCESSES attached over a socket.  A SolveFabric leases work units
    # to remote workers, streams their scored solutions back into one
    # reducer, and broadcasts the reducer's cuts so remote shards prune
    # like local ones.  In production: `launch/serve.py --fabric` prints
    # the address, and `launch/solve_worker.py HOST:PORT` attaches one
    # worker per host -- here we spawn two locally.
    from repro_torch.core import SolveFabric, spawn_local_workers
    fabric = SolveFabric()
    workers = spawn_local_workers(fabric.address, 2)
    try:
        assert fabric.wait_for_workers(2, timeout=30)
        service.attach_fabric(fabric)
        dist = service.submit(program, "table", use_cache=False,
                              executor="fabric")
        # best-so-far promotions stream exactly as in-process...
        remote_plan = dist.result(timeout=120)
        # ...and the winner is the same scheme, solved on other processes
        assert remote_plan.best.geometry == plan.best.geometry
        print(f"fabric   : same winner from {service.stats.fabric_leases} "
              f"remote leases across 2 workers "
              f"({service.stats.fabric_cut_broadcasts} cut broadcasts)")
    finally:
        for w in workers:
            w.terminate()
        for w in workers:
            w.wait()
        fabric.shutdown()

    # MULTI-TENANT: one planning plane, many tenants.  QoS classes map
    # to priority bands + weighted fair share; quotas defer over-quota
    # cold solves (the ticket says so, and its fallback artifact still
    # serves NOW) or shed them with a loud AdmissionError; stats slice
    # per tenant and reconcile exactly with the global counters.
    from repro_torch.core import QoSClass, TenantRegistry
    tenants = TenantRegistry()
    tenants.register("web", "interactive")       # stock class: band 0
    tenants.register("nightly", QoSClass(        # custom: band 10, 1 slot
        "nightly", priority=10, max_inflight=1))
    shared = PlanService(workers=2, tenants=tenants)

    def unique(i):
        m = MemorySpec(f"t{i}", dims=(256 + 8 * i,), word_bits=32,
                       ports=1)
        return Program(
            root=Ctrl("reader", Sched.INNER,
                      counters=[Counter("i", 0, 1, 32, par=8)],
                      accesses=[AccessDecl(m.name, (Affine.of(i=1),))]),
            memories={m.name: m}), m.name

    flood = [shared.submit(*unique(i), tenant="nightly")
             for i in range(4)]                  # 1 admitted, 3 deferred
    vip = shared.submit(*unique(99), tenant="web")
    n_deferred = sum(t.deferred for t in flood)
    flood[-1].fallback(backend="numpy")          # deferred != denied
    vip.result(timeout=60)                       # band 0 lands first
    for t in flood:
        t.result(timeout=60)                     # ...but everyone lands
    g = shared.stats.as_dict()
    slices = g.pop("tenants")
    exact = all(v == sum(s.get(k, 0) for s in slices.values())
                for k, v in g.items())
    print(f"tenancy  : nightly deferred {n_deferred}/4 cold solves while "
          f"web's solved; per-tenant slices reconcile exactly: {exact}")
    shared.shutdown()

    # JOINT: one model, many banked memories, ONE fabric budget.  A
    # two-memory Program (a KV pool and an MoE dispatch table) goes
    # through submit_joint: each member keeps a Pareto frontier of
    # (cost, resources) schemes, and an exact co-selection picks one
    # scheme per memory minimizing total cost under the shared budget.
    from repro_torch.core import ResourceBudget
    kv = MemorySpec("kv", dims=(256,), word_bits=16, ports=1)
    disp = MemorySpec("disp", dims=(128,), word_bits=32, ports=1)
    joint_prog = Program(
        root=Ctrl("model", Sched.FORKJOIN, children=[
            Ctrl("attn", Sched.INNER,
                 counters=[Counter("r", 0, 1, 32, par=8)],
                 accesses=[AccessDecl("kv", (Affine.of(r=1),))]),
            Ctrl("route", Sched.INNER,
                 counters=[Counter("e", 0, 1, 32, par=4)],
                 accesses=[AccessDecl("disp", (Affine.of(e=1),))]),
        ]),
        memories={"kv": kv, "disp": disp},
    )
    jsvc = PlanService(workers=2)
    # slack budget: the joint answer IS the independent answer
    slack = jsvc.submit_joint(joint_prog).result(timeout=120)
    free_use = slack.total_use
    print(f"joint    : slack budget -> "
          f"{[m.chosen.num_banks for m in slack.members.values()]} banks "
          f"per memory, total {free_use.as_dict()}")
    # tight budget: independent planning would NOT fit -- joint
    # co-selection trades the cheapest memory down so the model does
    tight = ResourceBudget(bram=max(2, int(free_use.bram * 0.6)))
    squeezed = jsvc.submit_joint(joint_prog, budget=tight,
                                 use_cache=False).result(timeout=120)
    assert squeezed.fits() and squeezed.feasible
    assert not tight.admits(free_use)          # independent would blow it
    print(f"joint    : bram {free_use.bram} -> cap {tight.bram}: "
          f"co-selected {squeezed.total_use.bram} "
          f"(fits={squeezed.fits()}, independent would not)")
    jsvc.shutdown()

    # OBSERVE: every submit gets a trace_id once tracing is enabled --
    # hierarchical spans cover prepare -> queue-wait -> shard-eval ->
    # reduce (and, on a fabric, the REMOTE workers' lease/eval spans
    # stitch into the same trace over the wire).  The flight recorder
    # keeps the last N completed ticket traces and dumps Chrome
    # trace_event JSON for chrome://tracing / Perfetto; the metrics
    # registry mirrors every ServiceStats counter as
    # plan_<counter>{tenant=...} plus queue/latency histograms, served
    # as Prometheus text from a stdlib HTTP thread.
    import json as json_mod
    import tempfile
    import urllib.request

    from repro_torch.core import start_observability_server
    osvc = PlanService(workers=2)
    osvc.enable_tracing(slo_ms=5_000.0)
    om = MemorySpec("obs", dims=(384,), word_bits=32, ports=1)
    oprog = Program(
        root=Ctrl("reader", Sched.INNER,
                  counters=[Counter("i", 0, 1, 32, par=8)],
                  accesses=[AccessDecl("obs", (Affine.of(i=1),))]),
        memories={"obs": om})
    oticket = osvc.submit(oprog, "obs", use_cache=False)
    oticket.result(timeout=120)
    trace = osvc.recorder.traces()[-1]
    stages = {s.name: round(s.duration_ms, 2) for s in trace.spans}
    with tempfile.TemporaryDirectory() as tmp:
        path = osvc.recorder.dump(f"{tmp}/trace.json")
        n_events = len(json_mod.load(open(path))["traceEvents"])
    http = start_observability_server(osvc.metrics, osvc.recorder,
                                      tracer=osvc.tracer, port=0)
    host, port = http.server_address[:2]
    prom = urllib.request.urlopen(
        f"http://{host}:{port}/metrics", timeout=10).read().decode()
    print(f"observe  : ticket {oticket.trace_id} spanned {stages}; "
          f"Chrome dump had {n_events} events; /metrics served "
          f"{len(prom.splitlines())} series (queue_ms="
          f"{oticket.as_dict()['queue_ms']:.2f})")
    http.shutdown()
    osvc.shutdown()


if __name__ == "__main__":
    main()
