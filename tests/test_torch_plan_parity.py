"""The plan plane of the port against the reference's, across the package
boundary: the same banking problem must hash to the same signatures, solve
to the same plan JSON and certificate, and land in one ``DirectoryStore``
directory that either package hydrates with no solver work; a reference
``ml_scorer.json`` must score alike in the port; and the two decode servers,
built on plan tickets and held by the same gate on the first cold solve,
must serve the same tokens, hot-swap alike and end on the same layout and
record table -- for a plain ticket and for a joint ticket over the MoE
family's two pools."""

import dataclasses
import json
import threading

import jax
import numpy as np
import pytest

import repro.core as ref_core
import repro_torch.analysis as port_analysis
import repro_torch.core as port_core
from repro.configs import ARCH_IDS
from repro.configs import get_arch as ref_get_arch
from repro.core import problems as ref_problems
from repro.models import get_model as ref_get_model
from repro.runtime import server as RS
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import problems as port_problems
from repro_torch.models import get_model
from repro_torch.runtime import server as PS

from test_torch_server import (MARGIN, MAX_BATCH, MAX_LEN, N_REQUESTS,
                               MAX_NEW, PAGE, READERS, SEEDS, _prompts)
from torch_parity import assert_same

PACKAGES = {"reference": (ref_core, RS), "port": (port_core, PS)}
# fields that record when or how long, not what: masked before comparing
TIMING = ("created_at", "solve_seconds")


def _canon(obj):
    if isinstance(obj, dict):
        return {k: (0 if k in TIMING else _canon(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_canon(v) for v in obj]
    return obj


def _layout(art):
    """A layout as plain values: each package has its own ``BankingLayout``
    class, so two equal layouts of the two packages never compare equal."""
    return dataclasses.astuple(art.layout)


def _dump(obj) -> str:
    return json.dumps(_canon(obj), indent=1, sort_keys=True)


def _counting(monkeypatch, core):
    """Count cold solves of one package at its chokepoint."""
    calls = []
    real = core.BankingPlanner.build_space

    def counting(self, prep):
        calls.append(prep.mem.name)
        return real(self, prep)

    monkeypatch.setattr(core.BankingPlanner, "build_space", counting)
    return calls


def _gated(monkeypatch, core):
    """Hold every cold solve of one package until the gate opens."""
    gate = threading.Event()
    real = core.BankingPlanner.build_space

    def gated(self, prep):
        gate.wait(30)
        return real(self, prep)

    monkeypatch.setattr(core.BankingPlanner, "build_space", gated)
    return gate


# ---------------------------------------------------------------------------
# Signatures
# ---------------------------------------------------------------------------


def _problem_programs(problems):
    progs = [(n, problems.build(n)) for n in problems.STENCILS + problems.APPS]
    progs.append(("md_grid", problems.md_grid_program()))
    return progs


def _signatures(core, server, problems):
    out = {}
    opts = core.SolverOptions(b_candidates=(16, 1), allow_multidim=False)
    kv = server._page_program(64, 16, 4)
    out["kv_pool"] = (core.program_signature(kv, "kv_pool"),
                      core.program_signature(kv, "kv_pool", opts))
    for arch in ARCH_IDS:
        cfg = (ref_get_arch if core is ref_core else get_arch)(arch)
        prog = server.model_memory_program(cfg, 64, page=16, readers=4)
        for mem in prog.memories:
            up = core.unroll(prog)
            groups = core.build_groups(up, mem)
            out[arch, mem] = (
                core.canonical_signature(prog.memories[mem], groups,
                                         up.iterators, opts),
                core.family_signature(prog.memories[mem], groups,
                                      up.iterators))
    for name, prog in _problem_programs(problems):
        for mem in prog.memories:
            out[name, mem] = core.program_signature(prog, mem)
    return out


def test_signatures_are_byte_identical():
    ref = _signatures(ref_core, RS, ref_problems)
    port = _signatures(port_core, PS, port_problems)
    assert len(ref) > 20 and ref == port
    jr = ref_core.joint_signature({"a": "x", "b": "y"}, "proxy",
                                  ref_core.ResourceBudget(bram=4))
    jp = port_core.joint_signature({"a": "x", "b": "y"}, "proxy",
                                   port_core.ResourceBudget(bram=4))
    assert jr == jp


# ---------------------------------------------------------------------------
# Plans, certificates, artifacts, joint plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("app", ["denoise", "sobel", "sgd", "kv_pool"])
def test_plan_json_and_certificate_are_byte_identical(app, tmp_path):
    """Each package plans and certifies the same request into a store of
    its own; the files agree byte for byte once the timing fields are
    masked, and each package re-serialises the other's plan unchanged."""
    files = {}
    for name, (core, server) in PACKAGES.items():
        prog = (server._page_program(64, 16, 4) if app == "kv_pool"
                else (ref_problems if core is ref_core
                      else port_problems).build(app))
        mem = "kv_pool" if app == "kv_pool" else list(prog.memories)[0]
        store = core.DirectoryStore(tmp_path / name)
        svc = core.PlanService(store=store, workers=1, verify="store")
        plan = svc.submit(prog, mem).result(timeout=60)
        svc.shutdown()
        files[name] = (
            json.loads(store.plan_path(plan.signature, "proxy").read_text()),
            json.loads(store.certificate_path(plan.signature,
                                              "proxy").read_text()))
    (rp, rc), (pp, pc) = files["reference"], files["port"]
    assert _dump(rp) == _dump(pp)
    assert _dump(rc) == _dump(pc) and rc["verdict"] == "certified"
    # a plan read by one package is written back by the other unchanged
    assert json.dumps(port_core.BankingPlan.from_json(rp).to_json(),
                      sort_keys=True) == json.dumps(rp, sort_keys=True)
    assert json.dumps(ref_core.BankingPlan.from_json(pp).to_json(),
                      sort_keys=True) == json.dumps(pp, sort_keys=True)
    ok, why = port_analysis.check_certificate(rc)
    assert ok, why


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_shared_store_hydrates_across_packages(writer, tmp_path,
                                                 monkeypatch):
    """One package solves, certifies and jointly plans into a directory;
    the other, on a fresh service over the same directory, answers every
    ticket at submit with zero solver calls -- certificates re-verified on
    hydrate -- and compiles the artifacts on its own backend."""
    reader = "port" if writer == "reference" else "reference"
    (wcore, wsrv), (rcore, rsrv) = PACKAGES[writer], PACKAGES[reader]
    cfg_of = {"reference": ref_get_arch, "port": get_arch}

    store_w = wcore.DirectoryStore(tmp_path)
    svc_w = wcore.PlanService(store=store_w, workers=1, verify="store")
    t_w = wsrv.page_ticket(None, 64, page=16, readers=4, service=svc_w)
    art_w = t_w.artifact(timeout=60)
    jt_w = wsrv.joint_ticket(cfg_of[writer]("olmoe_1b_7b").reduced(), 64,
                             page=16, readers=4, service=svc_w)
    jp_w = jt_w.result(timeout=60)
    svc_w.shutdown()
    backend_w = "jax" if writer == "reference" else "torch"
    backend_r = "torch" if writer == "reference" else "jax"
    sig = t_w.signature
    assert store_w.artifact_path(sig, "proxy", backend_w).exists()
    assert store_w.certificate_path(sig, "proxy").exists()
    assert store_w.joint_path(jp_w.signature).exists()

    calls = _counting(monkeypatch, rcore)
    svc_r = rcore.PlanService(store=rcore.DirectoryStore(tmp_path),
                              workers=1, verify="store")
    t_r = rsrv.page_ticket(None, 64, page=16, readers=4, service=svc_r)
    assert t_r.done() and t_r.signature == sig
    art_r = t_r.artifact()
    jt_r = rsrv.joint_ticket(cfg_of[reader]("olmoe_1b_7b").reduced(), 64,
                             page=16, readers=4, service=svc_r)
    assert jt_r.done()
    jp_r = jt_r.result()
    svc_r.shutdown()
    assert calls == [] and svc_r.stats.sync_hits >= 1
    assert art_r.backend == backend_r and _layout(art_r) == _layout(art_w)
    assert rcore.DirectoryStore(tmp_path).artifact_path(
        sig, "proxy", backend_r).exists()
    a, b = art_w.to_json(), art_r.to_json()
    assert {k for k in a if a[k] != b[k]} == {"backend"}
    jw, jr = jp_w.to_json(), jp_r.to_json()
    assert (jw.pop("status"), jr.pop("status")) == ("solved", "cached-disk")
    assert _dump(jw) == _dump(jr)
    arts_w, arts_r = jt_w.artifacts(backend_w), jt_r.artifacts(backend_r)
    assert set(arts_r) == set(arts_w) == {"kv_pool", "moe_dispatch"}
    for name, art in arts_r.items():
        assert art.backend == backend_r
        assert _layout(art) == _layout(arts_w[name])


# ---------------------------------------------------------------------------
# The ml scorer file
# ---------------------------------------------------------------------------


def test_a_reference_ml_scorer_file_scores_alike_in_the_port(tmp_path,
                                                             monkeypatch):
    from repro.core import cost_model as ref_cm
    from repro.core import dataset as ref_ds
    from repro.core import features as ref_feat
    from repro_torch.core import cost_model as port_cm
    from repro_torch.core import dataset as port_ds
    from repro_torch.core import features as port_feat
    from repro_torch.core import planner as port_planner

    opts = {name: core.SolverOptions(max_solutions=8, n_budget=8)
            for name, (core, _) in PACKAGES.items()}
    sols = {"reference": [], "port": []}
    progs = {"reference": ref_ds.corpus_programs(0)[:3],
             "port": port_ds.corpus_programs(0)[:3]}
    for name, (core, _) in PACKAGES.items():
        for _, prog in progs[name]:
            up = core.unroll(prog)
            for mem in prog.memories:
                groups = core.build_groups(up, mem)
                sols[name] += [(s, groups) for s in core.solve(
                    prog.memories[mem], groups, up.iterators, opts[name])]
    assert len(sols["reference"]) == len(sols["port"]) > 10
    X = np.asarray([ref_feat.extract_features(s, g)
                    for s, g in sols["reference"]])
    np.testing.assert_array_equal(X, np.asarray(
        [port_feat.extract_features(s, g) for s, g in sols["port"]]))
    labels = [ref_ds.synthetic_pnr(s) for s, _ in sols["reference"]]
    assert labels == [port_ds.synthetic_pnr(s) for s, _ in sols["port"]]
    pipes = {k: ref_cm.ResourcePipeline(gbt_params=dict(n_estimators=8))
             .fit(X, np.asarray([lab[k] for lab in labels]))
             for k in ("lut", "ff", "bram")}
    path = tmp_path / "ml_scorer.json"
    path.write_text(json.dumps(ref_cm.MLScorer(pipes).to_json()))

    ref_scorer = ref_cm.MLScorer.from_json(json.loads(path.read_text()))
    port_scorer = port_cm.MLScorer.from_json(json.loads(path.read_text()))
    assert [ref_scorer(s) for s, _ in sols["reference"]] == \
        [port_scorer(s) for s, _ in sols["port"]]
    # and the port's "ml" registry entry resolves to that file
    factory = port_planner._ml_scorer_factory
    monkeypatch.setattr(port_planner, "_ML_SCORER_PATH", path)
    for k in ("_cached", "_cached_mtime"):
        monkeypatch.delitem(factory.__dict__, k, raising=False)
    _, resolved = port_core.resolve_scorer("ml")
    assert [resolved(s) for s, _ in sols["port"]] == \
        [ref_scorer(s) for s, _ in sols["reference"]]


# ---------------------------------------------------------------------------
# Servers on tickets, under the same gate
# ---------------------------------------------------------------------------

RELEASE_AFTER = 3     # ticks served from the fallback before the solve lands


def _watch_margins(srv, margins):
    """Top-2 logit margin of every row whose argmax the reference server
    reads: in a tick the active slots; inside ``_admit`` the slot being
    prefilled, of which only the last call counts (later calls overwrite
    the entry)."""
    decode, admit, admitting = srv._decode, srv._admit, []

    def watched(params, cache, tokens):
        nxt, logits, cache = decode(params, cache, tokens)
        if admitting:
            slot = min(s for s in range(MAX_BATCH) if s not in srv.active)
            key, read = ("admit", admitting[0], slot), [slot]
        else:
            key, read = ("tick", len(margins)), sorted(srv.active)
        top = np.sort(np.asarray(logits, np.float32)[read], axis=-1)
        margins[key] = float(((top[:, -1] - top[:, -2])
                              / np.abs(top).max()).min())
        return nxt, logits, cache

    def watched_admit():
        admitting.append(srv.ticks)
        try:
            admit()
        finally:
            admitting.pop()

    srv._decode, srv._admit = watched, watched_admit


def _serve_on_ticket(name, arch, joint, monkeypatch, params=None):
    core, server = PACKAGES[name]
    cfg = (ref_get_arch if name == "reference" else get_arch)(arch).reduced()
    gate = _gated(monkeypatch, core)
    svc = core.PlanService(workers=1)
    try:
        if joint:
            ticket = server.joint_ticket(cfg, MAX_LEN, page=PAGE,
                                         readers=READERS, service=svc)
        else:
            ticket = server.page_ticket(cfg, MAX_LEN, page=PAGE,
                                        readers=READERS, service=svc)
        assert not ticket.done()
        if name == "reference":
            srv = RS.Server(ref_get_model(cfg), max_batch=MAX_BATCH,
                            max_len=MAX_LEN, kv_plan=ticket)
        else:
            srv = PS.Server(get_model(cfg), max_batch=MAX_BATCH,
                            max_len=MAX_LEN, kv_plan=ticket, device="cpu",
                            params=params)
        margins = {}
        if name == "reference":
            _watch_margins(srv, margins)
        assert srv.pager.pages_per_slot == 1          # the fallback
        reqs = [server.Request(uid=i, prompt=p, max_new=MAX_NEW)
                for i, p in enumerate(_prompts(SEEDS[arch], N_REQUESTS,
                                               cfg.vocab))]
        for r in reqs:
            srv.submit(r)
        on_fallback, coherent = 0, []
        while srv.queue or srv.active:
            if srv.ticks == RELEASE_AFTER and not gate.is_set():
                gate.set()
                assert ticket.wait(30)
            coherent.append(srv.coherent)
            srv.tick()
            if srv.pager.pages_per_slot == 1:   # this tick ran on it
                on_fallback += 1
        records = np.asarray(srv._kv_art.unpack(srv.kv_records))
        return srv, reqs, records, on_fallback, coherent, margins
    finally:
        gate.set()
        svc.shutdown()


@pytest.mark.parametrize("arch,joint", [("qwen2_7b", False),
                                        ("mamba2_370m", False),
                                        ("olmoe_1b_7b", True)],
                         ids=["qwen2 ticket", "mamba2 ticket",
                              "olmoe joint ticket"])
def test_servers_on_a_ticket_match_under_the_same_gate(arch, joint,
                                                       monkeypatch):
    ref = _serve_on_ticket("reference", arch, joint, monkeypatch)
    ref_srv, ref_reqs, ref_records, ref_fb, ref_coh, margins = ref
    margin = min(margins.values())
    assert margin > MARGIN, f"reference top-2 margin {margin}: pick a seed"
    params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_srv._params), device="cpu")
    srv, reqs, records, on_fb, coh, _ = _serve_on_ticket(
        "port", arch, joint, monkeypatch, params=params)
    assert all(r.done and len(r.out) == MAX_NEW for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert on_fb == ref_fb == RELEASE_AFTER
    assert (srv.swaps, srv.promotions, srv.joint_swaps,
            srv.joint_promotions) == (ref_srv.swaps, ref_srv.promotions,
                                      ref_srv.joint_swaps,
                                      ref_srv.joint_promotions)
    if joint:
        assert srv.joint_swaps + srv.joint_promotions >= 1
        assert all(coh) and all(ref_coh) and srv.coherent
        assert srv.generations == ref_srv.generations
        assert set(srv.pools) == set(ref_srv.pools) == {"moe_dispatch"}
        for name, pool in srv.pools.items():
            assert _layout(pool.artifact) == \
                _layout(ref_srv.pools[name].artifact)
    else:
        assert srv.swaps == 1 and srv.promotions == 0
    assert _layout(srv._kv_art) == _layout(ref_srv._kv_art)
    assert srv._kv_art.n_banks > 1
    np.testing.assert_array_equal(records, ref_records)
    assert_same(ref_srv.kv_records, srv.kv_records)    # bank-major, too


def test_server_accepts_tickets_and_refuses_the_rest():
    cfg = dataclasses.replace(get_arch("qwen2_7b").reduced(), n_layers=1)
    svc = port_core.PlanService(workers=1)
    ticket = PS.page_ticket(cfg, MAX_LEN, page=PAGE, readers=READERS,
                            service=svc)
    srv = PS.Server(get_model(cfg), max_batch=MAX_BATCH, max_len=MAX_LEN,
                    kv_plan=ticket, device="cpu")
    assert srv._kv_service is svc
    assert srv._kv_key == (ticket.signature, ticket.scorer_name)
    ref_ticket = ref_core.PlanService(workers=1).submit(
        RS._page_program(MAX_LEN, PAGE, READERS), "kv_pool")
    with pytest.raises(TypeError, match="PlanTicket"):
        PS.Server(get_model(cfg), max_batch=MAX_BATCH, max_len=MAX_LEN,
                  kv_plan=ref_ticket, device="cpu")
    svc.shutdown()


# ---------------------------------------------------------------------------
# The solve fabric: the same plan over the wire, the same framing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("app", ["sobel", "kv_pool"])
def test_fabric_solve_gives_the_reference_planners_plan(app, tmp_path):
    """A port service solving on its fabric, two port workers attached,
    stores the plan the reference's planner stores for the same request:
    the same signature and, timing fields masked, the same file."""
    files = {}
    for name, (core, server) in PACKAGES.items():
        prog = (server._page_program(64, 16, 4) if app == "kv_pool"
                else (ref_problems if core is ref_core
                      else port_problems).build(app))
        mem = "kv_pool" if app == "kv_pool" else list(prog.memories)[0]
        store = core.DirectoryStore(tmp_path / name)
        fabric, procs = None, []
        if name == "port":
            fabric = core.SolveFabric(chunk=16)
            procs = core.spawn_local_workers(fabric.address, 2)
        try:
            if fabric is not None:
                assert fabric.wait_for_workers(2, timeout=60)
            svc = core.PlanService(
                store=store, workers=1, fabric=fabric,
                executor="pool" if fabric is None else "fabric")
            plan = svc.submit(prog, mem).result(timeout=120)
            svc.shutdown()
            if fabric is not None:
                assert svc.stats.fabric_solves == 1
                assert svc.stats.fabric_fallbacks == 0
                assert svc.stats.fabric_leases > 0
                assert fabric.stats.evaluated > 0   # the work went remote
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.wait(timeout=10)
            if fabric is not None:
                fabric.shutdown()
        files[name] = (plan.signature, store.plan_path(
            plan.signature, "proxy").read_text())
    (rsig, rfile), (psig, pfile) = files["reference"], files["port"]
    assert rsig == psig
    assert _dump(json.loads(rfile)) == _dump(json.loads(pfile))


FRAMES = [
    {"t": "join", "pid": 4242, "host": "node-7"},
    {"t": "lease", "solve_id": 3, "lease_id": 17, "indices": [4, 5, 6, 7],
     "cuts": {0: 12, 2: 3}, "trace": "0123456789abcdef"},
    {"t": "done", "lease_id": 17, "evaluated": 4,
     "spans": [{"name": "w-eval", "start": 0.0, "end": 0.25,
                "attrs": {"evaluated": 4}}]},
    {"t": "hb"},
    {"t": "results", "lease_id": 1, "payload": bytes(range(256)) * 3},
]


@pytest.mark.parametrize("frame", FRAMES, ids=[f["t"] for f in FRAMES])
def test_write_frame_bytes_are_the_references(frame):
    """The framing is the reference's: a plain dict is written as the same
    bytes by both packages (4-byte big-endian length, then the pickle), and
    each package reads what the other wrote."""
    import socket

    from repro.core import fabric as ref_fabric
    from repro_torch.core import fabric as port_fabric

    assert port_fabric._MAX_FRAME == ref_fabric._MAX_FRAME
    wire = {}
    for name, mod in (("reference", ref_fabric), ("port", port_fabric)):
        a, b = socket.socketpair()
        try:
            mod.write_frame(a, frame, threading.Lock())
            a.shutdown(socket.SHUT_WR)
            chunks = []
            while chunk := b.recv(1 << 16):
                chunks.append(chunk)
            wire[name] = b"".join(chunks)
        finally:
            a.close()
            b.close()
    assert wire["reference"] == wire["port"]
    n = int.from_bytes(wire["port"][:4], "big")
    assert n == len(wire["port"]) - 4
    for writer, reader in ((ref_fabric, port_fabric),
                           (port_fabric, ref_fabric)):
        a, b = socket.socketpair()
        try:
            writer.write_frame(a, frame)
            assert reader.read_frame(b) == frame
        finally:
            a.close()
            b.close()
