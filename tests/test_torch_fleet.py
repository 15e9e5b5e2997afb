"""The port's fleet launcher (``launch/serve_fleet.py``): three reduced
servers -- a dense transformer, an MoE and an SSM -- on threads over one
``PlanService``, as the JAX package's launcher runs them, here on the CPU.
The per-tenant stats slices sum exactly to the global counters; with a
solve fabric and a spawned port worker the cold solves run remotely; each
tenant's tokens equal those of the same server run alone on the pool."""

import pytest
import torch

from repro_torch.core import PlanService, SolveFabric, spawn_local_workers
from repro_torch.launch import serve_fleet
from repro_torch.runtime.tenancy import TenantRegistry

SMOKE = ["--smoke", "--device", "cpu", "--noise", "2"]


def _reconciled(out):
    stats, slices = out["stats"], out["slices"]
    assert set(slices) == {n for n, _, _ in serve_fleet.DEFAULT_FLEET}
    for key, total in stats.items():
        assert total == sum(s.get(key, 0) for s in slices.values()), key


def _served(out, max_new=4):
    for name, _, arch in serve_fleet.DEFAULT_FLEET:
        res = out["results"][name]
        assert res["arch"] == arch and res["ticket_status"] == "done"
        assert res["ticks"] > 0
        reqs = out["requests"][name]
        assert len(reqs) == 4
        assert all(r.done and len(r.out) == max_new for r in reqs)
    assert all(t.done() for t in out["noise"])


def test_fleet_on_the_cpu_reconciles_its_slices_exactly(capsys):
    out = serve_fleet.main(SMOKE)
    assert "slice reconciliation: exact" in capsys.readouterr().out
    _reconciled(out)
    _served(out)
    assert out["stats"]["submits"] == 3 + 2          # servers + noise
    assert out["slices"]["batch"]["submits"] == 1 + 2
    assert out["stats"].get("fabric_solves", 0) == 0


def test_fleet_solves_on_a_fabric_with_one_spawned_worker(capsys):
    fabric = SolveFabric(chunk=16)
    procs = spawn_local_workers(fabric.address, 1)
    try:
        assert fabric.wait_for_workers(1, timeout=60)
        out = serve_fleet.main(SMOKE + ["--fabric"], fabric=fabric)
        assert fabric.workers_alive == 1     # a handed-in fabric stays open
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.wait(timeout=10)
        fabric.shutdown()
    assert "slice reconciliation: exact" in capsys.readouterr().out
    _reconciled(out)
    _served(out)
    stats = out["stats"]
    assert stats["fabric_solves"] >= 1 and stats["fabric_leases"] > 0
    assert stats.get("fabric_fallbacks", 0) == 0
    assert fabric.stats.evaluated > 0


def test_each_tenants_tokens_equal_its_server_run_alone():
    out = serve_fleet.main(SMOKE)
    for offset, (name, qos, arch) in enumerate(serve_fleet.DEFAULT_FLEET):
        registry = TenantRegistry()
        registry.register(name, qos)
        svc = PlanService(workers=2, tenants=registry)
        try:
            _, _, reqs = serve_fleet.run_tenant(svc, name, arch, offset,
                                                smoke=True, device="cpu")
        finally:
            svc.shutdown()
        assert [list(r.out) for r in reqs] == \
            [list(r.out) for r in out["requests"][name]], name


def test_fleet_raises_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the default works here")
    with pytest.raises(SystemExit, match="no CUDA device"):
        serve_fleet.main(["--smoke", "--noise", "0", "--requests", "1",
                          "--max-new", "1"])
