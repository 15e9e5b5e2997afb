"""The decode server of the port against the reference's: same config, same
weights, same prompts through both ``Server``s must give the same tokens
and the same logical token records -- on a solved plan, and again across a
hot swap from the trivial layout -- for the dense family (qwen2-7b), the
MoE family (olmoe-1b-7b), the SSM family (mamba2-370m) and the hybrid family
(zamba2-2.7b), each at its reduced size.  The server prefills through
decode, and a slot's SSM state is not reset when a new request takes the
slot over, in both packages alike."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from repro.configs import get_arch as ref_get_arch
from repro.models import get_model as ref_get_model
from repro.runtime import server as RS
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import banked_gather as bg
from repro_torch.models import get_model
from repro_torch.runtime import server as PS

from torch_parity import assert_same

MAX_BATCH, MAX_LEN, PAGE, READERS = 2, 32, 8, 2
N_REQUESTS, MAX_NEW = 3, 4      # two slots: the third request waits its turn
# Tokens can only be compared where no two logits tie within bfloat16
# rounding, so every decode call of the reference must show a top-2 margin
# above this share of its largest logit; the prompt seeds below were picked
# so that it does (the test fails on the margin first if that ever changes).
MARGIN = 2.0 ** -7
SEEDS = {"qwen2_7b": 9, "olmoe_1b_7b": 2, "mamba2_370m": 1, "zamba2_2_7b": 10}


def _prompts(seed, n, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab - 1, size=int(rng.integers(3, 6))
                         ).astype(np.int32) for _ in range(n)]


def _kv_mem(core):
    return core.MemorySpec("kv_pool", dims=(MAX_LEN,), word_bits=16, ports=1)


def _run_reference(arch, start_trivial, swap_after):
    cfg = ref_get_arch(arch).reduced()
    solved = RS.page_solution(cfg, MAX_LEN, page=PAGE, readers=READERS)
    first = (ref_core.compile_trivial(_kv_mem(ref_core)) if start_trivial
             else solved)
    srv = RS.Server(ref_get_model(cfg), max_batch=MAX_BATCH, max_len=MAX_LEN,
                    kv_plan=first)
    decode, admit, margins, admitting = srv._decode, srv._admit, {}, []

    def watched(params, cache, tokens):
        """Top-2 margin of every logit row whose argmax the server reads:
        in a tick the active slots; inside ``_admit`` the slot being
        prefilled (the first free one), of which only the last call counts
        (later calls overwrite the entry)."""
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
    reqs = [RS.Request(uid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(_prompts(SEEDS[arch], N_REQUESTS,
                                           cfg.vocab))]
    for r in reqs:
        srv.submit(r)
    unpacked = []
    while srv.queue or srv.active:
        if start_trivial and srv.ticks == swap_after and not srv.swaps:
            srv._swap_to(solved)
            srv.swaps += 1
            unpacked.append(np.asarray(srv._kv_art.unpack(srv.kv_records)))
        srv.tick()
    records = np.asarray(srv._kv_art.unpack(srv.kv_records))
    return srv, reqs, records, unpacked, min(margins.values())


def _run_port(arch, ref_srv, start_trivial, swap_after):
    cfg = get_arch(arch).reduced()
    params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_srv._params), device="cpu")
    solved = PS.page_solution(cfg, MAX_LEN, page=PAGE, readers=READERS)
    first = (port_core.compile_trivial(_kv_mem(port_core)) if start_trivial
             else solved)
    srv = PS.Server(get_model(cfg), max_batch=MAX_BATCH, max_len=MAX_LEN,
                    kv_plan=first, device="cpu", params=params)
    reqs = [PS.Request(uid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(_prompts(SEEDS[arch], N_REQUESTS,
                                           cfg.vocab))]
    for r in reqs:
        srv.submit(r)
    unpacked = []
    while srv.queue or srv.active:
        if start_trivial and srv.ticks == swap_after and not srv.swaps:
            before = srv._kv_art.unpack(srv.kv_records).clone()
            srv._swap_to(solved)
            srv.swaps += 1
            after = srv._kv_art.unpack(srv.kv_records)
            assert torch.equal(before, after)   # logical rows survive
            unpacked.append(after.numpy().copy())
        srv.tick()
    records = srv._kv_art.unpack(srv.kv_records).numpy()
    return srv, reqs, records, unpacked


@pytest.mark.parametrize("arch,start_trivial", [
    ("qwen2_7b", False), ("qwen2_7b", True),
    ("olmoe_1b_7b", False), ("olmoe_1b_7b", True),
    ("mamba2_370m", False), ("mamba2_370m", True), ("zamba2_2_7b", True)],
    ids=["solved plan", "swap from trivial", "olmoe solved plan",
         "olmoe swap from trivial", "mamba2 solved plan",
         "mamba2 swap from trivial", "zamba2 swap from trivial"])
def test_server_end_to_end_matches_reference(arch, start_trivial):
    ref_srv, ref_reqs, ref_records, ref_mid, margin = _run_reference(
        arch, start_trivial, swap_after=2)
    assert margin > MARGIN, f"reference top-2 margin {margin}: pick a seed"
    srv, reqs, records, mid = _run_port(arch, ref_srv, start_trivial,
                                        swap_after=2)
    assert all(r.done and len(r.out) == MAX_NEW for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert srv.ticks == ref_srv.ticks
    assert srv.cache.pos == int(ref_srv.cache.pos)
    np.testing.assert_array_equal(records, ref_records)
    assert srv.swaps == ref_srv.swaps == int(start_trivial)
    for a, b in zip(mid, ref_mid):
        np.testing.assert_array_equal(a, b)
    assert len(mid) == len(ref_mid) == int(start_trivial)
    assert srv.pager.artifact.layout.n_banks == \
        ref_srv.pager.artifact.layout.n_banks
    assert_same(ref_srv.kv_records, srv.kv_records)    # bank-major, too


# ---------------------------------------------------------------------------
# The pieces around the loop
# ---------------------------------------------------------------------------


def _tiny_server(kv_plan="solved", **kw):
    cfg = get_arch("qwen2_7b").reduced()
    if kv_plan == "solved":
        kv_plan = PS.page_solution(cfg, MAX_LEN, page=PAGE, readers=READERS)
    return PS.Server(get_model(cfg), max_batch=MAX_BATCH, max_len=MAX_LEN,
                     kv_plan=kv_plan, device="cpu", **kw)


def test_kv_page_pool_reads_layout_off_artifact():
    art = PS.page_solution(None, max_len=64, page=16, readers=4)
    ref = RS.page_solution(None, max_len=64, page=16, readers=4)
    pool = PS.KVPagePool(art, slots=4)
    assert pool.page_size == art.layout.bank_volume == ref.layout.bank_volume
    assert pool.pages_per_slot == art.layout.n_banks == ref.layout.n_banks
    assert pool.page_size * pool.pages_per_slot >= 64
    assert pool.total_pages == 4 * art.layout.n_banks
    assert pool.try_alloc(0, 17)
    assert pool.used_pages == pool.pages_for(17)
    assert not pool.try_alloc(0, 17)       # slot already owned
    assert not pool.fits(pool.pages_per_slot * pool.page_size + 1)
    assert not pool.try_alloc(1, pool.pages_per_slot * pool.page_size + 1)
    pool.swap(port_core.compile_trivial(
        port_core.MemorySpec("kv_pool", dims=(64,), word_bits=16, ports=1)))
    assert pool.pages_per_slot == 1 and pool.owned == {0: 1}
    pool.release(0)
    assert pool.used_pages == 0


@pytest.mark.parametrize("plan", ["a ticket", "a solution", "a layout name"])
def test_server_refuses_a_kv_plan_it_cannot_run(plan):
    bad = {"a ticket": object(), "a layout name": "trivial",
           "a solution": PS.page_solution(None, 64, 16, 4).geometry}[plan]
    with pytest.raises(TypeError, match="CompiledBankingPlan"):
        _tiny_server(kv_plan=bad)


def test_server_without_records_and_oversized_request():
    srv = _tiny_server(kv_plan=None)
    assert srv.pager is None and srv.kv_records is None
    srv.submit(PS.Request(uid=0, prompt=np.asarray([3, 4], np.int32),
                          max_new=2))
    srv.run()
    assert srv.ticks == 2 and bg.LAUNCHES["banked_gather"] == 0
    paged = _tiny_server()
    big = PS.Request(uid=1, prompt=np.arange(2, 40).astype(np.int32),
                     max_new=8)
    paged.submit(big)                      # 46 tokens never fit 32
    paged.run()
    assert big.done and big.out == [] and paged.ticks == 0


def test_server_seed_and_generator_decide_the_weights():
    a = _tiny_server(seed=3)
    b = _tiny_server(generator=torch.Generator(device="cpu").manual_seed(3))
    c = _tiny_server(seed=4)
    assert torch.equal(a._params["embed"], b._params["embed"])
    assert not torch.equal(a._params["embed"], c._params["embed"])
    assert a.kv_records.dtype == torch.int32
    assert tuple(a.kv_records.shape) == a._kv_art.layout.table_shape(MAX_BATCH)


def test_records_hold_prompts_and_outputs_position_by_position():
    srv = _tiny_server(seed=1)
    reqs = [PS.Request(uid=i, prompt=p, max_new=4)
            for i, p in enumerate(_prompts(7, 2, srv.cfg.vocab))]
    for r in reqs:
        srv.submit(r)
    srv.run()
    flat = srv._kv_art.unpack(srv.kv_records).numpy()
    for slot, r in enumerate(reqs):
        S = len(r.prompt)
        np.testing.assert_array_equal(flat[:S, slot], r.prompt)
        np.testing.assert_array_equal(flat[S + 1:S + 5, slot], r.out)
        assert (flat[S + 5:, slot] == 0).all()


def gate_first_solve(monkeypatch):
    """Hold the port's first cold solve until a server has served one tick
    from its ticket's fallback, then let it land before the next tick: the
    server starts on the trivial layout and ``_maybe_swap_kv`` hot-swaps
    it exactly once, however fast the solver is."""
    gate = threading.Event()
    build, tick = port_core.BankingPlanner.build_space, PS.Server._tick

    def gated(self, prep):
        gate.wait(30)
        return build(self, prep)

    def tick_then_release(self):
        tick(self)
        if self.ticks == 1 and not gate.is_set():
            gate.set()
            assert self._kv_ticket.wait(30)

    monkeypatch.setattr(port_core.BankingPlanner, "build_space", gated)
    monkeypatch.setattr(PS.Server, "_tick", tick_then_release)
    return gate


def test_launcher_serves_the_reduced_model_on_the_cpu(capsys, monkeypatch,
                                                      tmp_path):
    from repro_torch.launch import serve

    gate_first_solve(monkeypatch)
    srv = serve.main(["--arch", "qwen2-7b", "--smoke", "--device", "cpu",
                      "--requests", "3", "--max-batch", "2", "--max-new", "3",
                      "--max-len", "32", "--seed", "2",
                      "--plan-store", str(tmp_path)])
    out = capsys.readouterr().out
    assert srv.swaps == 1 and not srv.queue and not srv.active
    assert "serving from: compiled flat N=1 B=1" in out
    assert "hot-swapped to solved layout" in out
    assert "served 3 requests (9 tokens)" in out
    assert "page pool: 2 slots x" in out
