#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--seed 0] [--layers N] [--skip-serve] [--profile]

Run from the root of a checkout, with no arguments, it

1. probes the device and the toolchain and builds every CUDA kernel of the
   port from the sources in the checkout (``src/repro_torch/kernels/csrc``,
   one ``nvcc`` per source, all started together);
2. holds each kernel against its plain torch version on the card, exactly:
   the banked kernels over the tested banking layouts, both transform
   levels, the server's layouts, several dtypes and row widths, a scatter
   with many duplicates, and one large gather that it also times; the MoE
   dispatch kernel over bf16 and fp32, several row widths, many empty
   slots, duplicate sources, the decode shape, and a prefill-sized buffer
   that it also times;
3. runs the port's main paths: the continuous-batching decode server on
   qwen2-7b and on olmoe-1b-7b, each at full width (random bf16 weights
   from ``--seed``), which starts on the trivial layout, hot-swaps to the
   solved page layout after a few ticks, answers 16 requests, and is
   checked for finished requests, for the record table against what was
   recorded, for kernel launch counts against the ticks and the decode
   calls, and for identical tokens when repeated;
4. times each kernel at the shapes the main path gave it, beside its plain
   version, its bound and the nearest single PyTorch call (for the banked
   kernels it is handed the resolved physical rows, since no PyTorch call
   resolves BA/BO), and prints the times on the card as one
   ``{"kernels": [...]}`` line and the host-inclusive times per call as
   another;
5. checks each family's reduced model's logits on the card against the
   same weights on the CPU.

Every phase prints one JSON line; the first failure ends the run with a
non-zero exit code.  There is no CPU fallback: without a CUDA device, or
without the package beside this file, it exits non-zero and prints no
result.  The last line is ``{"ok": true, "device": {...}}``.

``--layers`` cuts the served models' depth and ``--skip-serve`` leaves
phases 3-5 out; both are for iterating on the kernels and change what the
last line may claim: with ``--skip-serve`` there is no ``ok`` line.
``--profile`` adds a ``torch.profiler`` window over a few steady decode
ticks of each served model.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
# The data sheet has no int32 rate; the float32 rate outside the tensor
# cores bounds it from above, so the operation bound stays a lower bound.
INT_OPS_PER_S = 67e12

SOURCE = {
    "banked_gather": "src/repro_torch/kernels/csrc/banked.cu",
    "banked_scatter": "src/repro_torch/kernels/csrc/banked.cu",
    "banked_scatter_elems": "src/repro_torch/kernels/csrc/banked.cu",
    "moe_dispatch": "src/repro_torch/kernels/csrc/moe_dispatch.cu",
}
REPLACES = {
    "banked_gather": "src/repro/kernels/banked_gather.py:65",
    "banked_scatter": "src/repro/kernels/banked_gather.py:107",
    "banked_scatter_elems": "src/repro/kernels/banked_gather.py:146",
    "moe_dispatch": "src/repro/kernels/moe_dispatch.py:27",
}


def say(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def max_abs_diff(a, b):
    if a.shape != b.shape or a.dtype != b.dtype:
        fail(f"shape/dtype differ: {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def free_device_memory(torch):
    """Hand what a finished phase left back to the card, so that two
    full-width models are never resident together."""
    gc.collect()
    torch.cuda.empty_cache()


def time_ms(torch, fn, iters=200, warmup=20, stall_ms=0.0):
    """Milliseconds per call between two CUDA events around ``iters`` calls.

    With ``stall_ms`` the stream is first kept busy for about that long, so
    the host enqueues every call while the card still waits and the events
    see the calls back to back: the time on the card, without the host's
    share of a call.  Without it a call that the host prepares more slowly
    than the card runs it is timed at the host's pace: what a caller pays.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if stall_ms:
        torch.cuda._sleep(int(stall_ms * 1.5e6))   # cycles at ~1.5 GHz
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# ---------------------------------------------------------------------------
# Phase 1: device, toolchain, build
# ---------------------------------------------------------------------------


def phase_toolchain(torch):
    from repro_torch.kernels import _build

    nvcc = _build.find_nvcc()
    nvcc_version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[-2:]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.build(force=True, extra_flags=["-Xptxas", "-v"])
    ptxas = [ln for name in _build.SOURCES
             for ln in _build.build_log[name].splitlines()
             if "registers" in ln or "spill" in ln]
    say("toolchain", python=sys.version.split()[0], torch=torch.__version__,
        torch_cuda=torch.version.cuda, nvcc=nvcc_version,
        card=smi, capability=list(torch.cuda.get_device_capability(0)),
        build_seconds={k: round(v, 2)
                       for k, v in _build.build_seconds.items()},
        ptxas=ptxas)
    return smi


# ---------------------------------------------------------------------------
# Phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------


def test_layouts():
    """(label, artifact) for every layout the kernels are held to."""
    from repro_torch.core import (FlatGeometry, MemorySpec, MultiDimGeometry,
                                  compile_geometry, compile_trivial)
    from repro_torch.core.geometry import propose_P
    from repro_torch.runtime.server import page_solution

    out = []
    flat = [((24,), 3, 1, 0), ((60,), 8, 1, 0), ((32,), 4, 2, 0),
            ((21,), 5, 3, 0), ((8, 12), 4, 1, 1), ((8, 12), 3, 2, 0),
            ((6, 10), 4, 1, None)]
    multi = [((8, 12), (2, 3), (1, 1)), ((8, 12), (4, 1), (2, 1)),
             ((6, 6), (3, 2), (1, 1))]
    for level in ("full", "basic"):
        for dims, N, B, unit in flat:
            n = len(dims)
            alpha = ((1,) * n if unit is None else
                     tuple(1 if i == unit else 0 for i in range(n)))
            mem = MemorySpec("m", dims=dims, word_bits=16, ports=1)
            geo = FlatGeometry(N=N, B=B, alpha=alpha,
                               P=propose_P(mem, N, B, alpha)[0])
            out.append((f"flat{dims}N{N}B{B}-{level}",
                        compile_geometry(mem, geo, transform_level=level)))
        for dims, Ns, Bs in multi:
            mem = MemorySpec("m", dims=dims, word_bits=16, ports=1)
            geo = MultiDimGeometry(Ns=Ns, Bs=Bs, alphas=(1,) * len(dims))
            out.append((f"multi{dims}N{Ns}-{level}",
                        compile_geometry(mem, geo, transform_level=level)))
    out.append(("trivial(60,)", compile_trivial(
        MemorySpec("m", dims=(60,), word_bits=32, ports=1))))
    out.append(("trivial(6,10)", compile_trivial(
        MemorySpec("m", dims=(6, 10), word_bits=32, ports=1))))
    out.append(("server64", page_solution(None, 64, 16, 4)))
    out.append(("server1024", page_solution(None, 1024, 16, 8)))
    return out


def random_table(torch, art, D, dtype, gen):
    A = art.layout.logical_size
    if dtype == torch.int32:
        flat = torch.randint(-2 ** 31, 2 ** 31 - 1, (A, D), generator=gen,
                             device="cuda", dtype=torch.int64).to(dtype)
    else:
        flat = torch.randn((A, D), generator=gen, device="cuda").to(dtype)
    return flat, art.pack(flat)


def phase_kernels(torch, seed):
    import numpy as np

    from repro_torch.kernels import banked_gather as bg

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    worst = {k: 0.0 for k in bg.LAUNCHES}
    cases = 0
    bg.reset_launch_counts()
    for label, art in test_layouts():
        A = art.layout.logical_size
        every = np.arange(A)
        for dtype in (torch.int32, torch.bfloat16, torch.float32):
            for D in (1, 8, 3584):
                flat, table = random_table(torch, art, D, dtype, gen)
                # B1 over the WHOLE logical range, then a (T, R) batch
                got = art.gather(table, every)
                want = bg.banked_gather_plain(
                    table, torch.from_numpy(every).cuda(), art)
                d = max(max_abs_diff(got, want), max_abs_diff(got, flat))
                idx2 = rng.integers(0, A, size=(5, 7))
                got2 = art.gather(table, idx2)
                check(tuple(got2.shape) == (5, 7, D), f"{label}: (T,R) shape")
                d = max(d, max_abs_diff(
                    got2, flat[torch.from_numpy(idx2).cuda()]))
                worst["banked_gather"] = max(worst["banked_gather"], d)
                check(d == 0.0, f"banked_gather differs on {label} "
                                f"{dtype} D={D}: {d}")
                # B3 with duplicates, against the plain version on a copy
                T = min(2 * A, 96)
                idx = rng.integers(0, A, size=T)
                vals = torch.randn((T, D), generator=gen,
                                   device="cuda").to(dtype)
                mine, theirs = table.clone(), table.clone()
                art.scatter(mine, idx, vals)
                bg.banked_scatter_plain(
                    theirs, torch.from_numpy(idx).cuda(), vals, art)
                d = max_abs_diff(mine, theirs)
                worst["banked_scatter"] = max(worst["banked_scatter"], d)
                check(d == 0.0, f"banked_scatter differs on {label} "
                                f"{dtype} D={D}: {d}")
                # B2 with duplicate (row, col) pairs
                cols = rng.integers(0, D, size=T)
                ev = torch.randn((T,), generator=gen, device="cuda").to(dtype)
                mine, theirs = table.clone(), table.clone()
                art.scatter(mine, idx, ev, col=cols)
                bg.banked_scatter_elems_plain(
                    theirs, torch.from_numpy(idx).cuda(),
                    torch.from_numpy(cols).cuda(), ev, art)
                d = max_abs_diff(mine, theirs)
                worst["banked_scatter_elems"] = max(
                    worst["banked_scatter_elems"], d)
                check(d == 0.0, f"banked_scatter_elems differs on {label} "
                                f"{dtype} D={D}: {d}")
                cases += 1
    torch.cuda.synchronize()

    # many duplicates: 4096 writes over 64 distinct addresses; the result is
    # also held to a sequential host loop (last write wins in index order)
    from repro_torch.runtime.server import page_solution
    art = page_solution(None, 1024, 16, 8)
    flat, table = random_table(torch, art, 8, torch.int32, gen)
    addrs = rng.choice(1024, size=64, replace=False)
    idx = addrs[rng.integers(0, 64, size=4096)]
    vals = torch.randint(0, 1 << 20, (4096, 8), generator=gen, device="cuda",
                         dtype=torch.int64).to(torch.int32)
    cols = rng.integers(0, 8, size=4096)
    want_rows = flat.cpu().numpy().copy()
    want_elems = want_rows.copy()
    v_host = vals.cpu().numpy()
    for t in range(4096):
        want_rows[idx[t]] = v_host[t]
        want_elems[idx[t], cols[t]] = v_host[t, 0]
    got_rows = art.unpack(art.scatter(table.clone(), idx, vals))
    got_elems = art.unpack(art.scatter(table.clone(), idx, vals[:, 0],
                                       col=cols))
    d_rows = max_abs_diff(got_rows, torch.from_numpy(want_rows).cuda())
    d_elems = max_abs_diff(got_elems, torch.from_numpy(want_elems).cuda())
    check(d_rows == 0.0 and d_elems == 0.0,
          f"duplicates: last write does not win ({d_rows}, {d_elems})")

    # out-of-range addresses that already lie on the card: zero row / dropped
    bad = torch.tensor([3, 5000, -1, 7], device="cuda", dtype=torch.int64)
    got = art.gather(table, bad)
    check(bool((got[1] == 0).all() and (got[2] == 0).all())
          and max_abs_diff(got[[0, 3]], flat[[3, 7]]) == 0.0,
          "out-of-range gather rows are not zero")
    kept = table.clone()
    art.scatter(kept, bad[1:3], vals[:2])
    check(max_abs_diff(kept, table) == 0.0, "out-of-range scatter wrote")

    # one large gather: 65,536 logical rows x 3584 bf16, T = 4096, timed
    from repro_torch.core import FlatGeometry, MemorySpec, compile_geometry
    from repro_torch.core.geometry import propose_P
    mem = MemorySpec("embed", dims=(65536,), word_bits=16, ports=1)
    geo = FlatGeometry(N=8, B=16, alpha=(1,),
                       P=propose_P(mem, 8, 16, (1,))[0])
    big = compile_geometry(mem, geo)
    flat, table = random_table(torch, big, 3584, torch.bfloat16, gen)
    # eight index sets in turn: their rows (8 x 29 MB) exceed the 50 MB L2,
    # so a launch finds its rows in device memory as a real caller would
    sets = [torch.from_numpy(rng.integers(0, 65536, size=4096)).cuda()
            for _ in range(8)]
    sets32 = [i.to(torch.int32) for i in sets]
    phys = [ba * big.bank_volume + bo
            for ba, bo in (big.resolve(i) for i in sets)]
    rows2d = table.view(-1, 3584)
    d_big = 0.0
    for i64, i32 in zip(sets, sets32):
        d_big = max(d_big, max_abs_diff(big.gather(table, i32), flat[i64]))
    check(d_big == 0.0, f"large gather differs: {d_big}")
    turn = [0]

    def in_turn(fn, args):
        def run():
            turn[0] += 1
            return fn(args[turn[0] % 8])
        return run

    timed = {}
    for key, stall in (("ms", 60.0), ("call_ms", 0.0)):
        timed[key] = time_ms(
            torch, in_turn(lambda i: big.gather(table, i), sets32),
            iters=64, warmup=8, stall_ms=stall)
        timed["plain_" + key] = time_ms(torch, in_turn(
            lambda i: bg.banked_gather_plain(table, i, big), sets),
            iters=64, warmup=8, stall_ms=stall)
        timed["library_" + key] = time_ms(torch, in_turn(
            lambda p: torch.index_select(rows2d, 0, p), phys),
            iters=64, warmup=8, stall_ms=stall)
    nbytes = 2 * 4096 * 3584 * 2 + 4 * 4096
    say("kernels", cases=cases, layouts=len(test_layouts()),
        max_abs_diff=worst, launches=dict(bg.LAUNCHES),
        duplicates={"writes": 4096, "distinct": 64,
                    "max_abs_diff": max(d_rows, d_elems)},
        large_gather={"rows": 65536, "D": 3584, "dtype": "bfloat16",
                      "T": 4096, "max_abs_diff": d_big, **timed,
                      "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "bound_by": "bytes", "bytes": nbytes})


def routed_slots(torch, rng, T, cfg):
    """``slot_token`` of a random top-k routing of T tokens, as the MoE
    layer builds it (each token picks ``top_k`` distinct experts)."""
    import numpy as np

    from repro_torch.models import moe

    E, K = cfg.n_experts, cfg.top_k
    top_i = np.stack([rng.permutation(E)[:K] for _ in range(T)])
    slot, *_ = moe.dispatch_slots(torch.from_numpy(top_i).cuda(),
                                  moe.capacity(cfg, T), E)
    return slot


def phase_moe_kernel(torch, seed):
    """B5 against its plain version, exactly, and one prefill-sized
    dispatch timed (not on the main path: the server decodes only)."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ops
    from repro_torch.models import moe

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    olmoe = get_arch("olmoe_1b_7b")
    worst, cases = 0.0, 0

    def held(x, slot, label):
        nonlocal worst, cases
        T = x.shape[0]
        x_padded = torch.cat([x, x.new_zeros((1, x.shape[1]))])
        want = md.moe_dispatch_plain(x_padded, slot)
        for got in (md.moe_dispatch(x_padded, slot), ops.dispatch(x, slot)):
            d = max_abs_diff(got, want)
            worst = max(worst, d)
            check(d == 0.0 and torch.equal(got, want),
                  f"moe_dispatch differs on {label}: {d}")
        check(bool((want[slot == T] == 0).all()), f"{label}: empty slot "
              f"is not a zero row")
        cases += 1

    md.reset_launch_counts()
    for dtype in (torch.bfloat16, torch.float32):
        for D in (3, 16, 2048, 3584):
            for T, S in ((8, 512), (37, 96), (256, 1024)):
                x = torch.randn((T, D), generator=gen, device="cuda").to(dtype)
                # many empty slots: about 3 in 4 read the zeros row
                slot = np.where(rng.random(S) < 0.75, T,
                                rng.integers(0, T, size=S))
                held(x, torch.from_numpy(slot.astype(np.int32)).cuda(),
                     f"{dtype} D={D} T={T} empty")
                # duplicate sources: every slot from one of 3 tokens
                slot = rng.choice(rng.choice(T, 3, replace=False), size=S)
                held(x, torch.from_numpy(slot.astype(np.int32)).cuda(),
                     f"{dtype} D={D} T={T} duplicates")
            # the full-width decode shape: 8 tokens routed top-8 of 64
            x = torch.randn((8, D), generator=gen, device="cuda").to(dtype)
            held(x, routed_slots(torch, rng, 8, olmoe),
                 f"{dtype} D={D} decode")
    # a misaligned base: the rows start 2 bytes into an allocation
    base = torch.randn((9 * 2048 + 1,), generator=gen, device="cuda").to(
        torch.bfloat16)
    x_padded = base[1:].view(9, 2048)
    x_padded[8] = 0
    slot = routed_slots(torch, rng, 8, olmoe)
    d = max_abs_diff(md.moe_dispatch(x_padded, slot),
                     md.moe_dispatch_plain(x_padded, slot))
    worst = max(worst, d)
    check(d == 0.0, f"moe_dispatch differs on a misaligned base: {d}")
    cases += 1
    # indices out of range that already lie on the card: zero rows
    x = torch.randn((8, 16), generator=gen, device="cuda")
    bad = torch.tensor([3, -1, 9, 1 << 30, 8], device="cuda",
                       dtype=torch.int32)
    got = md.moe_dispatch(torch.cat([x, x.new_zeros((1, 16))]), bad)
    check(bool((got[1:] == 0).all()) and torch.equal(got[0], x[3]),
          "out-of-range dispatch rows are not zero")
    torch.cuda.synchronize()

    # prefill-sized: 4096 tokens routed top-8 of 64 at C = capacity(4096)
    T, D = 4096, olmoe.d_model
    C = moe.capacity(olmoe, T)
    x = torch.randn((T, D), generator=gen, device="cuda").to(torch.bfloat16)
    slot = routed_slots(torch, rng, T, olmoe)
    x_padded = torch.cat([x, x.new_zeros((1, D))])
    d = max_abs_diff(ops.dispatch(x, slot),
                     md.moe_dispatch_plain(x_padded, slot))
    check(d == 0.0, f"prefill-sized moe_dispatch differs: {d}")
    S = slot.shape[0]
    nbytes = ((T + 1) * D + S * D) * 2 + 4 * S
    timed = {key: time_ms(torch, fn, iters=50, stall_ms=60.0) for key, fn in (
        ("ms", lambda: md.moe_dispatch(x_padded, slot)),
        ("plain_ms", lambda: md.moe_dispatch_plain(x_padded, slot)),
        ("library_ms", lambda: torch.index_select(x_padded, 0, slot)))}
    say("moe_dispatch_kernel", cases=cases, max_abs_diff=worst,
        launches=dict(md.LAUNCHES),
        prefill_sized={"T": T, "D": D, "E": olmoe.n_experts, "C": C,
                       "slots": S, "empty": int((slot == T).sum()),
                       "dtype": "bfloat16", "max_abs_diff": d, **timed,
                       "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                       "bound_by": "bytes", "bytes": nbytes})


# ---------------------------------------------------------------------------
# Phase 3: the main paths -- qwen2-7b and olmoe-1b-7b decode servers
# ---------------------------------------------------------------------------


def serve_once(torch, cfg, seed, swap_after=3):
    """One run of the server on the card.  Returns what the checks need."""
    import numpy as np

    from repro_torch.core import MemorySpec, compile_trivial
    from repro_torch.kernels import banked_gather as bg
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.models import get_model
    from repro_torch.runtime.server import Request, Server, page_solution

    max_batch, max_len, page, readers = 8, 1024, 16, 8
    n_requests, max_new = 16, 16
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    server = Server(get_model(cfg), max_batch=max_batch, max_len=max_len,
                    kv_plan=compile_trivial(MemorySpec(
                        "kv_pool", dims=(max_len,), word_bits=16, ports=1)),
                    device="cuda", generator=gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    solved = page_solution(cfg, max_len, page=page, readers=readers)

    rng = np.random.default_rng(seed)
    reqs = []
    for uid in range(n_requests):
        prompt = rng.integers(2, cfg.vocab - 1,
                              size=int(rng.integers(3, 8))).astype(np.int32)
        reqs.append(Request(uid=uid, prompt=prompt, max_new=max_new))
        server.submit(reqs[-1])

    # shadow of what the host asked to record: (slot, pos) -> token
    shadow = np.zeros((max_len, max_batch), np.int32)
    record = server._record

    def recording(slot, tok):
        pos = int(server.positions[slot])
        if pos < max_len:
            shadow[pos, slot] = tok
        record(slot, tok)

    server._record = recording

    bg.reset_launch_counts()          # the main path starts here
    md.reset_launch_counts()
    admit_ticks = 0
    swap_identical = None
    t0 = time.perf_counter()
    while server.queue or server.active:
        check(server.ticks < 500, "server did not drain")
        if server.ticks == swap_after and server.swaps == 0:
            # what the plan plane does between ticks once a solve lands
            before = server._kv_art.unpack(server.kv_records).clone()
            server._swap_to(solved)
            server.swaps += 1
            after = server._kv_art.unpack(server.kv_records)
            swap_identical = max_abs_diff(before, after) == 0.0
        queued = len(server.queue)
        server.tick()
        admit_ticks += len(server.queue) < queued
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**bg.LAUNCHES, **md.LAUNCHES}     # ... and ends here
    del server._record        # the wrapper's closure holds the server

    records = server._kv_art.unpack(server.kv_records).cpu().numpy()
    return {
        "server": server, "reqs": reqs, "shadow": shadow, "records": records,
        "launches": launches, "admit_ticks": admit_ticks, "wall": wall,
        "init_s": init_s, "swap_identical": swap_identical,
        "decode_calls": int(server.cache.pos),
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "layout": solved.describe(),
    }


def phase_serve(torch, cfg, seed):
    import numpy as np

    run = serve_once(torch, cfg, seed)
    server, reqs = run["server"], run["reqs"]
    check(all(r.done and len(r.out) == r.max_new for r in reqs),
          "a request did not finish with max_new tokens")
    check(all(0 <= t < cfg.vocab for r in reqs for t in r.out),
          "a token is outside the vocabulary")
    check(run["swap_identical"] is True,
          "logical records changed across the hot swap")
    check(server.pager.artifact.n_banks == 8, "server is not on the solved "
          "layout")
    check(np.array_equal(run["records"], run["shadow"]),
          "record table differs from what was recorded")
    # what prompts and outputs imply: a slot's last request left its prompt
    # at 0..S-1 and its outputs from S+1 on (S holds the first prediction)
    last_in_slot = {}
    for r in reqs:
        hits = [s for s in range(8) if np.array_equal(
            run["records"][:len(r.prompt), s], r.prompt)
            and np.array_equal(
                run["records"][len(r.prompt) + 1:
                               len(r.prompt) + 1 + r.max_new, s], r.out)]
        for s in hits:
            last_in_slot[s] = r.uid
    check(len(last_in_slot) == 8, f"only {len(last_in_slot)} of 8 slots hold "
          f"a request's prompt and outputs position by position")
    ticks, lau = server.ticks, run["launches"]
    check(lau["banked_gather"] == ticks,
          f"gather launches {lau['banked_gather']} != ticks {ticks}")
    check(lau["banked_scatter_elems"] == ticks + run["admit_ticks"],
          f"scatter_elems launches {lau['banked_scatter_elems']} != ticks "
          f"{ticks} + admitting ticks {run['admit_ticks']}")
    check(lau["banked_scatter"] == 1,
          f"row scatter launches {lau['banked_scatter']} != 1 swap")
    moe_layers = cfg.n_layers if cfg.family == "moe" else 0
    check(lau["moe_dispatch"] == moe_layers * run["decode_calls"],
          f"moe_dispatch launches {lau['moe_dispatch']} != {moe_layers} "
          f"MoE layers x {run['decode_calls']} decode calls")
    check(run["decode_calls"] < 1024, "cache.pos reached max_len")
    tokens = [list(r.out) for r in reqs]
    first = {k: run[k] for k in ("launches", "admit_ticks", "wall", "init_s",
                                 "decode_calls", "peak_bytes", "layout")}
    first["ticks"] = ticks
    del run, server, reqs
    free_device_memory(torch)

    again = serve_once(torch, cfg, seed)
    check([list(r.out) for r in again["reqs"]] == tokens,
          "the same seed gave different tokens on the second run")
    del again
    free_device_memory(torch)
    n_tokens = sum(len(t) for t in tokens)
    say("serve", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        vocab=cfg.vocab, n_experts=cfg.n_experts, top_k=cfg.top_k,
        dtype="bfloat16", max_batch=8, max_len=1024,
        requests=16, max_new=16, ticks=first["ticks"], tokens=n_tokens,
        decode_calls=first["decode_calls"],
        admitting_ticks=first["admit_ticks"],
        wall_seconds=first["wall"], tokens_per_second=n_tokens / first["wall"],
        init_seconds=first["init_s"], launches=first["launches"],
        served_from=first["layout"], repeat_identical=True,
        peak_memory_bytes=first["peak_bytes"])
    return first["launches"]


def phase_profile(torch, cfg, seed, ticks=8):
    """Optional (``--profile``): where a steady decode tick's time goes,
    with all 8 slots active.  Wall time per tick from ``ticks`` ticks with
    the profiler off; then ``torch.profiler`` over as many ticks for the
    card's busy time (hence its idle share), the kernels that take most of
    it, and the port's own kernels' share of it."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import get_model
    from repro_torch.runtime.server import Request, Server, page_solution

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    server = Server(get_model(cfg), max_batch=8, max_len=1024,
                    kv_plan=page_solution(cfg, 1024, page=16, readers=8),
                    device="cuda", generator=gen)
    rng = np.random.default_rng(seed)
    for uid in range(8):
        server.submit(Request(uid=uid, max_new=2 * ticks + 8,
                              prompt=rng.integers(
                                  2, cfg.vocab - 1, size=4).astype(np.int32)))
    for _ in range(4):                       # admission and warm-up
        server.tick()
    torch.cuda.synchronize()
    t0 = time.perf_counter()                 # wall time: profiler off
    for _ in range(ticks):
        server.tick()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            server.tick()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    check(by_name, "the profiler recorded no device activity")
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    own = {k: {"launches": n, "ms": us / 1e3, "share_of_busy": us / 1e3
               / busy_ms}
           for k, (n, us) in by_name.items()
           if "bk_" in k or "md_dispatch" in k}
    say("profile", arch=cfg.name, layers=cfg.n_layers, ticks=ticks, slots=8,
        wall_ms_per_tick=wall_ms / ticks, device_busy_ms_per_tick=busy_ms / ticks,
        device_idle_share=max(0.0, 1 - busy_ms / wall_ms),
        device_launches_per_tick=sum(n for n, _ in by_name.values()) / ticks,
        top_kernels=[{"name": k[:80], "launches": n, "ms": us / 1e3}
                     for k, (n, us) in top],
        own_kernels=own,
        note="wall time from the same number of ticks with the profiler off")
    del server
    free_device_memory(torch)


# ---------------------------------------------------------------------------
# Phase 4: each kernel at the main path's shapes, beside its yardsticks
# ---------------------------------------------------------------------------


def resolve_ops(art, T):
    prog = art.kernel_program()
    nd = len(art.layout.dims)
    return T * (len(prog.instrs) + 2 * nd + 2 * len(prog.ba_regs))


def phase_kernel_times(torch, seed, launches):
    """Each kernel at the shapes the servers gave it.  B1-B3: an int32
    record table of (8 banks, 128 rows, 8 slots); the tick's gather reads
    8 slots x 4 trailing records, its element scatter writes 8 records,
    and the swap's row scatter repacks all 1024 rows.  B5: olmoe's decode
    call, 8 tokens of 2048 bf16 and the zeros row, routed top-8 of 64
    experts into 64 x 8 slots."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.kernels import banked_gather as bg
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime.server import page_solution

    art = page_solution(None, 1024, 16, 8)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    flat, table = random_table(torch, art, 8, torch.int32, gen)
    rows2d = table.clone().view(-1, 8)    # the library calls' own table
    out, call_ms = [], {}

    def entry(name, kernel, plain, library, err, nbytes, ops):
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = ops / INT_OPS_PER_S * 1e3
        # 50 calls behind a 60 ms stall: even the plain versions' dozen
        # launches per call are all enqueued before the card starts on them
        on_card = [time_ms(torch, fn, iters=50, stall_ms=60.0)
                   for fn in (kernel, plain, library)]
        call_ms[name] = dict(zip(
            ("call_ms", "plain_call_ms", "library_call_ms"),
            (time_ms(torch, fn) for fn in (kernel, plain, library))))
        out.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err, "ms": on_card[0], "plain_ms": on_card[1],
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": on_card[2]})

    def phys(idx):
        ba, bo = art.resolve(idx.to(torch.int64))
        return ba * art.bank_volume + bo

    # B1: (8, 4) index matrix, rows of 8 int32
    pos = rng.integers(4, 1024, size=8)
    idx = torch.from_numpy(np.stack(
        [np.arange(p - 4, p) for p in pos]).astype(np.int32)).cuda()
    flat_idx = idx.reshape(-1)
    got = art.gather(table, idx)
    err = max_abs_diff(got.reshape(32, 8),
                       bg.banked_gather_plain(table, flat_idx, art))
    p_idx = phys(flat_idx)
    entry("banked_gather",
          lambda: art.gather(table, idx),
          lambda: bg.banked_gather_plain(table, flat_idx, art),
          lambda: torch.index_select(rows2d, 0, p_idx),
          err, 2 * 32 * 8 * 4 + 4 * 32, resolve_ops(art, 32))

    # B2: 8 records, one per slot
    idx = torch.from_numpy(pos.astype(np.int32)).cuda()
    cols = torch.arange(8, device="cuda", dtype=torch.int32)
    vals = torch.randint(0, 152064, (8,), generator=gen, device="cuda",
                         dtype=torch.int64).to(torch.int32)
    mine, theirs = table.clone(), table.clone()
    art.scatter(mine, idx, vals, col=cols)
    bg.banked_scatter_elems_plain(theirs, idx, cols, vals, art)
    err = max_abs_diff(mine, theirs)
    p_idx, c64 = phys(idx), cols.to(torch.int64)
    entry("banked_scatter_elems",
          lambda: art.scatter(mine, idx, vals, col=cols),
          lambda: bg.banked_scatter_elems_plain(theirs, idx, cols, vals, art),
          lambda: rows2d.index_put_((p_idx, c64), vals),
          err, 8 * (4 + 4 + 4 + 4), resolve_ops(art, 8) + 8)

    # B3: the swap's repack of all 1024 logical rows
    idx = torch.arange(1024, device="cuda", dtype=torch.int32)
    mine, theirs = torch.zeros_like(table), torch.zeros_like(table)
    art.scatter(mine, idx, flat)
    bg.banked_scatter_plain(theirs, idx, flat, art)
    err = max(max_abs_diff(mine, theirs), max_abs_diff(mine, table))
    p_idx = phys(idx)
    entry("banked_scatter",
          lambda: art.scatter(mine, idx, flat),
          lambda: bg.banked_scatter_plain(theirs, idx, flat, art),
          lambda: rows2d.index_copy_(0, p_idx, flat),
          err, 2 * 1024 * 8 * 4 + 4 * 1024, resolve_ops(art, 1024) + 1024)

    # B5: the expert buffer of one MoE layer of olmoe's decode call
    olmoe = get_arch("olmoe_1b_7b")
    T, D = 8, olmoe.d_model
    x = torch.randn((T, D), generator=gen, device="cuda").to(torch.bfloat16)
    x_padded = torch.cat([x, x.new_zeros((1, D))])
    slot = routed_slots(torch, rng, T, olmoe)
    S = slot.shape[0]
    want = md.moe_dispatch_plain(x_padded, slot)
    err = max(max_abs_diff(md.moe_dispatch(x_padded, slot), want),
              max_abs_diff(kops.dispatch(x, slot), want))
    entry("moe_dispatch",
          lambda: md.moe_dispatch(x_padded, slot),
          lambda: md.moe_dispatch_plain(x_padded, slot),
          lambda: torch.index_select(x_padded, 0, slot),
          err, ((T + 1) * D + S * D) * 2 + 4 * S, 0)

    for k in out:
        check(k["max_abs_err"] == 0.0, f"{k['name']} differs from its plain "
              f"version at the server's shapes: {k['max_abs_err']}")
        check(k["launches"] > 0, f"the main path never launched {k['name']}")
    say("kernel_call_times", note="host-inclusive ms per call, timed without "
        "the stall; the kernels line holds the times on the card", **call_ms)
    return {"kernels": out}


# ---------------------------------------------------------------------------
# Phase 5: a reduced model on the card against the same weights on the CPU
# ---------------------------------------------------------------------------


def phase_small_reference(torch, cfg, seed):
    from repro_torch.models import get_model

    small = cfg.reduced()
    model = get_model(small)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    cpu_params = model.init(gen, device="cpu")

    def to_cuda(tree):
        return {k: to_cuda(v) if isinstance(v, dict) else v.cuda()
                for k, v in tree.items()}

    gpu_params = to_cuda(cpu_params)
    toks = torch.randint(2, small.vocab - 1, (4, 3), generator=gen,
                         dtype=torch.int64).to(torch.int32)
    caches = {"cpu": model.init_cache(4, 16, device="cpu"),
              "cuda": model.init_cache(4, 16, device="cuda")}
    worst = 0.0
    for step in range(3):
        logits = {}
        for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
            out, caches[dev] = model.decode(
                params, caches[dev], toks[:, step:step + 1].to(dev))
            logits[dev] = out.float().cpu()
        check(tuple(logits["cuda"].shape) == (4, small.vocab)
              and bool(torch.isfinite(logits["cuda"]).all()),
              "reduced model: logits are not finite (4, vocab)")
        tol = 2e-2 * float(logits["cpu"].abs().max())
        diff = float((logits["cuda"] - logits["cpu"]).abs().max())
        worst = max(worst, diff / tol)
        check(diff <= tol, f"reduced model step {step}: card and CPU logits "
              f"differ by {diff} > {tol} (2e-2 of the largest magnitude)")
    say("small_reference", arch=small.name, steps=3,
        worst_share_of_tolerance=worst, tolerance="2e-2 of max |logit|, bf16")


# ---------------------------------------------------------------------------


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the served models' depth (default: full)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile a few steady decode ticks of each")
    ap.add_argument("--skip-serve", action="store_true",
                    help="toolchain and kernel phases only; no ok line")
    args = ap.parse_args()

    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail("src/repro_torch is not beside this script")
    sys.path.insert(0, src)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    from repro_torch.configs import get_arch

    started = time.perf_counter()
    card = phase_toolchain(torch)
    phase_kernels(torch, args.seed)
    phase_moe_kernel(torch, args.seed)
    if args.skip_serve:
        print(card, flush=True)
        return 0
    archs = [get_arch("qwen2_7b"), get_arch("olmoe_1b_7b")]
    if args.layers is not None:
        archs = [dataclasses.replace(c, n_layers=args.layers) for c in archs]
    launches = {}                 # summed over the main paths' first runs
    for cfg in archs:
        for name, n in phase_serve(torch, cfg, args.seed).items():
            launches[name] = launches.get(name, 0) + n
    kernels = phase_kernel_times(torch, args.seed, launches)
    for cfg in archs:
        phase_small_reference(torch, cfg, args.seed)
    if args.profile:
        for cfg in archs:
            phase_profile(torch, cfg, args.seed)
    for banned in ("jax", "repro"):
        check(banned not in sys.modules, f"{banned} was imported")
    say("done", seconds=time.perf_counter() - started)
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
