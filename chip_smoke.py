#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--seed 0] [--layers N] [--skip-serve] [--profile]

Run from the root of a checkout, with no arguments, it

1. probes the device and the toolchain and builds every CUDA kernel of the
   port from the sources in the checkout (``src/repro_torch/kernels/csrc``,
   one ``nvcc`` per source, all started together);
2. holds each kernel against its plain torch version on the card: the
   banked kernels and the MoE dispatch exactly (over the tested banking
   layouts, both transform levels, the server's layouts, several dtypes
   and row widths, scatters of 1024 and 4096 writes over 64 addresses and
   of 4096 over 2 -- the winner table --, element scatters of 33 writes,
   of 128 over 24 pairs, of the admit flush's 8,000 distinct pairs, of
   65,536 writes over 3 addresses x 8 columns and of 3,000 distinct pairs
   that all fall to one block, addresses out of range already on the card, many empty slots,
   duplicate sources, the decode shape, a large gather and a
   prefill-sized dispatch that it also times), with the banked kernels'
   registers, stack and spill bytes from ptxas (no stack frame and no
   spill allowed); the SSD chunk within 1e-4 of the largest
   magnitude of the plain output (3xTF32 products, float32 sums in another
   order), over chunk lengths 1 to 256, the (P, N) of every config, a
   carried state, dt near 0 and dt large, each contiguous, as the chunk
   loop lays it out, inside a longer sequence and with x at an odd offset
   (copied once, counted), with its registers, shared memory and blocks
   per SM; the flash attention within 2e-5 (float32) or
   2e-2 (bfloat16) of the largest magnitude, over head sizes 64, 72, 80,
   128 and 240, causal and not, windows of 32 and 1024, GQA groups of 1, 2
   and 7, 1 to 2048 rows, a cross attention of 64 rows over 1500 keys, a
   ``kv_len`` below the keys and a q at an odd offset (D 72 and the offset
   view go through the bf16 kernel's aligned copy, which is counted), and
   rows that see no key (the mean of v over all keys, from
   ``fa_blind_rows``, launched there and on no model path), with the bf16
   kernel's registers, shared memory and blocks per SM;
3. runs the port's main paths, each at full width with random bf16
   weights from ``--seed``: the continuous-batching decode server on
   qwen2-7b, olmoe-1b-7b, mamba2-370m and zamba2-2.7b, each built on a plan
   ticket from a cold ``PlanService`` over a plan store in a temporary
   directory (removed at exit), whose solve is held until the server has
   served three ticks from the ticket's fallback (one bank = one page); the
   server then hot-swaps to the solved page layout itself, between ticks,
   answers 16 requests, and is checked for finished requests, for the
   record table against what was recorded and across the swap, for kernel
   launch counts against the ticks, the decode calls and the swaps, and
   for identical tokens when repeated; then the plan plane's own paths: a
   second qwen2-7b server on a fresh service over the same store (answered
   at submit, no solver call, no swap, the same tokens), olmoe-1b-7b on a
   joint ticket over its KV pool and its expert buffer (every tick
   coherent, the pools promoted together), and qwen2-7b with telemetry and
   certification on (the measured calls counted against the launches, the
   served plan's certificate in the store); then the fleet
   (``launch/serve_fleet.py`` with ``--fabric``): qwen2-7b, olmoe-1b-7b
   and mamba2-370m at full width on threads, each a tenant of one
   ``PlanService`` whose cold solves (six noise solves first) run on a
   ``SolveFabric`` with two port solve workers, checked for fabric solves
   with no fallback, stats slices that sum to the global counters, record
   tables, launch counts, tokens equal to each server run alone, the
   card's free memory unmoved by the workers' attach (under 64 MB) and no
   worker left after the fabric's shutdown; then the two decode variants
   of the dense transformer -- gemma3-12b's ring-banked local caches past
   the ring's wrap against the full-buffer decode (layer 0's ring rows bit
   for bit, the logits within twice the full-buffer decode's own spread
   under another attention reduction order), qwen2-7b's int8 cache against
   the exact decode (softmax within 0.05);
   then the prefills --
   mamba2-370m (8 x 2048 tokens) and
   zamba2-2.7b (4 x 2048), both also at 1000 tokens (the pad path),
   qwen2-7b (4 x 2048), gemma3-12b (2 x 4096, past its window of 1024),
   olmoe-1b-7b (4 x 2048) and whisper-base (8 x 64 tokens over 1500
   frames, a cache of 448) -- each decoding a few steps on from its cache,
   checked for finite logits, for one flash attention launch per attention
   call, one SSD chunk launch per layer and chunk and one MoE dispatch per
   MoE layer, and for identical tokens when repeated, and timed; the first
   flash attention call of every shape and the first two SSD chunk calls
   of every prefill (every length, whisper's decoder self and cross
   attention too) are held against the plain versions on their own
   inputs;
4. times each kernel at the shapes the main path gave it, beside its plain
   version, its bound and the nearest single PyTorch call (for the banked
   kernels it is handed the resolved physical rows, since no PyTorch call
   resolves BA/BO; no single call computes an SSD chunk; for attention,
   ``scaled_dot_product_attention`` with the same mask, timed as a
   yardstick and called nowhere in the port), on the inputs the prefills
   gave the SSD chunk and the flash attention (each attention shape: qwen2,
   gemma3's local and global layers, olmoe, zamba2, whisper's encoder),
   and prints the times on the
   card as one ``{"kernels": [...]}`` line and the host-inclusive times
   per call as another; B1-B3 and B5 at decode size, and B2 also at the
   first served admit flush and at the size of a flush after eight
   prompts of 1,000 tokens, in 15 rounds interleaved with their PyTorch
   call (``banked_*`` and
   ``moe_dispatch_decode`` lines);
5. checks each family's reduced model on the card against the same
   weights on the CPU: a prefill of 4 rows, then three decode steps.

Every phase prints one JSON line; the first failure ends the run with a
non-zero exit code.  There is no CPU fallback: without a CUDA device, or
without the package beside this file, it exits non-zero and prints no
result.  The last line is ``{"ok": true, "device": {...}}``.

``--layers`` cuts the models' depth (not the fleet's: ``serve_fleet``
builds its servers from the catalog) and ``--skip-serve`` leaves phases 3-5
out; both are for iterating on the kernels and change what the last line
may claim: with ``--skip-serve`` there is no ``ok`` line.  ``--profile``
adds a ``torch.profiler`` window over a few steady decode ticks of each
served model and over one prefill of mamba2-370m, zamba2-2.7b, qwen2-7b
and gemma3-12b.
"""

from __future__ import annotations

import argparse
import atexit
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12    # float32 outside the tensor cores, same sheet
# The data sheet has no int32 rate; the float32 rate outside the tensor
# cores bounds it from above, so the operation bound stays a lower bound.
INT_OPS_PER_S = FP32_FLOPS_PER_S
BF16_FLOPS_PER_S = 989e12   # dense bf16 on the tensor cores, same sheet
TF32_FLOPS_PER_S = 495e12   # dense TF32 on the tensor cores, same sheet
# the SSD chunk against its plain version: both float32, sums in another
# order; the plain version runs in true float32 (allow_tf32 stays off)
SSD_TOL = 1e-4

SOURCE = {
    "banked_gather": "src/repro_torch/kernels/csrc/banked.cu",
    "banked_scatter": "src/repro_torch/kernels/csrc/banked.cu",
    "banked_scatter_elems": "src/repro_torch/kernels/csrc/banked.cu",
    "moe_dispatch": "src/repro_torch/kernels/csrc/moe_dispatch.cu",
    "ssd_chunk": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
}
# the keys of a kernel's row in the kernels line
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")
REPLACES = {
    "banked_gather": "src/repro/kernels/banked_gather.py:65",
    "banked_scatter": "src/repro/kernels/banked_gather.py:107",
    "banked_scatter_elems": "src/repro/kernels/banked_gather.py:146",
    "moe_dispatch": "src/repro/kernels/moe_dispatch.py:27",
    "ssd_chunk": "src/repro/kernels/ssd_chunk.py:61",
    "flash_attention": "src/repro/kernels/flash_attention.py:79",
}


STARTED = time.perf_counter()


def say(phase, **fields):
    """One phase line, stamped with the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "at_seconds": time.perf_counter() - STARTED}),
          flush=True)


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
             if "registers" in ln or "spill" in ln or "C7520" in ln]
    banked = banked_ptxas(_build.build_log["banked"])
    check(banked and all(v["stack"] == v["spill_stores"] ==
                         v["spill_loads"] == 0 for v in banked.values()),
          f"a banked kernel has a stack frame or spills (or ptxas reported "
          f"none): {banked}")
    say("toolchain", python=sys.version.split()[0], torch=torch.__version__,
        torch_cuda=torch.version.cuda, nvcc=nvcc_version,
        card=smi, capability=list(torch.cuda.get_device_capability(0)),
        build_seconds={k: round(v, 2)
                       for k, v in _build.build_seconds.items()},
        banked_ptxas=banked, ptxas=ptxas)
    return smi, banked


def banked_ptxas(log):
    """``-Xptxas -v`` of ``banked.cu`` per kernel: registers, stack frame
    and spill bytes, keyed ``name<program source>`` (``BkTerms<terms>`` or
    ``BkDev<registers,slots>``; for ``bk_scatter_elems_kernel`` the
    element's size in bits first)."""
    import re

    types = {"h": "8,", "t": "16,", "j": "32,", "m": "64,"}
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for _Z\d+(bk_\w+?)I(\w*?)Ev", ln)
        if m:
            args = re.sub(r"Li(\d+)E", r"\1,", m.group(2))
            args = re.sub(r"\d+(Bk[A-Za-z]+)I", r"\1<", args)
            args = args.replace(",E", ">")
            if args[:1] in types:
                args = types[args[0]] + args[1:]
            name = f"{m.group(1)}<{args}>"
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out[name].update(zip(("stack", "spill_stores", "spill_loads"),
                                 map(int, m.groups())))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
            name = None
    return out


# ---------------------------------------------------------------------------
# Phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------


def test_layouts():
    """(label, artifact) for every layout the kernels are held to, through
    every kind of program source (``BkTerms``, each ``BkDev`` bucket)."""
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

    # many duplicates: 1024 and 4096 writes over 64 distinct addresses, and
    # 4096 over 2 (a block owns more writes than it keeps in shared memory
    # and takes the winner table); the result is also held to a sequential
    # host loop (last write wins in index order)
    from repro_torch.runtime.server import page_solution
    art = page_solution(None, 1024, 16, 8)
    flat, table = random_table(torch, art, 8, torch.int32, gen)
    d_dup = 0.0
    for T, distinct in ((1024, 64), (4096, 64), (4096, 2)):
        addrs = rng.choice(1024, size=distinct, replace=False)
        idx = addrs[rng.integers(0, distinct, size=T)]
        vals = torch.randint(0, 1 << 20, (T, 8), generator=gen,
                             device="cuda", dtype=torch.int64).to(torch.int32)
        cols = rng.integers(0, 8, size=T)
        want_rows = flat.cpu().numpy().copy()
        want_elems = want_rows.copy()
        v_host = vals.cpu().numpy()
        for t in range(T):
            want_rows[idx[t]] = v_host[t]
            want_elems[idx[t], cols[t]] = v_host[t, 0]
        got_rows = art.unpack(art.scatter(table.clone(), idx, vals))
        got_elems = art.unpack(art.scatter(table.clone(), idx, vals[:, 0],
                                           col=cols))
        d_rows = max_abs_diff(got_rows, torch.from_numpy(want_rows).cuda())
        d_elems = max_abs_diff(got_elems,
                               torch.from_numpy(want_elems).cuda())
        check(d_rows == 0.0 and d_elems == 0.0, f"duplicates ({T} writes over "
              f"{distinct}): last write does not win ({d_rows}, {d_elems})")
        d_dup = max(d_dup, d_rows, d_elems)

    b2 = b2_cases(torch, gen, rng, art, flat, table)

    # out-of-range addresses that already lie on the card: zero row /
    # dropped, in one block and through the winner table
    bad = torch.tensor([3, 5000, -1, 7], device="cuda", dtype=torch.int64)
    got = art.gather(table, bad)
    check(bool((got[1] == 0).all() and (got[2] == 0).all())
          and max_abs_diff(got[[0, 3]], flat[[3, 7]]) == 0.0,
          "out-of-range gather rows are not zero")
    kept = table.clone()
    art.scatter(kept, bad[1:3], vals[:2])
    check(max_abs_diff(kept, table) == 0.0, "out-of-range scatter wrote")
    many = torch.from_numpy(rng.integers(0, 1024, size=2000)).cuda()
    stray = torch.from_numpy(rng.random(2000) < 0.3).cuda()
    many[stray] = 1 << 30
    mine, theirs = table.clone(), table.clone()
    art.scatter(mine, many, vals[:2000])
    bg.banked_scatter_plain(theirs, many[~stray], vals[:2000][~stray], art)
    check(max_abs_diff(mine, theirs) == 0.0,
          "out-of-range writes through the winner table: the others differ")

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
        duplicates={"writes_distinct": [[1024, 64], [4096, 64], [4096, 2]],
                    "max_abs_diff": d_dup},
        scatter_elems=b2,
        large_gather={"rows": 65536, "D": 3584, "dtype": "bfloat16",
                      "T": 4096, "max_abs_diff": d_big, **timed,
                      "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "bound_by": "bytes", "bytes": nbytes})


def b2_cases(torch, gen, rng, art, flat, table):
    """B2 past one warp, each case held exactly to its plain version and to
    a sequential loop on the host (last write wins in index order): one
    write past a warp (T = 33), a full block of a thread a write (T = 128)
    over 3 addresses x 8 columns, the admit flush's 8,000 distinct pairs,
    65,536 writes over 3 addresses x 8 columns (a few blocks own them all
    and walk them in windows), and 4,096 writes over 3,000 distinct pairs
    of a table 128 wide that all fall to block 0 -- more than its hash
    holds.
    The wrapper's twins of the split (``elems_blocks``, ``pair_owner``)
    are first held to the library's, so the last case is what it says."""
    import numpy as np

    from repro_torch.kernels import banked_gather as bg

    lib = bg._library()
    for T in (1, 32, 33, 256, 257, 4096, 8000, bg.SCATTER_MAX_T):
        check(lib.bk_elems_blocks(T) == bg.elems_blocks(T),
              f"elems_blocks({T}) differs from the library's")
    keys = rng.integers(0, 1 << 40, size=512)
    for nb in (1, 7, 16, 32, 132):
        want = bg.pair_owner(keys, nb)
        check(all(lib.bk_elems_owner(int(k), nb) == w
                  for k, w in zip(keys, want)),
              f"pair_owner differs from the library's over {nb} blocks")

    wide = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, (1024, 128))
                            .astype(np.int32)).cuda()
    wide_table = art.pack(wide)
    T_over = 4096
    owned = np.flatnonzero(bg.pair_owner(
        np.arange(1024 * 128), bg.elems_blocks(T_over)) == 0)
    over_keys = rng.choice(owned, size=3000, replace=False)
    over = over_keys[np.concatenate([rng.permutation(3000), rng.integers(
        0, 3000, size=T_over - 3000)])]
    admit = (np.tile(np.arange(1000), 8), np.repeat(np.arange(8), 1000))
    few = rng.choice(1024, size=3, replace=False)
    cases = {
        "T33": (flat, table, rng.integers(0, 1024, size=33),
                rng.integers(0, 8, size=33)),
        "T128_over_3x8": (flat, table, few[rng.integers(0, 3, size=128)],
                          rng.integers(0, 8, size=128)),
        "admit8000": (flat, table, *admit),
        "65536_over_3x8": (flat, table, few[rng.integers(0, 3, size=65536)],
                           rng.integers(0, 8, size=65536)),
        "one_block_3000_pairs": (wide, wide_table, over // 128, over % 128)}
    out = {}
    for name, (fl, tab, idx, cols) in cases.items():
        T, D = len(idx), fl.shape[1]
        vals = torch.randint(-2 ** 31, 2 ** 31 - 1, (T,), generator=gen,
                             device="cuda", dtype=torch.int64).to(torch.int32)
        want = fl.cpu().numpy().copy()
        v = vals.cpu().numpy()
        for t in range(T):
            want[idx[t], cols[t]] = v[t]
        mine, theirs = tab.clone(), tab.clone()
        art.scatter(mine, idx, vals, col=cols)
        bg.banked_scatter_elems_plain(theirs, torch.from_numpy(idx).cuda(),
                                      torch.from_numpy(cols).cuda(), vals,
                                      art)
        d = max(max_abs_diff(mine, theirs), max_abs_diff(
            art.unpack(mine), torch.from_numpy(want).cuda()))
        check(d == 0.0, f"banked_scatter_elems differs on {name}: {d}")
        out[name] = {"T": T, "D": D, "distinct": len(set(zip(idx, cols))),
                     "blocks": bg.elems_blocks(T), "max_abs_diff": d}
    return out


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
    """B5 against its plain version, exactly, and one dispatch of
    olmoe's prefill size timed on random routing (the prefill's own
    routing is held and timed nowhere else)."""
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

    # prefill-sized: olmoe's prefill of 4 x 2048 tokens, routed top-8 of 64
    # at C = capacity(8192): 81,920 slots, as each of its MoE layers fills
    T, D = 8192, olmoe.d_model
    C = moe.capacity(olmoe, T)
    x = torch.randn((T, D), generator=gen, device="cuda").to(torch.bfloat16)
    slot = routed_slots(torch, rng, T, olmoe)
    x_padded = torch.cat([x, x.new_zeros((1, D))])
    d = max_abs_diff(ops.dispatch(x, slot),
                     md.moe_dispatch_plain(x_padded, slot))
    check(d == 0.0, f"prefill-sized moe_dispatch differs: {d}")
    S = slot.shape[0]
    nbytes = ((T + 1) * D + S * D) * 2 + 4 * S
    fns = (("", lambda: md.moe_dispatch(x_padded, slot)),
           ("plain_", lambda: md.moe_dispatch_plain(x_padded, slot)),
           ("library_", lambda: torch.index_select(x_padded, 0, slot)))
    timed = {f"{key}ms": time_ms(torch, fn, iters=50, stall_ms=60.0)
             for key, fn in fns}
    timed.update({f"{key}call_ms": time_ms(torch, fn, iters=50)
                  for key, fn in fns})
    say("moe_dispatch_kernel", cases=cases, max_abs_diff=worst,
        launches=dict(md.LAUNCHES),
        prefill_sized={"T": T, "D": D, "E": olmoe.n_experts, "C": C,
                       "slots": S, "empty": int((slot == T).sum()),
                       "dtype": "bfloat16", "max_abs_diff": d, **timed,
                       "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                       "bound_by": "bytes", "bytes": nbytes})


def ssd_inputs(torch, rng, B, H, Q, P, N):
    """One chunk's float32 inputs on the card, drawn as the JAX package's
    kernel tests draw them, with a carried state; in batch row 0 head 0
    dt is near 0 and in the last batch row's last head it is large (a
    decay of 500-1000 nats over 128 rows: exp of a masked entry would be
    inf there)."""
    import numpy as np

    dt = rng.uniform(0.01, 0.3, size=(B, H, Q))
    dt[0, 0] = rng.uniform(0.0, 1e-6, size=Q)
    dt[-1, -1] = rng.uniform(4.0, 8.0, size=Q)
    A = -rng.uniform(0.5, 2.0, size=(H,))
    arrays = {"x": rng.normal(size=(B, H, Q, P)), "dt": dt,
              "bm": rng.normal(size=(B, Q, N)),
              "cm": rng.normal(size=(B, Q, N)),
              "cum": np.cumsum(dt * A[None, :, None], axis=-1),
              "s_prev": rng.normal(size=(B, H, P, N))}
    return {k: torch.from_numpy(v.astype(np.float32)).cuda()
            for k, v in arrays.items()}


def ssd_held(torch, args, label):
    """B6 on ``args`` against its plain version; returns the larger of the
    two outputs' absolute errors and the larger of their errors as a share
    of the output's largest plain magnitude."""
    from repro_torch.kernels import ssd_chunk as sc

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on: the plain version would not run in float32")
    got = sc.ssd_chunk(*args)
    want = sc.ssd_chunk_plain(*args)
    err = share = 0.0
    for name, g, w in zip(("y", "s_new"), got, want):
        check(bool(torch.isfinite(g).all()), f"ssd_chunk {label}: {name} is "
              f"not finite")
        d = max_abs_diff(g, w)
        rel = d / max(float(w.abs().max()), 1e-30)
        check(rel <= SSD_TOL, f"ssd_chunk differs on {label}: {name} off by "
              f"{rel} of its largest magnitude (> {SSD_TOL})")
        err, share = max(err, d), max(share, rel)
    return err, share


SSD_ARGS = ("x", "dt", "bm", "cm", "cum", "s_prev")   # B6's argument order


def ssd_views(args, layout):
    """B6's six inputs, in its argument order, laid out as ``layout`` (one
    of ``CHUNK_LAYOUTS``) says: ``chunk_views`` of ``tests/torch_parity.py``,
    the helper the GPU tests lay the chunk out with (it imports no JAX)."""
    from torch_parity import chunk_views

    return list(chunk_views(dict(zip(SSD_ARGS, args)), layout).values())


def phase_ssd_kernel(torch, seed):
    """B6 against its plain version over chunk lengths, the (P, N) of the
    configs, a carried state, dt near 0 and large, each in the four
    ``CHUNK_LAYOUTS``: contiguous, as the chunk loop lays it out, one row
    into a longer sequence, and with x at an odd offset (one copy,
    counted); the full-width shapes are held on the prefills' own inputs
    (phase_prefill)."""
    import numpy as np

    from torch_parity import CHUNK_LAYOUTS

    from repro_torch.kernels import ssd_chunk as sc

    rng = np.random.default_rng(seed)
    worst, cases = 0.0, 0
    sc.reset_launch_counts()
    for Q in (1, 7, 16, 100, 256):
        for P, N in ((16, 16), (64, 64), (64, 128)):
            args = list(ssd_inputs(torch, rng, 2, 3, Q, P, N).values())
            for layout in CHUNK_LAYOUTS:
                views = ssd_views(args, layout)
                copies = sc.COPIES["ssd_chunk"]
                _, share = ssd_held(torch, views,
                                    f"Q={Q} P={P} N={N} {layout}")
                check(sc.COPIES["ssd_chunk"]
                      == copies + (layout == "offset view"),
                      f"B6 copies on Q={Q} P={P} N={N} {layout}: "
                      f"{sc.COPIES['ssd_chunk'] - copies}")
                worst = max(worst, share)
                cases += 1
    torch.cuda.synchronize()
    say("ssd_chunk_kernel", cases=cases, worst_share_of_max=worst,
        tolerance=f"{SSD_TOL} of max |plain|, float32, allow_tf32 off",
        launches=dict(sc.LAUNCHES), copies=dict(sc.COPIES),
        kernel=sc.kernel_info(),
        note="kernel: registers a thread, dynamic shared memory and blocks "
             "per SM, as cudaFuncGetAttributes and the occupancy "
             "calculator report them")


ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def attention_cases():
    """(label, dtype, D, B, Hkv, rep, Sq, Sk, causal, window, kv_len) of
    ``phase_attention_kernel``: per dtype and head size, one query row,
    64 rows, 1000 and 2048 rows with windows of 32 and 1024, GQA groups of
    1, 2 and 7 (7 is not a power of two), a cross attention of 64 rows over
    1500 keys, and a ``kv_len`` below ``Sk``.  The head sizes are the
    models' (64, 80, 128, 240) and 72, which the bf16 kernel takes through
    its aligned, padded copy."""
    import torch

    out = []
    for dtype in (torch.bfloat16, torch.float32):
        for D in (64, 72, 80, 128, 240):
            for (Sq, Sk, causal, window, rep, kv_len) in (
                    (1, 1, True, 0, 1, None),
                    (64, 64, False, 0, 2, None),
                    (64, 64, True, 32, 7, None),
                    (1000, 1000, True, 0, 7, None),
                    (1000, 1000, True, 32, 1, None),
                    (1000, 1000, False, 0, 1, None),
                    (2048, 2048, True, 1024, 2, None),
                    (2048, 2048, True, 0, 7, None),
                    (64, 1500, False, 0, 1, None),
                    (1000, 1000, True, 0, 2, 700),
                    (300, 1500, False, 0, 2, 1200)):
                label = (f"{str(dtype)[6:]} D={D} {Sq}x{Sk} "
                         f"{'causal' if causal else 'full'} w={window} "
                         f"rep={rep} kv_len={kv_len}")
                B = 2 if Sq < 2048 else 1
                out.append((label, dtype, D, B, 2, rep, Sq, Sk, causal,
                            window, kv_len))
    return out


def attention_inputs(torch, gen, dtype, D, B, Hkv, rep, Sq, Sk):
    """q (B, Sq, Hkv*rep, D) and k, v (B, Sk, Hkv, D), normal, on the
    card."""
    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return (draw(B, Sq, Hkv * rep, D), draw(B, Sk, Hkv, D),
            draw(B, Sk, Hkv, D))


def attention_held(torch, q, k, v, label, **kw):
    """B4 (``ops.mha``) on q, k, v against its plain version; returns the
    largest absolute error and that error as a share of the plain output's
    largest magnitude (at least 1), and fails past ``ATTN_TOL`` of the
    dtype."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on: the plain version would not run in float32")
    got = ops.mha(q, k, v, **kw)
    want = fa.mha_plain(q, k, v, **kw)
    check(bool(torch.isfinite(got.float()).all()),
          f"flash_attention {label}: output is not finite")
    d = max_abs_diff(got, want)
    share = d / max(1.0, float(want.float().abs().max()))
    tol = ATTN_TOL[str(q.dtype)[6:]]
    check(share <= tol, f"flash_attention differs on {label}: off by "
          f"{share} of max(1, max |plain|) (> {tol})")
    return d, share


def phase_attention_kernel(torch, seed):
    """B4 against its plain version on the card (``attention_cases``, then
    a bf16 q that is a view one element past an aligned base), and the
    ``(BH, S, D)`` form against the 4-D one; the full-width shapes are held
    on the prefills' own inputs (``phase_prefill``).  Exactly the bf16
    calls at D 72 and on the offset view make an aligned copy."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    worst_case = {}
    fa.reset_launch_counts()
    cases = attention_cases()
    for (label, dtype, D, B, Hkv, rep, Sq, Sk, causal, window,
         kv_len) in cases:
        q, k, v = attention_inputs(torch, gen, dtype, D, B, Hkv, rep, Sq, Sk)
        copies = fa.COPIES["flash_attention"]
        _, share = attention_held(torch, q, k, v, label, causal=causal,
                                  window=window, kv_len=kv_len)
        copied = dtype == torch.bfloat16 and D % 16 != 0
        check(fa.COPIES["flash_attention"] == copies + copied,
              f"flash_attention {label}: aligned copies "
              f"{fa.COPIES['flash_attention'] - copies}, want {int(copied)}")
        key = str(dtype)[6:]
        if share >= worst[key]:
            worst[key], worst_case[key] = share, label
        if rep == 1 and Hkv == 2:     # the JAX function's (BH, S, D) form
            fold = [t.transpose(1, 2).reshape(B * Hkv, t.shape[1], D)
                    for t in (q, k, v)]
            got = fa.flash_attention(*fold, causal=causal, window=window,
                                     kv_len=kv_len)
            want = fa.attention(q, k, v, causal=causal, window=window,
                                kv_len=kv_len)
            check(torch.equal(got, want.transpose(1, 2).reshape(
                B * Hkv, Sq, D)), f"flash_attention (BH, S, D) form "
                f"differs from the 4-D one on {label}")
    # q one element past an aligned base: TMA cannot read it as it lies
    q, k, v = attention_inputs(torch, gen, torch.bfloat16, 128, 2, 2, 7, 1000,
                               1000)
    flat = torch.zeros(q.numel() + 1, device="cuda", dtype=q.dtype)
    flat[1:] = q.reshape(-1)
    odd = flat[1:].view(q.shape)
    copies = fa.COPIES["flash_attention"]
    _, share = attention_held(torch, odd, k, v, "bfloat16 D=128 q at an odd "
                              "offset", causal=True)
    check(fa.COPIES["flash_attention"] == copies + 1,
          "the offset view of q made no aligned copy")
    if share >= worst["bfloat16"]:
        worst["bfloat16"], worst_case["bfloat16"] = share, "q at an odd offset"
    check(fa.BLIND_LAUNCHES["flash_attention"] == 0,
          "a call whose rows all see a key launched the blind-row kernel")
    blind = phase_blind_rows(torch, gen)
    torch.cuda.synchronize()
    kernel = {D: fa.kernel_info(D) for D in (64, 80, 128, 240)}
    say("attention_kernel", cases=len(cases) + 1, worst_share_of_max=worst,
        worst_case=worst_case, blind_rows=blind,
        tolerance="float32 2e-5, bfloat16 2e-2 of max(1, max |plain|); "
                  "allow_tf32 off", launches=dict(fa.LAUNCHES),
        aligned_copies=dict(fa.COPIES),
        bf16_kernel={"threads": 384, "consumer_registers": 240,
                     "producer_registers": 24, "by_head_size": kernel},
        note="bf16_kernel registers: per thread at launch, as "
             "cudaFuncGetAttributes reports them; setmaxnreg then moves "
             "them from the producer warpgroup to the two consumers")


def phase_blind_rows(torch, gen):
    """Rows that see no key (``kv_len`` 0, windows that leave the last rows
    without one; D 64, 72 and 128, both dtypes) against the plain version:
    the JAX oracle's mean of v over all keys, from ``fa_blind_rows``, after
    the attention kernel over the rows before them.  Returns the cases, the
    worst share of the tolerance and the launches of both kernels."""
    from repro_torch.kernels import flash_attention as fa

    launches = fa.LAUNCHES["flash_attention"]
    blind = fa.BLIND_LAUNCHES["flash_attention"]
    worst, cases, want_launches = 0.0, 0, 0
    for dtype in (torch.bfloat16, torch.float32):
        for D in (64, 72, 128):
            for Sq, causal, window, kv_len in ((64, True, 0, 0),
                                               (64, False, 2, 4),
                                               (1000, True, 32, 500)):
                label = (f"{str(dtype)[6:]} D={D} {Sq}x{Sq} blind rows "
                         f"w={window} kv_len={kv_len}")
                q, k, v = attention_inputs(torch, gen, dtype, D, 2, 2, 2, Sq,
                                           Sq)
                _, share = attention_held(torch, q, k, v, label,
                                          causal=causal, window=window,
                                          kv_len=kv_len)
                worst = max(worst, share / ATTN_TOL[str(dtype)[6:]])
                want_launches += fa.first_blind_row(Sq, kv_len, window) > 0
                cases += 1
    check(fa.BLIND_LAUNCHES["flash_attention"] == blind + cases
          and fa.LAUNCHES["flash_attention"] == launches + want_launches,
          "the blind-row cases launched the kernels other than once each")
    return {"cases": cases, "worst_share_of_tolerance": worst,
            "blind_launches": cases, "attention_launches": want_launches}


def attention_work(B, Sq, Sk, H, Hkv, D, causal, window, itemsize):
    """(bytes moved once, useful operations, unmasked pairs) of one
    attention call over (B, S, H, D) tensors: q, k, v read once and o
    written once; 4 D operations (the multiply-adds of q.k and of p.v) for
    every (row, key) pair the mask keeps, counted from the mask."""
    import numpy as np

    i, j = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    keep = np.ones((Sq, Sk), bool)
    if causal:
        keep &= j <= i
    if window:
        keep &= i - j < window
    pairs = int(keep.sum())
    nbytes = itemsize * B * D * (2 * Sq * H + 2 * Sk * Hkv)
    return nbytes, 4 * D * pairs * B * H, pairs


def ssd_work(B, H, Q, P, N):
    """(bytes moved once, float32 operations) of one SSD chunk call.
    The operations count C B^T once per batch row (its heads share it)
    and its causal half only, the mask's product, the (Q, Q) by (Q, P)
    product over the causal half, C S_prev^T and the state update; a
    multiply-add is two.  ``per_head`` adds C B^T for every other head,
    as the kernel (and the TPU's) forms it."""
    pairs = Q * (Q + 1) // 2
    ops = 2 * B * pairs * N + B * H * (pairs + 2 * pairs * P + 4 * Q * P * N
                                       + 2 * Q * P)
    per_head = ops + 2 * B * (H - 1) * pairs * N
    nbytes = 4 * (2 * B * H * Q * P + 2 * B * H * Q + 2 * B * Q * N
                  + 2 * B * H * P * N)
    return nbytes, ops, per_head


# ---------------------------------------------------------------------------
# Phase 3: the main paths -- the decode servers and the SSM prefills
# ---------------------------------------------------------------------------


def serve_prompts(cfg, seed, n_requests=16):
    """The prompts a served run submits: 3 to 7 random tokens each."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(2, cfg.vocab - 1, size=int(rng.integers(3, 8)))
            .astype(np.int32) for _ in range(n_requests)]


def admit_flush(prompts):
    """(positions, slots) of the records of a server's first flush after it
    admits ``prompts`` into slots 0, 1, ...: each prompt's tokens and its
    first prediction, slot-major, as ``Server._admit`` queues them."""
    import numpy as np

    return (np.concatenate([np.arange(len(p) + 1) for p in prompts]),
            np.concatenate([np.full(len(p) + 1, s)
                            for s, p in enumerate(prompts)]))


RELEASE_AFTER = 3       # ticks served from the fallback before a solve


class SolveGate:
    """Holds the port's cold solves until :attr:`event` is set, and counts
    them: for the length of a ``with`` block, ``BankingPlanner.build_space``
    -- where every solve of the plan plane starts -- waits on the event.
    It wraps the class in this script only, never in the package."""

    def __init__(self, hold):
        import threading

        from repro_torch.core import BankingPlanner

        self.cls, self.real = BankingPlanner, BankingPlanner.build_space
        self.event = threading.Event()
        if not hold:
            self.event.set()
        self.calls = 0

    def __enter__(self):
        real, gate = self.real, self

        def gated(planner, prep):
            gate.calls += 1
            gate.event.wait(120)       # a worker thread: no exit here
            return real(planner, prep)

        self.cls.build_space = gated
        return self

    def __exit__(self, *exc):
        self.event.set()
        self.cls.build_space = self.real


def store_counts(path):
    """Files of a ``DirectoryStore`` by kind."""
    names = os.listdir(path)
    sub = {d: len(os.listdir(os.path.join(path, d)))
           for d in ("certs", "telemetry", "joint")
           if os.path.isdir(os.path.join(path, d))}
    return {"plans": sum(n.endswith(".json") and ".compiled." not in n
                         for n in names),
            "compiled": sum(n.endswith(".compiled.json") for n in names),
            **sub}


def serve_once(torch, cfg, seed, store_dir, *, hold=True, joint=False,
               wait_first=False, verify="off", telemetry=False):
    """One run of the server on the card, built on a plan ticket from a new
    ``PlanService(workers=1)`` over a ``DirectoryStore`` at ``store_dir``.
    ``hold``: the cold solve waits until ``RELEASE_AFTER`` ticks were served
    from the ticket's fallback, and the server swaps to the solved layout
    itself, between ticks; ``joint``: a joint ticket over every pool of the
    model; ``wait_first``: the server is built once the ticket is done.
    Returns what the checks need."""
    import threading

    import numpy as np

    from repro_torch.core import DirectoryStore, PlanService
    from repro_torch.kernels import banked_gather as bg
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.models import get_model
    from repro_torch.runtime.server import (Request, Server, joint_ticket,
                                            page_ticket)

    max_batch, max_len, page, readers = 8, 1024, 16, 8
    n_requests, max_new = 16, 16
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    svc = PlanService(workers=1, store=DirectoryStore(store_dir),
                      verify=verify)
    hub = svc.enable_telemetry() if telemetry else None
    submit = joint_ticket if joint else page_ticket
    with SolveGate(hold) as gate:
        t_submit = time.perf_counter()
        ticket = submit(cfg, max_len, page=page, readers=readers, service=svc)
        done_at_submit = ticket.done()
        done_at = []
        waiter = threading.Thread(target=lambda: done_at.append(
            time.perf_counter() if ticket.wait(300) else None), daemon=True)
        waiter.start()
        if wait_first:
            check(ticket.wait(120), "the plan ticket did not resolve")
        t0 = time.perf_counter()
        server = Server(get_model(cfg), max_batch=max_batch, max_len=max_len,
                        kv_plan=ticket, device="cuda", generator=gen)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        first_layout = server.pager.artifact.describe()
        first_banks = server.pager.pages_per_slot

        reqs = []
        for uid, prompt in enumerate(serve_prompts(cfg, seed, n_requests)):
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
        # (positions, slots) of every flush past one warp: B2's block(s)
        flushes, flush = [], server._flush_records

        def flushing():
            if len(server._pending_records) > bg.ELEMS_WARP:
                pos, slots, _ = zip(*server._pending_records)
                flushes.append((np.array(pos), np.array(slots)))
            flush()

        server._flush_records = flushing
        # every repack of the record table, made by the server itself
        # (``_maybe_swap_kv`` / ``_swap_all``): the logical rows must
        # survive it; its wall time, the card's work included
        swap_walls, swap_identical, swap_to = [], [], server._swap_to

        def swapping(art):
            before = server._kv_art.unpack(server.kv_records).clone()
            torch.cuda.synchronize()
            t = time.perf_counter()
            swap_to(art)
            torch.cuda.synchronize()
            swap_walls.append(time.perf_counter() - t)
            after = server._kv_art.unpack(server.kv_records)
            swap_identical.append(max_abs_diff(before, after) == 0.0)

        server._swap_to = swapping

        bg.reset_launch_counts()          # the main path starts here
        md.reset_launch_counts()
        sc.reset_launch_counts()
        fa.reset_launch_counts()
        admit_ticks, on_fallback, incoherent = 0, 0, 0
        tick_ms = {"fallback": [], "solving": [], "solved": []}
        t_release = None
        t0 = time.perf_counter()
        while server.queue or server.active:
            check(server.ticks < 500, "server did not drain")
            if hold and server.ticks == RELEASE_AFTER \
                    and not gate.event.is_set():
                gate.event.set()          # the solve runs from here on
                t_release = time.perf_counter()
            stage = ("fallback" if not gate.event.is_set() else
                     "solved" if server.pager.pages_per_slot > 1
                     or ticket.done() else "solving")
            incoherent += not server.coherent
            queued, t = len(server.queue), time.perf_counter()
            server.tick()
            tick_ms[stage].append((time.perf_counter() - t) * 1e3)
            incoherent += not server.coherent
            admit_ticks += len(server.queue) < queued
            on_fallback += server.pager.pages_per_slot == 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**bg.LAUNCHES, **md.LAUNCHES, **sc.LAUNCHES,  # ends here
                    **fa.LAUNCHES,
                    **{f"banked_scatter_elems_{k}": n
                       for k, n in bg.SCATTER_ELEMS_PATHS.items()}}
    waiter.join(timeout=300)
    solve_calls = gate.calls
    if hub is not None:
        hub.flush()
    svc.shutdown()
    del server._record        # the wrappers' closures hold the server
    del server._flush_records
    del server._swap_to

    records = server._kv_art.unpack(server.kv_records).cpu().numpy()
    done = done_at[0] if done_at else None
    return {
        "server": server, "reqs": reqs, "shadow": shadow, "records": records,
        "launches": launches, "flushes": flushes,
        "admit_ticks": admit_ticks, "wall": wall,
        "init_s": init_s, "swap_identical": swap_identical,
        "swap_walls": swap_walls, "decode_calls": int(server.cache.pos),
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "first_layout": first_layout, "first_banks": first_banks,
        "layout": server.pager.artifact.describe(),
        "ticket": ticket, "hub": hub, "service": svc,
        "done_at_submit": done_at_submit, "solver_calls": solve_calls,
        "submit_to_done_s": None if done is None else done - t_submit,
        "release_to_done_s": (None if done is None or t_release is None
                              else done - t_release),
        "ticks_on_fallback": on_fallback, "incoherent": incoherent,
        "tick_ms": tick_ms, "store": store_counts(store_dir),
    }


def tick_summary(tick_ms):
    """Ticks and their median wall in ms by stage of the plan: served from
    the fallback with the solve held, while the solve runs, after it."""
    import numpy as np

    return {k: {"ticks": len(v),
                "median_ms": float(np.median(v)) if v else None}
            for k, v in tick_ms.items()}


def plan_fields(run):
    """What the plan plane did in a served run: the phase line's fields."""
    srv = run["server"]
    return {
        "swaps": srv.swaps, "promotions": srv.promotions,
        "joint_swaps": srv.joint_swaps,
        "joint_promotions": srv.joint_promotions,
        "ticks_on_fallback": run["ticks_on_fallback"],
        "ticket_done_at_submit": run["done_at_submit"],
        "solver_calls": run["solver_calls"],
        "submit_to_done_seconds": run["submit_to_done_s"],
        "release_to_done_seconds": run["release_to_done_s"],
        "swap_wall_seconds": run["swap_walls"],
        "tick_wall_by_stage": tick_summary(run["tick_ms"]),
        "served_first_from": run["first_layout"],
        "store_files": run["store"]}


def check_serve_launches(cfg, run):
    """The launch counts of a served run against its ticks, its admits,
    its repacks and its decode calls."""
    server, lau = run["server"], run["launches"]
    ticks = server.ticks
    check(lau["banked_gather"] == ticks,
          f"gather launches {lau['banked_gather']} != ticks {ticks}")
    check(lau["banked_scatter_elems"] == ticks + run["admit_ticks"],
          f"scatter_elems launches {lau['banked_scatter_elems']} != ticks "
          f"{ticks} + admitting ticks {run['admit_ticks']}")
    check(lau["banked_scatter"] == len(run["swap_walls"]),
          f"row scatter launches {lau['banked_scatter']} != "
          f"{len(run['swap_walls'])} repacks of the record table")
    moe_layers = cfg.n_layers if cfg.family == "moe" else 0
    check(lau["moe_dispatch"] == moe_layers * run["decode_calls"],
          f"moe_dispatch launches {lau['moe_dispatch']} != {moe_layers} "
          f"MoE layers x {run['decode_calls']} decode calls")
    check(lau["ssd_chunk"] == 0, f"the decode path launched the SSD chunk "
          f"kernel {lau['ssd_chunk']} times: decode runs the recurrence")
    check(lau["flash_attention"] == 0, f"the decode path launched the flash "
          f"attention kernel {lau['flash_attention']} times: the server "
          f"prefills through decode, which attends against its cache")
    check(run["decode_calls"] < 1024, "cache.pos reached max_len")


def phase_serve(torch, cfg, seed, store_dir):
    """One served model through the plan plane: a cold ticket whose solve
    is held until the server has served from the fallback, and the swap
    made by the server itself.  Returns the launches of the first run, its
    first admit flush, its tokens and the run's plan fields."""
    import numpy as np

    run = serve_once(torch, cfg, seed, store_dir)
    server, reqs = run["server"], run["reqs"]
    check(all(r.done and len(r.out) == r.max_new for r in reqs),
          "a request did not finish with max_new tokens")
    check(all(0 <= t < cfg.vocab for r in reqs for t in r.out),
          "a token is outside the vocabulary")
    check(run["first_banks"] == 1 and run["ticks_on_fallback"]
          >= RELEASE_AFTER, f"the server served {run['ticks_on_fallback']} "
          f"ticks from the fallback (at least {RELEASE_AFTER} expected)")
    check(server.swaps + server.promotions >= 1 and run["swap_identical"]
          and all(run["swap_identical"]),
          "the server did not swap, or logical records changed across a "
          "swap")
    check(server.swaps + server.promotions == len(run["swap_walls"]),
          "a swap or promotion of the server did not repack the table once")
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
    lau = run["launches"]
    check_serve_launches(cfg, run)
    by_path = {k: lau[f"banked_scatter_elems_{k}"]
               for k in ("warp", "block", "blocks")}
    past_warp = by_path["block"] + by_path["blocks"]
    check(sum(by_path.values()) == lau["banked_scatter_elems"] and
          past_warp >= 1,
          f"scatter_elems launches by path {by_path} do not add up, or no "
          f"admit flush took more than one warp")
    flushes = run["flushes"]
    first_admit = admit_flush([r.prompt for r in reqs[:8]])
    check(len(flushes) == past_warp and
          all(np.array_equal(a, b) for a, b in zip(flushes[0], first_admit)),
          "the first flush past one warp is not the first admit's records")
    tokens = [list(r.out) for r in reqs]
    first = {k: run[k] for k in ("launches", "flushes", "admit_ticks",
                                 "wall", "init_s", "decode_calls",
                                 "peak_bytes", "layout")}
    first["ticks"] = server.ticks
    plan = plan_fields(run)
    del run, server, reqs
    free_device_memory(torch)

    again_dir = store_dir + "_again"      # cold again: the same path
    os.makedirs(again_dir)
    again = serve_once(torch, cfg, seed, again_dir)
    check([list(r.out) for r in again["reqs"]] == tokens,
          "the same seed gave different tokens on the second run")
    del again
    free_device_memory(torch)
    n_tokens = sum(len(t) for t in tokens)
    say("serve", arch=cfg.name, family=cfg.family, layers=cfg.n_layers,
        d_model=cfg.d_model,
        vocab=cfg.vocab, n_experts=cfg.n_experts, top_k=cfg.top_k,
        dtype="bfloat16", max_batch=8, max_len=1024,
        requests=16, max_new=16, ticks=first["ticks"], tokens=n_tokens,
        decode_calls=first["decode_calls"],
        admitting_ticks=first["admit_ticks"],
        flush_records_past_a_warp=[len(p) for p, _ in first["flushes"]],
        wall_seconds=first["wall"], tokens_per_second=n_tokens / first["wall"],
        init_seconds=first["init_s"], launches=first["launches"],
        served_from=first["layout"], repeat_identical=True,
        peak_memory_bytes=first["peak_bytes"], **plan)
    return first["launches"], first["flushes"][0], tokens


def phase_plan_plane(torch, qwen2, olmoe, seed, store_root, cold_store,
                     tokens):
    """The plan plane's own paths, each driven with the counts set to 0
    just before it: (a) qwen2-7b on a fresh service over the store its
    served phase filled -- answered at submit, served on the solved layout
    from the first tick; (b) olmoe-1b-7b on a joint ticket over its two
    pools, every pool promoted in one coherent generation; (c) qwen2-7b
    with telemetry and certification on.  Returns the summed launches."""
    launches = {}

    def add(counts):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    # (a) a warm store: no solver call, no swap, the same tokens
    warm = serve_once(torch, qwen2, seed, cold_store, hold=False)
    srv = warm["server"]
    check(warm["done_at_submit"] and warm["solver_calls"] == 0,
          f"the warm store did not answer at submit "
          f"({warm['solver_calls']} solver calls)")
    check(warm["first_banks"] == 8 and srv.swaps + srv.promotions == 0
          and warm["launches"]["banked_scatter"] == 0,
          "the warm server did not start on the solved layout")
    check([list(r.out) for r in warm["reqs"]] == tokens[qwen2.name],
          "the warm server's tokens differ from the cold run's")
    check_serve_launches(qwen2, warm)
    add(warm["launches"])
    warm_line = {**plan_fields(warm), "launches": warm["launches"],
                 "ticks": srv.ticks}
    warm_tick = tick_summary(warm["tick_ms"])["solved"]["median_ms"]
    del warm, srv
    free_device_memory(torch)

    # (b) a joint ticket over olmoe's kv_pool and moe_dispatch
    joint_dir = os.path.join(store_root, "joint")
    os.makedirs(joint_dir)
    jr = serve_once(torch, olmoe, seed, joint_dir, joint=True)
    srv = jr["server"]
    check(set(srv.generations) == {"kv_pool", "moe_dispatch"},
          f"the joint ticket's pools are {sorted(srv.generations)}")
    check(jr["incoherent"] == 0 and srv.coherent,
          f"{jr['incoherent']} ticks saw pools of two generations")
    check(srv.joint_swaps + srv.joint_promotions >= 1,
          "the joint server never promoted its pools")
    check(jr["swap_identical"] and all(jr["swap_identical"])
          and jr["launches"]["banked_scatter"] == len(jr["swap_walls"]),
          "a joint swap that changed the KV layout did not repack the "
          "record table once, or changed its logical rows")
    check([list(r.out) for r in jr["reqs"]] == tokens[olmoe.name],
          "the joint server's tokens differ from the served olmoe run's")
    check_serve_launches(olmoe, jr)
    add(jr["launches"])
    plan = jr["ticket"].result()
    joint_line = {
        **plan_fields(jr), "launches": jr["launches"], "ticks": srv.ticks,
        "generations": dict(srv.generations), "coherent": True,
        "kv_layout_changes": len(jr["swap_walls"]),
        "layouts": {name: pool.artifact.describe()
                    for name, pool in srv.pools.items()},
        "fits": plan.fits(), "total_use": plan.total_use.as_dict()}
    joint_line["layouts"]["kv_pool"] = jr["layout"]
    del jr, srv, plan
    free_device_memory(torch)

    # (c) telemetry and certification on a served run
    tel_dir = os.path.join(store_root, "telemetry")
    os.makedirs(tel_dir)
    tr = serve_once(torch, qwen2, seed, tel_dir, hold=False,
                    wait_first=True, verify="store", telemetry=True)
    srv, hub, lau = tr["server"], tr["hub"], tr["launches"]
    check_serve_launches(qwen2, tr)
    add(lau)
    made = {"gather": lau["banked_gather"],
            "scatter": lau["banked_scatter_elems"] + lau["banked_scatter"],
            "tick": srv.ticks}
    by_op = {}
    for rec in hub.log.records():
        by_op.setdefault(rec.op, {})[rec.bucket] = {
            "count": rec.count, "p50_us": rec.p50() * 1e6}
    counted = {op: sum(b["count"] for b in by_op.get(op, {}).values())
               for op in made}
    check(counted == made, f"telemetry counted {counted} calls, the run "
          f"made {made}")
    sig = tr["ticket"].signature
    store = tr["service"].planner.store
    cert = store.certificate_path(sig, tr["ticket"].scorer_name)
    check(cert.exists(), "the served plan has no certificate in certs/")
    tel_tick = tick_summary(tr["tick_ms"])["solved"]["median_ms"]
    stats = tr["service"].stats
    tel_line = {
        **plan_fields(tr), "ticks": srv.ticks, "calls": made,
        "measured": by_op, "certificate": os.path.relpath(cert, tel_dir),
        "certified": stats.certified, "observations": stats.observations,
        "demotions": stats.demotions,
        "tick_median_ms": tel_tick, "warm_tick_median_ms": warm_tick,
        "telemetry_ms_per_tick": tel_tick - warm_tick}
    del tr, srv, hub
    free_device_memory(torch)
    say("plan_plane", warm_store=warm_line, joint=joint_line,
        telemetry=tel_line,
        note="p50s: wall per call with the card synchronised after it; "
             "telemetry_ms_per_tick: median tick with telemetry on minus "
             "the warm run's, same layout, same call")
    return launches


FLEET_WORKERS = 2       # solve workers the fleet's fabric gets
WORKER_MEMORY_BYTES = 64 << 20   # the card memory the workers may take


class FleetWatch:
    """For the length of a ``with`` block, watches every ``Server`` the
    fleet builds and holds its KV-pool solves: ``Server.tick``,
    ``_record`` and ``_swap_to`` are wrapped at class level (in this
    script only, never in the package) to time each tick, count the ticks
    that admit, shadow what each server asked to record and check the
    logical rows across each repack; ``BankingPlanner.build_space`` waits,
    for the memory ``kv_pool`` only, until every one of the ``n`` servers
    has served ``RELEASE_AFTER`` ticks from its ticket's fallback (the noise
    solves run at once), so that each server starts on the fallback and
    the swap is made by the server itself, between ticks."""

    def __init__(self, n):
        import threading

        from repro_torch.core import BankingPlanner
        from repro_torch.runtime.server import Server

        self.n, self.cls, self.planner = n, Server, BankingPlanner
        self.real = {name: getattr(Server, name)
                     for name in ("tick", "_record", "_swap_to")}
        self.real_build = BankingPlanner.build_space
        self.release = threading.Event()
        self.states = {}          # id(server) -> what was seen of it

    def state(self, server):
        import numpy as np

        st = self.states.get(id(server))
        if st is None:
            st = self.states[id(server)] = {
                "server": server, "tick_ms": [], "admit_ticks": 0,
                "fallback_ticks": 0, "swap_identical": [],
                "shadow": np.zeros((server.max_len, server.max_batch),
                                   np.int32)}
        return st

    def __enter__(self):
        import torch

        watch, real = self, self.real

        def tick(server):
            st = watch.state(server)
            queued, t = len(server.queue), time.perf_counter()
            st["fallback_ticks"] += server.pager.pages_per_slot == 1
            real["tick"](server)
            st["tick_ms"].append((time.perf_counter() - t) * 1e3)
            st["admit_ticks"] += len(server.queue) < queued
            if len(watch.states) == watch.n and all(
                    s["server"].ticks >= RELEASE_AFTER
                    or not (s["server"].queue or s["server"].active)
                    for s in watch.states.values()):
                watch.release.set()

        def record(server, slot, tok):
            pos = int(server.positions[slot])
            if pos < server.max_len:
                watch.state(server)["shadow"][pos, slot] = tok
            real["_record"](server, slot, tok)

        def swap_to(server, art):
            before = server._kv_art.unpack(server.kv_records).clone()
            real["_swap_to"](server, art)
            after = server._kv_art.unpack(server.kv_records)
            torch.cuda.synchronize()
            watch.state(server)["swap_identical"].append(
                max_abs_diff(before, after) == 0.0)

        def build_space(planner, prep):
            if prep.mem.name == "kv_pool":
                watch.release.wait(120)    # a worker thread: no exit here
            return watch.real_build(planner, prep)

        self.cls.tick, self.cls._record = tick, record
        self.cls._swap_to = swap_to
        self.planner.build_space = build_space
        return self

    def __exit__(self, *exc):
        self.release.set()
        for name, fn in self.real.items():
            setattr(self.cls, name, fn)
        self.planner.build_space = self.real_build


def phase_fleet(torch, seed):
    """The fleet: ``serve_fleet.main`` as a user runs it with ``--fabric``
    -- interactive, batch and best-effort tenants serving qwen2-7b,
    olmoe-1b-7b and mamba2-370m at full width on threads, on one card,
    over one ``PlanService`` and one ``SolveFabric`` with two port workers
    from ``spawn_local_workers``, six cold noise solves of the batch tenant
    first.  The fabric is opened here and handed in, so that the card's
    free memory can be read around the workers' attach.  Checks: every
    ticket done, fabric solves with no fallback, the slices summing to the
    global counters, each record table equal to what its server recorded
    (across every repack), the launch counts against the ticks, tokens
    equal to each server run alone on the pool, under 64 MB of card memory
    taken by the workers, no worker left once the fabric is shut down.
    Returns the fleet's launches."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.core import PlanService, SolveFabric, spawn_local_workers
    from repro_torch.kernels import banked_gather as bg
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.launch import serve_fleet
    from repro_torch.runtime.tenancy import TenantRegistry

    fleet = serve_fleet.DEFAULT_FLEET
    free_device_memory(torch)
    torch.cuda.synchronize()
    free_before = torch.cuda.mem_get_info()[0]
    fabric = SolveFabric()
    t0 = time.perf_counter()
    procs = spawn_local_workers(fabric.address, FLEET_WORKERS)
    try:
        check(fabric.wait_for_workers(FLEET_WORKERS, timeout=120),
              f"{FLEET_WORKERS} solve workers did not attach in 120 s")
        attach_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        free_after = torch.cuda.mem_get_info()[0]
        worker_bytes = free_before - free_after
        check(abs(worker_bytes) < WORKER_MEMORY_BYTES,
              f"the card's free memory moved by {worker_bytes} bytes while "
              f"the solve workers attached: a worker opened a context")

        argv = ["--device", "cuda", "--seed", str(seed), "--fabric"]
        with FleetWatch(len(fleet)) as watch:
            bg.reset_launch_counts()          # the fleet's path starts here
            md.reset_launch_counts()
            sc.reset_launch_counts()
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                out = serve_fleet.main(argv, fabric=fabric)
            except SystemExit as e:
                fail(f"serve_fleet: {e}")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {**bg.LAUNCHES, **md.LAUNCHES, **sc.LAUNCHES,
                        **fa.LAUNCHES,                   # and ends here
                        **{f"banked_scatter_elems_{k}": n
                           for k, n in bg.SCATTER_ELEMS_PATHS.items()}}
        check(fabric.workers_alive == FLEET_WORKERS,
              "a solve worker was lost during the fleet's run")
        fabric_stats = dataclasses.asdict(fabric.stats)
    finally:
        fabric.shutdown()
        left = []
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                left.append(p.pid)
                p.kill()
                p.wait()
    check(not left, f"solve workers {left} were alive 30 s after the "
          f"fabric shut down")

    stats, slices = out["stats"], out["slices"]
    check(stats.get("fabric_solves", 0) >= 1
          and stats.get("fabric_leases", 0) > 0
          and stats.get("fabric_fallbacks", 0) == 0,
          f"fabric solves {stats.get('fabric_solves')}, leases "
          f"{stats.get('fabric_leases')}, fallbacks "
          f"{stats.get('fabric_fallbacks')}")
    mismatched = [k for k, v in stats.items()
                  if v != sum(s.get(k, 0) for s in slices.values())]
    check(not mismatched, f"tenant slices do not sum on {mismatched}")
    check(all(t.done() for t in out["noise"]), "a noise ticket is not done")

    expect = {"banked_gather": 0, "banked_scatter_elems": 0,
              "banked_scatter": 0, "moe_dispatch": 0}
    tenants = {}
    for offset, (name, _, arch) in enumerate(fleet):
        res, srv = out["results"][name], out["servers"][name]
        reqs, st = out["requests"][name], watch.states[id(srv)]
        cfg = srv.cfg
        check(res["ticket_status"] == "done", f"{name}'s ticket is "
              f"{res['ticket_status']}")
        check(all(r.done and len(r.out) == r.max_new for r in reqs),
              f"a request of {name} did not finish with max_new tokens")
        records = srv._kv_art.unpack(srv.kv_records).cpu().numpy()
        check(np.array_equal(records, st["shadow"]),
              f"{name}'s record table differs from what it recorded")
        check(all(st["swap_identical"]) and len(st["swap_identical"])
              == srv.swaps + srv.promotions,
              f"{name}: logical records changed across a repack, or a "
              f"swap did not repack once")
        check(st["fallback_ticks"] >= RELEASE_AFTER,
              f"{name} served {st['fallback_ticks']} ticks from the "
              f"fallback (at least {RELEASE_AFTER} expected)")
        decode_calls = int(srv.cache.pos)
        expect["banked_gather"] += srv.ticks
        expect["banked_scatter_elems"] += srv.ticks + st["admit_ticks"]
        expect["banked_scatter"] += len(st["swap_identical"])
        if cfg.family == "moe":
            expect["moe_dispatch"] += cfg.n_layers * decode_calls
        tenants[name] = {
            **res, "promotions": srv.promotions, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "max_len": srv.max_len,
            "decode_calls": decode_calls, "admitting_ticks": st["admit_ticks"],
            "ticks_on_fallback": st["fallback_ticks"],
            "tick_ms_median": float(np.median(st["tick_ms"])),
            "tokens": [list(map(int, r.out)) for r in reqs]}
    for name, want in expect.items():
        check(launches[name] == want, f"fleet {name} launches "
              f"{launches[name]} != {want} from the servers' ticks, admits, "
              f"repacks and decode calls")
    check(launches["ssd_chunk"] == 0 and launches["flash_attention"] == 0,
          f"the fleet's decode path launched {launches['ssd_chunk']} SSD "
          f"chunks and {launches['flash_attention']} flash attentions")
    check(expect["banked_scatter"] >= 1, "no server of the fleet swapped")
    service = out["service"]
    del out, watch, srv, reqs, st
    free_device_memory(torch)

    # each server alone, on the pool, same settings and seed (its solve
    # held as in the fleet, so that it swaps alike)
    for offset, (name, qos, arch) in enumerate(fleet):
        registry = TenantRegistry()
        registry.register(name, qos)
        svc = PlanService(workers=2, tenants=registry)
        try:
            with FleetWatch(1) as watch:
                res, srv, reqs = serve_fleet.run_tenant(
                    svc, name, arch, offset, seed=seed, device="cuda")
        finally:
            svc.shutdown()
        solo = [list(map(int, r.out)) for r in reqs]
        check(solo == tenants[name]["tokens"], f"{name}'s fleet tokens "
              f"{tenants[name]['tokens']} differ from its solo run's {solo}")
        tenants[name]["solo"] = {
            "ticks": srv.ticks, "serve_s": res["serve_s"],
            "swaps": srv.swaps, "promotions": srv.promotions,
            "tick_ms_median": float(np.median(
                watch.states[id(srv)]["tick_ms"]))}
        del srv, reqs, watch
        free_device_memory(torch)
    say("fleet", tenants=tenants, wall_seconds=wall,
        workers=FLEET_WORKERS, worker_attach_seconds=attach_s,
        worker_card_bytes=worker_bytes, launches=launches,
        service={k: v for k, v in stats.items() if v},
        fabric=fabric_stats, solo_tokens_equal=True,
        workers_left=0, slice_reconciliation="exact",
        note="tick_ms_median: host wall of a tick (its decode calls, a "
             "prompt fed through decode one token a call), in the fleet "
             "three servers sharing one interpreter and one card; solo: "
             "the same server alone on the pool")
    del service
    return launches


VARIANT_TOL = (0.05, 0.02)       # atol, rtol: tests/test_perf_variants.py
# At gemma3-12b's width the reference's bound is out of reach for the dense
# decode itself: the same step with its attention reduced in another order
# (one 2048-key block instead of the one-shot decode einsum) moves the
# logits past it, by up to 0.03 over six layers and 0.27 over 48 (bf16
# rounding flips that the random network amplifies layer by layer;
# scripts/ring_spread.py).  The
# ring is held to that spread, measured in the same run on the same
# inputs: its largest difference from the dense decode may be at most
# RING_SPREAD times the dense decode's own, where a wrong slot or mask
# moves the logits by their own scale (std ~1.2), some 20 times it.
RING_SPREAD = 2.0
QUANT_SOFTMAX_TOL = 0.05


def variant_step(torch, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def bound_excess(a, b, atol, rtol):
    """How far ``b`` lies past ``|a - b| <= atol + rtol |a|`` (<= 0: within)."""
    a, b = a.float(), b.float()
    return float(((a - b).abs() - (atol + rtol * a.abs())).max())


def ring_history(torch, cfg, gen, batch, max_len, history):
    """A ``KVCache`` of ``max_len`` rows and a ``GroupedKVCache`` on the card
    holding one random bf16 K/V history of ``history`` positions (drawn
    from ``gen``, layer by layer), both at ``pos = history``: the full
    buffers hold every position, each ring the last W in slots ``pos mod
    W``, each global buffer every position."""
    from repro_torch.models import transformer as tfm

    G, R = tfm.grouped_layout(cfg)
    W = cfg.sliding_window
    full = tfm.init_cache(cfg, batch, max_len, device="cuda")
    ring = tfm.init_grouped_cache(cfg, batch, max_len, device="cuda")
    keep = torch.arange(history - W, history, device="cuda")
    slots = torch.remainder(keep, W)
    shape = (batch, history, cfg.n_kv_heads, cfg.hd)
    for i in range(cfg.n_layers):
        g, r = divmod(i, R + 1)
        for buf, local, glob in ((full.k, ring.k_local, ring.k_global),
                                 (full.v, ring.v_local, ring.v_global)):
            kv = torch.randn(shape, generator=gen, device="cuda",
                             dtype=torch.float32).to(torch.bfloat16)
            buf[i, :, :history] = kv
            if r < R:
                local[g, r][:, slots] = kv[:, keep]
            else:
                glob[g][:, :history] = kv
    return full._replace(pos=history), ring._replace(pos=history)


def phase_decode_variants(torch, gemma3, qwen2, seed, history=1100,
                          steps=8, quant_steps=16):
    """The dense transformer's two decode variants at full width.
    gemma3-12b, B 2: one random bf16 K/V history of ``history`` positions
    in a ``KVCache`` (max_len 1152) and in a ``GroupedKVCache`` (the ring
    has wrapped: positions 76-1099 in slots ``pos mod 1024``), then
    ``steps`` steps of ``decode_step`` and ``grouped_decode_step``, each fed
    the full path's argmax, beside ``decode_step`` with another attention
    reduction order (``block_k`` 2048) on a copy of the cache: layer 0's
    ring rows equal the dense buffer's rows of the positions the ring keeps,
    bit for bit, at every step (its inputs are the same in both paths),
    and the logits' largest difference from the dense decode stays within
    ``RING_SPREAD`` times the dense decode's own across the run; the
    excess over the reference's bound (atol 0.05, rtol 0.02) is printed
    for both.  qwen2-7b, B 4: ``quant_steps`` steps of ``decode_step_quant``
    beside ``decode_step`` from empty caches of 1024, the softmax held
    within 0.05.  Prints both caches' bytes and the median step time of
    each path (host wall, the card synchronised)."""
    import numpy as np

    from repro_torch.kernels import banked_gather as bg
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.models import get_model
    from repro_torch.models import transformer as tfm

    def nbytes(cache):
        return sum(t.numel() * t.element_size() for t in cache
                   if isinstance(t, torch.Tensor))

    for mod in (bg, md, sc, fa):
        mod.reset_launch_counts()
    free_device_memory(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    B, max_len = 2, 1152
    G, R = tfm.grouped_layout(gemma3)
    W = gemma3.sliding_window
    params = get_model(gemma3).init(gen, device="cuda")
    full, ring = ring_history(torch, gemma3, gen, B, max_len, history)
    twin = tfm.KVCache(full.k.clone(), full.v.clone(), history)
    tok = torch.randint(2, gemma3.vocab - 1, (B, 1), generator=gen,
                        device="cuda", dtype=torch.int32)
    ms_full, ms_ring, ring_diff, twin_diff = [], [], [], []
    ring_excess, twin_excess = [], []
    atol, rtol = VARIANT_TOL
    for step in range(steps):
        (lf, full), t_f = variant_step(
            torch, lambda: tfm.decode_step(gemma3, params, full, tok))
        (lr, ring), t_r = variant_step(
            torch, lambda: tfm.grouped_decode_step(gemma3, params, ring, tok))
        lt, twin = tfm.decode_step(gemma3, params, twin, tok, block_k=2048)
        ms_full.append(t_f)
        ms_ring.append(t_r)
        check(all(bool(torch.isfinite(x).all()) for x in (lf, lr, lt)),
              f"gemma3-12b logits not finite at step {step}")
        ring_diff.append(float((lf.float() - lr.float()).abs().max()))
        twin_diff.append(float((lf.float() - lt.float()).abs().max()))
        ring_excess.append(bound_excess(lf, lr, atol, rtol))
        twin_excess.append(bound_excess(lf, lt, atol, rtol))
        pos = full.pos - 1 - torch.arange(W, device="cuda")  # what it keeps
        for got, want in ((ring.k_local[0, 0], full.k[0]),
                          (ring.v_local[0, 0], full.v[0])):
            check(torch.equal(got[:, torch.remainder(pos, W)], want[:, pos]),
                  f"gemma3-12b ring rows of layer 0 differ from the dense "
                  f"buffer's at step {step}")
        tok = lf.argmax(-1).to(torch.int32)[:, None]
    check(max(ring_diff) <= RING_SPREAD * max(twin_diff),
          f"gemma3-12b ring decode differs from the dense decode by "
          f"{max(ring_diff)}, past {RING_SPREAD} x the dense decode's own "
          f"spread {max(twin_diff)} (per step: ring {ring_diff}, dense "
          f"{twin_diff})")
    grouped = {"arch": gemma3.name, "layers": gemma3.n_layers,
               "groups": G, "locals_per_group": R, "window": W,
               "batch": B, "max_len": max_len, "history": history,
               "steps": steps, "ring_slot_of_last": tfm.ring_slot(
                   history + steps - 1, W),
               "max_abs_logit_diff": ring_diff,
               "dense_reordered_max_abs_logit_diff": twin_diff,
               "reference_bound_excess": ring_excess,
               "dense_reordered_reference_bound_excess": twin_excess,
               "layer0_ring_rows_equal": True,
               "full_cache_bytes": nbytes(full),
               "grouped_cache_bytes": nbytes(ring),
               "full_step_ms_median": float(np.median(ms_full)),
               "grouped_step_ms_median": float(np.median(ms_ring))}
    del params, full, ring, twin, lf, lr, lt
    free_device_memory(torch)

    B, max_len = 4, 1024
    params = get_model(qwen2).init(gen, device="cuda")
    full = tfm.init_cache(qwen2, B, max_len, device="cuda")
    quant = tfm.init_quant_cache(qwen2, B, max_len, device="cuda")
    tok = torch.randint(2, qwen2.vocab - 1, (B, 1), generator=gen,
                        device="cuda", dtype=torch.int32)
    worst, ms_full, ms_quant = 0.0, [], []
    for step in range(quant_steps):
        (lf, full), t_f = variant_step(
            torch, lambda: tfm.decode_step(qwen2, params, full, tok))
        (lq, quant), t_q = variant_step(
            torch, lambda: tfm.decode_step_quant(qwen2, params, quant, tok))
        ms_full.append(t_f)
        ms_quant.append(t_q)
        diff = float((torch.softmax(lf.float(), -1)
                      - torch.softmax(lq.float(), -1)).abs().max())
        worst = max(worst, diff)
        check(diff < QUANT_SOFTMAX_TOL, f"qwen2-7b int8 decode's softmax "
              f"differs by {diff} at step {step}")
        tok = lf.argmax(-1).to(torch.int32)[:, None]
    quant_line = {"arch": qwen2.name, "layers": qwen2.n_layers, "batch": B,
                  "max_len": max_len, "steps": quant_steps,
                  "max_softmax_diff": worst,
                  "full_cache_bytes": nbytes(full),
                  "int8_cache_bytes": nbytes(quant),
                  "full_step_ms_median": float(np.median(ms_full)),
                  "int8_step_ms_median": float(np.median(ms_quant))}
    del params, full, quant, lf, lq
    free_device_memory(torch)
    launches = {**bg.LAUNCHES, **md.LAUNCHES, **sc.LAUNCHES, **fa.LAUNCHES}
    say("decode_variants", grouped=grouped, int8=quant_line,
        launches=launches,
        note="step ms: host wall of one decode step, the card "
             "synchronised before and after; both paths attend through "
             "the eager chunked attention, no kernel of this repo")


def phase_profile(torch, cfg, seed, ticks=8):
    """Optional (``--profile``): where a steady decode tick's time goes,
    with all 8 slots active.  Wall time per tick from ``ticks`` ticks with
    the profiler off; then ``torch.profiler`` over as many ticks for the
    card's busy time (hence its idle share), the kernels that take most of
    it, and the port's own kernels' share of it."""
    import numpy as np
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
    busy_ms, launches, top, own = device_kernels(prof)
    say("profile", arch=cfg.name, layers=cfg.n_layers, ticks=ticks, slots=8,
        wall_ms_per_tick=wall_ms / ticks, device_busy_ms_per_tick=busy_ms / ticks,
        device_idle_share=max(0.0, 1 - busy_ms / wall_ms),
        device_launches_per_tick=launches / ticks,
        top_kernels=top, own_kernels=own,
        note="wall time from the same number of ticks with the profiler off")
    del server
    free_device_memory(torch)


DECODE_AFTER_PREFILL = 4


def ssm_layers(cfg):
    """How many Mamba2 blocks the model runs: the hybrid stacks them
    ``(G, per)``, which leaves out the remainder of ``n_layers / G``."""
    from repro_torch.models import hybrid

    if cfg.family != "hybrid":
        return cfg.n_layers
    G = hybrid.n_sites(cfg)
    return G * (cfg.n_layers // G)


def attention_calls(cfg):
    """B4 launches of one prefill: one per attention layer; whisper's
    encoder layers one each and its decoder layers two each (self and
    cross); the hybrid's shared block one per site; none for the SSM."""
    from repro_torch.models import hybrid

    if cfg.family in ("encdec", "audio"):
        return (cfg.n_encoder_layers or cfg.n_layers) + 2 * cfg.n_layers
    if cfg.family == "hybrid":
        return hybrid.n_sites(cfg)
    if cfg.family == "ssm":
        return 0
    return cfg.n_layers


def prefill_once(torch, model, params, batch, max_len, capture=None):
    """One prefill of ``batch`` (tokens, and frames for whisper) through
    ``launch.steps.make_prefill_step`` and ``DECODE_AFTER_PREFILL`` decode
    steps on from its cache through ``make_serve_step``.  ``capture`` (a
    dict) receives clones of kernel inputs: under ``"ssd_chunk"`` those of
    the first two SSD chunk calls, under ``"attention"`` those of the first
    attention call of each shape and mask, with the count of its calls."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import ssm as ssm_mod

    cfg = model.cfg
    B, S = batch["tokens"].shape
    prefill = make_prefill_step(model, max_len)
    serve = make_serve_step(model)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    chunk, mha = ssm_mod.ssd_chunk, ops.mha
    if capture is not None:
        chunks = capture.setdefault("ssd_chunk", [])
        shapes = capture.setdefault("attention", {})

        def capturing_chunk(*args):
            if len(chunks) < 2:              # the inputs, not the out view
                chunks.append([a.clone() for a in args[:6]])
            return chunk(*args)

        def capturing_mha(q, k, v, **kw):
            key = (tuple(q.shape), tuple(k.shape), kw.get("causal", True),
                   int(kw.get("window", 0)))
            if key not in shapes:
                shapes[key] = {"args": [t.clone() for t in (q, k, v)],
                               "kw": dict(kw), "calls": 0}
            shapes[key]["calls"] += 1
            return mha(q, k, v, **kw)

        ssm_mod.ssd_chunk, ops.mha = capturing_chunk, capturing_mha
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in (sc, fa, md):              # the main path starts here
        mod.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        start.record()
        logits, cache = prefill(params, batch)
        stop.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ssm_mod.ssd_chunk, ops.mha = chunk, mha
    launches = {**sc.LAUNCHES, **fa.LAUNCHES, **md.LAUNCHES}
    check(fa.COPIES["flash_attention"] == 0, f"{cfg.name} prefill: "
          f"{fa.COPIES['flash_attention']} aligned copies before B4")
    check(fa.BLIND_LAUNCHES["flash_attention"] == 0, f"{cfg.name} prefill "
          f"launched the blind-row kernel")
    check(sc.COPIES["ssd_chunk"] == 0, f"{cfg.name} prefill: "
          f"{sc.COPIES['ssd_chunk']} copies in front of B6")
    check(tuple(logits.shape) == (B, cfg.vocab)
          and bool(torch.isfinite(logits.float()).all()),
          f"{cfg.name} prefill: logits are not finite (B, vocab)")
    nxt = logits.float().argmax(-1).to(torch.int32)[:, None]
    out = [nxt[:, 0]]
    for _ in range(DECODE_AFTER_PREFILL):
        nxt, logits, cache = serve(params, cache, nxt)
        check(bool(torch.isfinite(logits.float()).all()),
              f"{cfg.name}: decode after prefill gave non-finite logits")
        out.append(nxt[:, 0])
    torch.cuda.synchronize()
    moe_layers = cfg.n_layers if cfg.family == "moe" else 0
    check(sc.LAUNCHES["ssd_chunk"] == launches["ssd_chunk"]   # ... and ends
          and fa.LAUNCHES["flash_attention"] == launches["flash_attention"]
          and md.LAUNCHES["moe_dispatch"] == launches["moe_dispatch"]
          + moe_layers * DECODE_AFTER_PREFILL,
          f"{cfg.name}: decode after prefill launched the SSD chunk or the "
          f"flash attention kernel, or not one MoE dispatch a layer a step")
    check(int(cache.pos) == S + DECODE_AFTER_PREFILL, "cache.pos is off")
    return {"tokens": torch.stack(out, 1).cpu().tolist(),
            "launches": launches, "wall": wall,
            "event_ms": start.elapsed_time(stop),
            "peak_bytes": torch.cuda.max_memory_allocated()}


def check_prefill_launches(cfg, S, launches, capture=None):
    """A prefill's launches against what its layers imply: B4 once per
    attention call, B6 once per SSM layer and chunk, B5 once per MoE
    layer."""
    import math

    want = {"flash_attention": attention_calls(cfg),
            "moe_dispatch": cfg.n_layers if cfg.family == "moe" else 0,
            "ssd_chunk": 0}
    if cfg.family in ("ssm", "hybrid"):
        want["ssd_chunk"] = ssm_layers(cfg) * math.ceil(
            S / min(cfg.ssm_chunk, S))
    check(launches == want, f"{cfg.name} prefill of {S}: launches "
          f"{launches} != {want}")
    if capture is not None:
        calls = sum(c["calls"] for c in capture["attention"].values())
        check(calls == want["flash_attention"], f"{cfg.name}: {calls} calls "
              f"of ops.mha != {want['flash_attention']} B4 launches")


def attention_rows(cfg, capture):
    """(label, (q, k, v), kwargs, calls, (err, share)) of each attention
    shape the prefill gave B4, as ``phase_kernel_times`` times them: all of
    them except whisper's decoder calls (its encoder's shape is the large
    one).  Every shape, these and the others, is held against the plain
    version in ``phase_prefill``."""
    rows = []
    for (qs, ks, causal, window), c in capture["attention"].items():
        if cfg.family in ("encdec", "audio") and causal:
            continue                 # the decoder's self attention
        if cfg.family in ("encdec", "audio") and qs[1] != ks[1]:
            continue                 # and its cross attention
        label = cfg.name
        if cfg.sliding_window:
            label += " local" if window else " global"
        if cfg.family in ("encdec", "audio"):
            label += " encoder"
        rows.append((label, c["args"], c["kw"], c["calls"], c["held"]))
    return rows


def profile_prefill(torch, model, params, batch, max_len, label):
    """One prefill alone under ``torch.profiler`` after a warm-up: the
    card's busy time, its idle share, the kernels that take most of it and
    the port's own kernels' share."""
    from torch.profiler import ProfilerActivity, profile as profiler

    from repro_torch.launch.steps import make_prefill_step

    prefill = make_prefill_step(model, max_len)
    prefill(params, batch)                                 # warm
    torch.cuda.synchronize()
    with profiler(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, n, top, own = device_kernels(prof)
    B, S = batch["tokens"].shape
    say("prefill_profile", arch=model.cfg.name, batch=B, seq=S,
        prompt=label, device_busy_ms=busy_ms, device_launches=n,
        wall_ms_profiled=wall_ms,
        device_idle_share=max(0.0, 1 - busy_ms / wall_ms),
        top_kernels=top, own_kernels=own,
        note="one prefill alone; its wall time taken under the "
             "profiler, which slows the host")


def phase_prefill(torch, cfg, batch, seqs, seed, frames=0, max_len=None,
                  profile=False):
    """A model's prefill at full width: ``batch`` prompts of each length in
    ``seqs`` (whisper: over ``frames`` random frame embeddings), each run
    twice and decoding ``DECODE_AFTER_PREFILL`` steps on from a cache
    ``max_len`` long (default: just long enough); checked for finite
    logits, for its launches (``check_prefill_launches``) and for identical
    tokens when repeated, and timed.  The first call of each attention
    shape and the first two SSD chunk calls of every length are held
    against the kernels' plain versions on their own inputs.  Returns the
    launches of the first runs, the inputs of the second SSD chunk call of
    the first length (a carried state; SSM families), its attention rows
    for the kernels' timing, and B6's worst error (a share of max |plain|)
    on each length's captured chunks."""
    from repro_torch.models import get_model

    model = get_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init(gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    launches, captured, rows, first_data = {}, [], [], None
    held_by_len = {}                  # prompt length -> B6's worst share
    attends = attention_calls(cfg) > 0
    for S in seqs:
        data = {"tokens": torch.randint(
            2, cfg.vocab - 1, (batch, S), generator=gen, device="cuda",
            dtype=torch.int64).to(torch.int32)}
        if frames:
            data["frames"] = torch.randn((batch, frames, cfg.d_model),
                                         generator=gen, device="cuda")
        length = max_len or S + DECODE_AFTER_PREFILL
        capture = {}
        first = prefill_once(torch, model, params, data, length, capture)
        check_prefill_launches(cfg, S, first["launches"], capture)
        again = prefill_once(torch, model, params, data, length)
        check(again["tokens"] == first["tokens"],
              f"{cfg.name} prefill of {S}: the repeat gave other tokens")
        for k, n in first["launches"].items():
            launches[k] = launches.get(k, 0) + n
        held = None                   # the kernels on the prefill's own inputs
        if capture["ssd_chunk"]:
            held = max(ssd_held(torch, args, f"{cfg.name} {S} chunk {i}")[1]
                       for i, args in enumerate(capture["ssd_chunk"]))
            held_by_len[S] = held
        for (qs, ks, causal, window), c in capture["attention"].items():
            c["held"] = attention_held(
                torch, *c["args"], f"{cfg.name} {S} q {qs} k {ks} "
                f"causal={causal} window={window}", **c["kw"])
        if first_data is None:
            first_data = (data, length)
            if capture["ssd_chunk"]:
                captured = capture["ssd_chunk"][1]
            rows = attention_rows(cfg, capture)
        say("prefill", arch=cfg.name, family=cfg.family, layers=cfg.n_layers,
            d_model=cfg.d_model,
            heads=[cfg.n_heads, cfg.n_kv_heads] if attends else None,
            head_dim=cfg.hd if attends else None,
            dtype="bfloat16", batch=batch, seq=S,
            frames=frames or None, max_len=length,
            chunk=min(cfg.ssm_chunk, S) if cfg.ssm_state else None,
            launches=first["launches"],
            attention_shapes=[{"q": list(k[0]), "k": list(k[1]),
                               "causal": k[2], "window": k[3],
                               "calls": c["calls"],
                               "held_share_of_max": c["held"][1]}
                              for k, c in capture["attention"].items()],
            decode_steps=DECODE_AFTER_PREFILL, repeat_identical=True,
            first_tokens=first["tokens"][0],
            wall_seconds=first["wall"], event_ms=first["event_ms"],
            repeat_wall_seconds=again["wall"],
            repeat_event_ms=again["event_ms"],
            tokens_per_second=batch * S / again["wall"],
            peak_memory_bytes=first["peak_bytes"], init_seconds=init_s,
            captured_chunks_share_of_max=held,
            note="event_ms: CUDA events around the prefill on its stream")
        del capture
    if profile:
        profile_prefill(torch, model, params, *first_data,
                        f"{seqs[0]} tokens a row")
    del params, model, first_data
    free_device_memory(torch)
    return launches, captured, rows, held_by_len


def phase_silu_cost(torch, cfg, batch):
    """Optional (``--profile``): what the Mamba2 block's ``_silu`` (silu
    written out op by op, each rounded in bfloat16, as XLA rounds it on the
    CPU) costs beside ``F.silu`` on the card.  Each block calls it twice:
    on the conv output (``conv_dim`` wide) and on the gate (``d_inner``).
    Launches from the profiler; ms on the card from CUDA events behind a
    stall, and host-inclusive ms per call at decode (8 slots); the prefill
    at ``batch`` x 2048 tokens, as ``phase_prefill`` runs it."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import ssm as ssm_mod

    d_inner, _, _, N = ssm_mod.dims(cfg)
    widths = (d_inner + 2 * N, d_inner)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def inputs(b, rows):
        return [torch.randn((b, rows, w), generator=gen, device="cuda",
                            dtype=torch.bfloat16) * 4 for w in widths]

    def launches(fn, xs, reps=50):
        # fifty calls a window: windows of a dozen, and once of ten,
        # decode-sized launches came back from the profiler without their
        # device events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for x in xs:
                    fn(x)
            torch.cuda.synchronize()
        return device_kernels(prof)[1] / reps

    out = {}
    for where, b, rows in (("decode", 8, 1), ("prefill", batch, 2048)):
        xs = inputs(b, rows)
        row = {"launches": {}, "card_ms": {}, "call_ms": {}}
        for name, fn in (("_silu", ssm_mod._silu), ("F.silu", F.silu)):
            row["launches"][name] = launches(fn, xs)
            row["card_ms"][name] = sum(time_ms(torch, lambda: fn(x), iters=50,
                                               warmup=5, stall_ms=60.0)
                                       for x in xs)
            if rows == 1:
                row["call_ms"][name] = sum(time_ms(torch, lambda: fn(x))
                                           for x in xs)
        row["max_abs_diff"] = max(max_abs_diff(ssm_mod._silu(x), F.silu(x))
                                  for x in xs)
        blocks = ssm_layers(cfg)
        row["extra_launches"] = blocks * (row["launches"]["_silu"]
                                          - row["launches"]["F.silu"])
        row["extra_card_ms"] = blocks * (row["card_ms"]["_silu"]
                                         - row["card_ms"]["F.silu"])
        if rows == 1:
            row["extra_call_ms"] = blocks * (row["call_ms"]["_silu"]
                                             - row["call_ms"]["F.silu"])
        out[where] = {"batch": b, "rows": rows, **row}
        del xs
    say("silu_cost", arch=cfg.name, widths=list(widths),
        blocks=ssm_layers(cfg), **out,
        note="launches, card_ms and call_ms are for the block's two silu "
             "calls; extra_* are over all blocks of one decode tick of 8 "
             "slots or one prefill of 2048 tokens a row")
    free_device_memory(torch)


def device_kernels(prof):
    """(busy ms, launches, the 8 kernels that took most time, the port's
    own kernels with their share of busy) from a profiler's device
    events."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    check(by_name, "the profiler recorded no device activity")
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    own = {k: {"launches": n, "ms": us / 1e3,
               "share_of_busy": us / 1e3 / busy_ms}
           for k, (n, us) in by_name.items()
           if "bk_" in k or "md_dispatch" in k or "sc_ssd" in k
           or "fa_kernel" in k or "fa_hopper" in k}
    return (busy_ms, sum(n for n, _ in by_name.values()),
            [{"name": k[:80], "launches": n, "ms": us / 1e3}
             for k, (n, us) in top], own)


# ---------------------------------------------------------------------------
# Phase 4: each kernel at the main path's shapes, beside its yardsticks
# ---------------------------------------------------------------------------


def used_ptxas(banked, kernel, source):
    """The ``-Xptxas -v`` properties of ``kernel``'s instantiations for the
    program source ``source`` (one per element size for B2)."""
    return {k: v for k, v in banked.items()
            if k.startswith(kernel + "<") and k.endswith(source + ">")}


def resolve_ops(art, T):
    """Integer operations of T resolves as the kernels run the artifact's
    packed program: four a term of a sum of terms and two for the range,
    else one an instruction, two a dimension's split and two a bank fold."""
    from repro_torch.core import transforms
    from repro_torch.kernels import banked_gather as bg

    w = bg.program_words(art)
    terms = int(w[transforms.kernel_program_words(int(w[7]))
                  - transforms.KERNEL_TERMS_WORDS])
    if terms:
        return T * (4 * terms + 2)
    return T * (int(w[0]) + 2 * int(w[2]) + 2 * int(w[3]))


ROUNDS = 15


def interleaved_rounds(torch, phase, kernel, library, library_name,
                       **fields):
    """A kernel beside one PyTorch call in ``ROUNDS`` interleaved rounds
    (the order alternating), each timing 50 calls of one behind a 60 ms
    stall: near the launch floor the two lie a few per cent apart, within
    what one timing spreads.  Prints the medians, ranges and the ratio of
    every round; the verdict is "faster" or "slower" only where every
    round's ratio says so, else "unresolved".  Returns the summary."""
    import numpy as np

    ms = {"kernel": [], library_name: []}
    fns = {"kernel": kernel, library_name: library}
    for r in range(ROUNDS):
        for name in (("kernel", library_name) if r % 2
                     else (library_name, "kernel")):
            ms[name].append(time_ms(torch, fns[name], iters=50, warmup=10,
                                    stall_ms=60.0))
    ratio = np.array(ms["kernel"]) / np.array(ms[library_name])
    verdict = ("faster" if (ratio < 1).all() else
               "slower" if (ratio > 1).all() else "unresolved")
    out = {f"{k}_ms": {"median": float(np.median(v)), "min": min(v),
                       "max": max(v)} for k, v in ms.items()}
    out["ratio"] = {"median": float(np.median(ratio)),
                    "min": float(ratio.min()), "max": float(ratio.max()),
                    "rounds": [float(x) for x in ratio]}
    out["verdict"] = verdict
    say(phase, **fields, rounds=ROUNDS, **out,
        note=f"ratio: kernel / {library_name}, round by round")
    return out


def banked_cases(torch, art, flat, table, gen, rng, flush):
    """B1-B3 at the server's shapes, on ``table`` (``flat`` packed by the
    server's solved layout ``art``), each beside the PyTorch call that
    does the same work on the resolved rows of a copy of the table: the
    tick's gather of 8 slots x 4 trailing records (``index_select``); B2
    at the tick's 8 records, one a slot, at ``flush`` -- (positions, slots)
    of a served admit flush -- and at the 8,000 records of a flush after
    eight prompts of 1,000 tokens, positions 0-999 x slots 0-7, slot-major
    as the server queues them (``index_put_``); the swap's repack of all
    1024 rows (``index_copy_``).  One dict a case: the line's ``phase``,
    the kernel's ``name``, the ``kernel``, ``plain`` and ``library`` calls,
    ``library_name``, ``err`` (the kernel against its plain version),
    ``nbytes``, ``resolves`` and ``other_ops`` (its work) and the line's
    ``fields``.  It calls only what every slice of the port has, so
    ``scripts/banked_times.py`` times a parent checkout with it too."""
    import numpy as np

    from repro_torch.kernels import banked_gather as bg

    rows2d = table.clone().view(-1, 8)    # the library calls' own table

    def phys(idx):
        ba, bo = art.resolve(idx.to(torch.int64))
        return ba * art.bank_volume + bo

    pos = rng.integers(4, 1024, size=8)
    idx = torch.from_numpy(np.stack(
        [np.arange(p - 4, p) for p in pos]).astype(np.int32)).cuda()
    flat_idx, p_idx = idx.reshape(-1), phys(idx.reshape(-1))
    cases = [dict(
        phase="banked_gather_tick", name="banked_gather",
        kernel=lambda: art.gather(table, idx),
        plain=lambda: bg.banked_gather_plain(table, flat_idx, art),
        library=lambda: torch.index_select(rows2d, 0, p_idx),
        library_name="index_select",
        err=max_abs_diff(art.gather(table, idx).reshape(32, 8),
                         bg.banked_gather_plain(table, flat_idx, art)),
        nbytes=2 * 32 * 8 * 4 + 4 * 32, resolves=32, other_ops=0,
        fields={"rows": 32, "row_bytes": 32})]

    for phase, (p, s) in (
            ("banked_scatter_elems_tick", (pos, np.arange(8))),
            ("banked_scatter_elems_flush", flush),
            ("banked_scatter_elems_admit", (np.tile(np.arange(1000), 8),
                                            np.repeat(np.arange(8), 1000)))):
        T = len(p)
        e_idx = torch.from_numpy(p.astype(np.int32)).cuda()
        cols = torch.from_numpy(s.astype(np.int32)).cuda()
        vals = torch.randint(0, 152064, (T,), generator=gen, device="cuda",
                             dtype=torch.int64).to(torch.int32)
        mine, theirs = table.clone(), table.clone()
        art.scatter(mine, e_idx, vals, col=cols)
        bg.banked_scatter_elems_plain(theirs, e_idx, cols, vals, art)
        key = (phys(e_idx), cols.to(torch.int64))
        cases.append(dict(
            phase=phase, name="banked_scatter_elems",
            kernel=lambda mine=mine, i=e_idx, v=vals, c=cols:
                art.scatter(mine, i, v, col=c),
            plain=lambda theirs=theirs, i=e_idx, v=vals, c=cols:
                bg.banked_scatter_elems_plain(theirs, i, c, v, art),
            library=lambda key=key, v=vals: rows2d.index_put_(key, v),
            library_name="index_put_", err=max_abs_diff(mine, theirs),
            nbytes=T * (4 + 4 + 4 + 4), resolves=T, other_ops=T,
            fields={"records": T}))

    s_idx = torch.arange(1024, device="cuda", dtype=torch.int32)
    mine, theirs = torch.zeros_like(table), torch.zeros_like(table)
    art.scatter(mine, s_idx, flat)
    bg.banked_scatter_plain(theirs, s_idx, flat, art)
    s_phys = phys(s_idx)
    cases.append(dict(
        phase="banked_scatter_swap", name="banked_scatter",
        kernel=lambda: art.scatter(mine, s_idx, flat),
        plain=lambda: bg.banked_scatter_plain(theirs, s_idx, flat, art),
        library=lambda: rows2d.index_copy_(0, s_phys, flat),
        library_name="index_copy_",
        err=max(max_abs_diff(mine, theirs), max_abs_diff(mine, table)),
        nbytes=2 * 1024 * 8 * 4 + 4 * 1024, resolves=1024, other_ops=1024,
        fields={"rows": 1024, "row_bytes": 32}))
    return cases


def phase_kernel_times(torch, seed, launches, served_flush, ssd_args,
                       ssd_held_by, attn_rows, banked):
    """Each kernel at the shapes the main paths gave it.  B1-B3: an int32
    record table of (8 banks, 128 rows, 8 slots), at the shapes of
    ``banked_cases``; ``served_flush``: the first served model's first
    admit flush.  B5: olmoe's decode call, 8 tokens of 2048 bf16 and the
    zeros row, routed top-8 of 64 experts into 64 x 8 slots.  B6: the
    inputs of a 256-row chunk of each full-width prefill (``ssd_args``:
    arch -> the arguments it captured, timed as the chunk loop lays them
    out; ``ssd_held_by``: arch -> prompt length -> the worst error on that
    prefill's chunks); the first arch's row goes into the kernels line.
    B4: the first attention call of each shape of the full-width prefills,
    on its own inputs (``attn_rows``: label, (q, k, v), kwargs, calls at
    that shape, and its error against the plain version from
    ``phase_prefill``); every one of them goes into the kernels line.  B1-B3 are also timed beside
    their PyTorch call in interleaved rounds (``banked_*`` lines), and
    their rows carry the ``-Xptxas -v`` properties (``banked``) of the
    instantiations these launches use."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels import banked_gather as bg
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.runtime.server import page_solution

    art = page_solution(None, 1024, 16, 8)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    flat, table = random_table(torch, art, 8, torch.int32, gen)
    source = bg.kernel_source(art)
    out, call_ms = [], {}

    def entry(name, kernel, plain, library, err, nbytes, ops,
              rate=INT_OPS_PER_S, calls=None, iters=(50, 200)):
        """Times on the card (``library`` None: no PyTorch call computes
        the function) and the bound, ``ops`` at ``rate``; ``calls``: the
        main path's launches at this shape (default: all of the
        kernel's), ``iters``: calls timed on the card and with the host;
        returns the row."""
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = ops / rate * 1e3
        fns = [f for f in (kernel, plain, library) if f is not None]
        # 50 calls behind a 60 ms stall: even the plain versions' dozen
        # launches per call are all enqueued before the card starts on them
        warm = max(2, iters[0] // 5)
        on_card = [time_ms(torch, fn, iters=iters[0], warmup=warm,
                           stall_ms=60.0) for fn in fns] + [None]
        call_ms[name] = dict(zip(
            ("call_ms", "plain_call_ms", "library_call_ms"),
            [time_ms(torch, fn, iters=iters[1], warmup=warm)
             for fn in fns] + [None]))
        return {
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": launches[name] if calls is None else calls,
            "max_abs_err": err, "ms": on_card[0], "plain_ms": on_card[1],
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": on_card[2]}

    # B1-B3 at the server's shapes (``banked_cases``); B2's rows: the
    # tick's 8 records (one warp) and the first served admit flush (a block),
    # each with the main path's launches of its path; the 8,000-record flush
    # has a line of its own: no served run makes one
    kernel_of = {"banked_gather": "bk_gather_kernel",
                 "banked_scatter_elems": "bk_scatter_elems_kernel",
                 "banked_scatter": "bk_scatter_rows_kernel"}
    for case in banked_cases(torch, art, flat, table, gen, rng, served_flush):
        name, phase = case["name"], case["phase"]
        fields, calls = dict(case["fields"]), None
        if name == "banked_scatter_elems":
            T = fields["records"]
            path = bg.elems_path(T)
            fields.update(path=path, blocks=bg.elems_blocks(T))
            calls = (0 if phase == "banked_scatter_elems_admit"
                     else launches[f"banked_scatter_elems_{path}"])
        row = entry(name, case["kernel"], case["plain"], case["library"],
                    case["err"], case["nbytes"],
                    resolve_ops(art, case["resolves"]) + case["other_ops"],
                    calls=calls)
        check(row["max_abs_err"] == 0.0, f"{name} differs from its plain "
              f"version in {phase}: {row['max_abs_err']}")
        if name == "banked_scatter_elems":
            call_ms[phase] = call_ms.pop(name)
            row["records"] = fields["records"]
        if phase == "banked_scatter_elems_admit":
            fields.update({k: row[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                main_path_launches=0)
        row["interleaved"] = interleaved_rounds(
            torch, phase, case["kernel"], case["library"],
            case["library_name"], **fields)
        row["ptxas"] = used_ptxas(banked, kernel_of[name], source)
        if phase != "banked_scatter_elems_admit":
            out.append(row)

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
    out.append(entry("moe_dispatch",
          lambda: md.moe_dispatch(x_padded, slot),
          lambda: md.moe_dispatch_plain(x_padded, slot),
          lambda: torch.index_select(x_padded, 0, slot),
          err, ((T + 1) * D + S * D) * 2 + 4 * S, 0))
    interleaved_rounds(torch, "moe_dispatch_decode",
                       lambda: md.moe_dispatch(x_padded, slot),
                       lambda: torch.index_select(x_padded, 0, slot),
                       "index_select", slots=S)

    # B6: one 256-row chunk of each prefill, on the prefill's own inputs,
    # laid out as the chunk loop hands them over
    ssd_rows = []
    fit = sc.kernel_info()
    for arch, captured in ssd_args.items():
        args = ssd_views(captured, "chunk loop")
        B, H, Q, P = args[0].shape
        N = args[2].shape[-1]
        copies = sc.COPIES["ssd_chunk"]
        err, share = ssd_held(torch, args, f"{arch}'s prefill shape")
        nbytes, ops, per_head = ssd_work(B, H, Q, P, N)
        row = entry("ssd_chunk", lambda: sc.ssd_chunk(*args),
                    lambda: sc.ssd_chunk_plain(*args), None, err, nbytes,
                    3 * ops, rate=TF32_FLOPS_PER_S)
        check(sc.COPIES["ssd_chunk"] == copies, f"B6 copied an input of "
              f"{arch}'s chunk as the chunk loop lays it out")
        ssd_rows.append({
            "arch": arch, "shape": {"B": B, "H": H, "Q": Q, "P": P, "N": N},
            **row, "share_of_max": share,
            "worst_share_of_max_by_prompt": ssd_held_by[arch],
            "bytes": nbytes, "operations": ops,
            "bound_ms_fp32_fma": max(nbytes / HBM_BYTES_PER_S,
                                     ops / FP32_FLOPS_PER_S) * 1e3,
            "operations_per_head": per_head,
            "bound_ms_per_head": per_head / FP32_FLOPS_PER_S * 1e3,
            "tflops_3xtf32": 3 * ops / row["ms"] / 1e9,
            "copies": sc.COPIES["ssd_chunk"],
            "call_ms": dict(call_ms["ssd_chunk"])})
    call_ms["ssd_chunk"] = {r["arch"]: r.pop("call_ms") for r in ssd_rows}
    say("ssd_chunk_times", rows=ssd_rows, kernel=fit,
        scheme="3xTF32 on wgmma m64n64k8 (hi/lo TF32 split, three "
               "products, float32 sums)",
        library="none: no single PyTorch call computes an SSD chunk",
        note="ms: the chunk loop's layout (x, dt and cum transposed out of "
             "(B, S, H, .) tensors); bound_ms: the scheme's three products "
             "(3 x operations, C B^T once per batch row, as the kernel forms "
             "it) at the 495 TFLOP/s of dense TF32, or the bytes once, "
             "whichever is longer; bound_ms_fp32_fma: the operations as "
             "float32 FMA at 67 TFLOP/s (for comparison), bound_ms_per_head: "
             "float32 FMA with C B^T per head (history); "
             "worst_share_of_max_by_prompt: the prefills' "
             "captured chunks, 1000 tokens the pad path; copies: B6's "
             "copied inputs so far in the run (the prefills checked 0)")
    out.append({k: ssd_rows[0][k] for k in KERNEL_KEYS})

    # B4: each attention shape of the prefills, on the prefill's own inputs
    attn_calls = {}
    for label, (q, k, v), kw, calls, (err, share) in attn_rows:
        B, Sq, H, D = q.shape
        Sk, Hkv = k.shape[1], k.shape[2]
        causal, window = kw.get("causal", True), int(kw.get("window", 0))
        nbytes, flops, pairs = attention_work(B, Sq, Sk, H, Hkv, D, causal,
                                              window, q.element_size())
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = (fa._mask(Sq, Sk, causal, window, None, q.device)
                if window else None)

        def library(qt=qt, kt=kt, vt=vt, mask=mask, causal=causal,
                    gqa=H != Hkv):
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=gqa)

        lib_err = max_abs_diff(library().transpose(1, 2),
                               fa.mha_plain(q, k, v, **kw))
        row = entry("flash_attention", lambda: fa.attention(q, k, v, **kw),
                    lambda: fa.mha_plain(q, k, v, **kw), library, err,
                    nbytes, flops, rate=BF16_FLOPS_PER_S, calls=calls,
                    iters=(10, 10))
        row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
        attn_calls[label] = call_ms.pop("flash_attention")
        out.append({**row, "arch": label,
                    "shape": {"B": B, "Sq": Sq, "Sk": Sk, "H": H, "Hkv": Hkv,
                              "D": D, "causal": causal, "window": window,
                              "dtype": str(q.dtype)[6:]},
                    "share_of_max": share, "bytes": nbytes,
                    "operations": flops, "unmasked_pairs": pairs,
                    "library_max_abs_err": lib_err,
                    "call_ms": attn_calls[label]})
    call_ms["flash_attention"] = attn_calls

    for k in out:
        check(k["max_abs_err"] == 0.0 or k["name"] in ("ssd_chunk",
                                                       "flash_attention"),
              f"{k['name']} differs from its plain version at the server's "
              f"shapes: {k['max_abs_err']}")
    check(len(out) > 7, "no attention shape reached the kernels line")
    for k in out:
        check(k["launches"] > 0, f"the main path never launched {k['name']}")
    say("kernel_call_times", note="host-inclusive ms per call, timed without "
        "the stall; the kernels line holds the times on the card", **call_ms)
    return {"kernels": out}


# ---------------------------------------------------------------------------
# Phase 5: a reduced model on the card against the same weights on the CPU
# ---------------------------------------------------------------------------


ROUTE_MARGIN = 1e-3
ROUTE_DRAWS = 2000


def routing_margin(torch, model, params, tokens):
    """The smallest gap between the ``top_k``-th and the next router
    probability over every token and layer of the MoE model's forward pass
    over ``tokens``: below about 1e-3 the card's and the CPU's bf16
    rounding may send a token to different experts (ROADMAP F9)."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm

    cfg, gaps = model.cfg, []

    def ffn(lp, h):
        p = torch.softmax(h.reshape(-1, h.shape[-1]).float()
                          @ lp["router"].float(), dim=-1)
        top = p.sort(dim=-1, descending=True).values
        gaps.append(float((top[:, cfg.top_k - 1] - top[:, cfg.top_k]).min()))
        return moe.moe_ffn_sorted(cfg, lp, h)[0]

    tfm.forward(cfg, params, tokens, ffn=ffn)
    return min(gaps)


def phase_small_reference(torch, cfg, seed):
    """The reduced model on the card against the same weights on the CPU,
    within 2e-2 of the largest logit (bf16): a prefill of 20 tokens (the
    kernels on the card, their plain versions on the CPU: B4 for every
    attention over the prompt, B6 over two 16-row chunks, the second
    padded, B5 for every MoE layer; whisper's over 24 frames), then three
    decode steps, 4 rows.  An MoE model's prompts are drawn until no token
    sits within ``ROUTE_MARGIN`` of a routing tie, on the CPU (up to
    ``ROUTE_DRAWS`` draws of about 10 ms each; the reduced olmoe-1b-7b
    needs 247 at seed 0)."""
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
    S, rows = 20, 4
    draws, margin = 0, None
    while True:
        draws += 1
        toks = torch.randint(2, small.vocab - 1, (rows, S + 3), generator=gen,
                             dtype=torch.int64).to(torch.int32)
        if small.family != "moe":
            break
        margin = routing_margin(torch, model, cpu_params, toks)
        if margin >= ROUTE_MARGIN:
            break
        check(draws < ROUTE_DRAWS, f"no prompt without a routing near-tie "
              f"in {ROUTE_DRAWS} draws")
    batch = {"tokens": toks[:, :S]}
    if small.family in ("encdec", "audio"):
        batch["frames"] = torch.randn((rows, 24, small.d_model),
                                      generator=gen)
    params = {"cpu": cpu_params, "cuda": gpu_params}
    worst = 0.0

    def held(step, make):
        nonlocal worst
        logits = {}
        for dev in ("cpu", "cuda"):
            out, caches[dev] = make(dev)
            logits[dev] = out.float().cpu()
        check(tuple(logits["cuda"].shape) == (rows, small.vocab)
              and bool(torch.isfinite(logits["cuda"]).all()),
              "reduced model: logits are not finite (rows, vocab)")
        tol = 2e-2 * float(logits["cpu"].abs().max())
        diff = float((logits["cuda"] - logits["cpu"]).abs().max())
        worst = max(worst, diff / tol)
        check(diff <= tol, f"reduced model {step}: card and CPU logits "
              f"differ by {diff} > {tol} (2e-2 of the largest magnitude)")

    caches = {}
    held("prefill", lambda dev: model.prefill(
        params[dev], {k: v.to(dev) for k, v in batch.items()}, 32))
    for step in range(3):
        held(f"step {step}", lambda dev: model.decode(
            params[dev], caches[dev], toks[:, S + step:S + step + 1].to(dev)))
    say("small_reference", arch=small.name, batch=rows, prefill_tokens=S,
        steps=3, prompt_draws=draws, routing_margin=margin,
        worst_share_of_tolerance=worst, tolerance="2e-2 of max |logit|, bf16")


# ---------------------------------------------------------------------------


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the models' depth (default: full)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile a few steady decode ticks of each "
                         "served model and one prefill of each SSM model, "
                         "of qwen2-7b and of gemma3-12b")
    ap.add_argument("--skip-serve", action="store_true",
                    help="toolchain and kernel phases only; no ok line")
    args = ap.parse_args()

    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail("src/repro_torch is not beside this script")
    sys.path.insert(0, src)
    sys.path.insert(0, os.path.join(HERE, "tests"))   # torch_parity
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    from repro_torch.configs import get_arch

    card, banked = phase_toolchain(torch)
    phase_kernels(torch, args.seed)
    phase_moe_kernel(torch, args.seed)
    phase_ssd_kernel(torch, args.seed)
    phase_attention_kernel(torch, args.seed)
    if args.skip_serve:
        print(card, flush=True)
        return 0
    archs = [get_arch(a) for a in ("qwen2_7b", "olmoe_1b_7b", "mamba2_370m",
                                   "zamba2_2_7b", "gemma3_12b",
                                   "whisper_base")]
    if args.layers is not None:
        archs = [dataclasses.replace(c, n_layers=args.layers) for c in archs]
    qwen2, olmoe, mamba2, zamba2, gemma3, whisper = archs
    launches = {}                 # summed over the main paths' first runs

    def add(counts):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    served_flush = None       # the first served model's first admit flush
    # the plan stores of the served runs, removed at the end
    store_root = tempfile.mkdtemp(prefix="chip_smoke_plans_")
    atexit.register(shutil.rmtree, store_root, ignore_errors=True)
    tokens = {}
    for cfg in archs[:4]:
        store_dir = os.path.join(store_root, cfg.name)
        os.makedirs(store_dir)
        counts, flush, tokens[cfg.name] = phase_serve(torch, cfg, args.seed,
                                                      store_dir)
        add(counts)
        served_flush = served_flush or flush
    add(phase_plan_plane(torch, qwen2, olmoe, args.seed, store_root,
                         os.path.join(store_root, qwen2.name), tokens))
    del tokens
    add(phase_fleet(torch, args.seed))
    period = gemma3.local_global_ratio + 1    # whole groups for the ring
    phase_decode_variants(torch, dataclasses.replace(
        gemma3, n_layers=max(period, gemma3.n_layers // period * period)),
        qwen2, args.seed)
    ssd_args, ssd_held_by, attn_rows = {}, {}, []
    # the prefills: batch x tokens (whisper: over 1500 frames, a cache of
    # 448, its decoder's context); the SSM families also at 1000 tokens,
    # not a multiple of their 256-row chunk
    for cfg, batch, seqs, kw in (
            (mamba2, 8, (2048, 1000), {"profile": args.profile}),
            (zamba2, 4, (2048, 1000), {"profile": args.profile}),
            (qwen2, 4, (2048,), {"profile": args.profile}),
            (gemma3, 2, (4096,), {"profile": args.profile}),
            (olmoe, 4, (2048,), {}),
            (whisper, 8, (64,), {"frames": 1500, "max_len": 448})):
        n, chunk_args, rows, held = phase_prefill(torch, cfg, batch, seqs,
                                                  args.seed, **kw)
        add(n)
        if chunk_args:
            ssd_args[cfg.name] = chunk_args
            ssd_held_by[cfg.name] = held
        attn_rows += rows
    kernels = phase_kernel_times(torch, args.seed, launches, served_flush,
                                 ssd_args, ssd_held_by, attn_rows, banked)
    del ssd_args, attn_rows
    free_device_memory(torch)
    for cfg in archs:
        phase_small_reference(torch, cfg, args.seed)
    if args.profile:
        for cfg in archs[:4]:
            phase_profile(torch, cfg, args.seed)
        for cfg, batch in ((mamba2, 8), (zamba2, 4)):
            phase_silu_cost(torch, cfg, batch)
    for banned in ("jax", "repro"):
        check(banned not in sys.modules, f"{banned} was imported")
    say("done", seconds=time.perf_counter() - STARTED)
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
