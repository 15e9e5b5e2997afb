"""CompiledBankingPlan of the port against the reference: the same JSON,
files that load across the packages, and the same packed tables, gathered
rows and scattered tables for the same plan and inputs -- duplicates
included.  The reference runs its Pallas kernels in interpret mode; the
port, on CPU tensors, runs the plain versions of its CUDA kernels."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from repro.runtime.server import page_solution as ref_page_solution
from repro_torch.kernels import banked_gather as bg
from repro_torch.kernels import ops, ref as port_ref
from repro_torch.runtime.server import page_solution

from torch_parity import (LAYOUT_CASES, assert_same, build_artifact,
                          layout_id, strip_backend)

# the reference's Pallas path is slow in interpret mode: three layouts go
# through it, the rest through its numpy backend
PALLAS_CASES = [LAYOUT_CASES[1], LAYOUT_CASES[5], LAYOUT_CASES[7]]


def _pair(case, ref_backend="numpy", level="full"):
    return (build_artifact(ref_core, case, backend=ref_backend, level=level),
            build_artifact(port_core, case, backend="torch", level=level))


def _rows(rng, A, D, dtype=np.float32):
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-1000, 1000, size=(A, D)).astype(dtype)
    return rng.normal(size=(A, D)).astype(dtype)


# ---------------------------------------------------------------------------
# Serialization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("level", ["full", "basic"])
@pytest.mark.parametrize("case", LAYOUT_CASES, ids=layout_id)
def test_to_json_equals_reference_apart_from_backend(case, level):
    ref, port = _pair(case, level=level)
    rj, pj = ref.to_json(), port.to_json()
    assert pj["backend"] == "torch" and rj["backend"] == "numpy"
    assert json.dumps(strip_backend(pj), sort_keys=True) == \
        json.dumps(strip_backend(rj), sort_keys=True)


@pytest.mark.parametrize("max_len,page,readers", [(64, 16, 4), (1024, 16, 8)])
def test_server_layout_json_equals_reference(max_len, page, readers):
    rj = ref_page_solution(None, max_len, page, readers).to_json()
    pj = page_solution(None, max_len, page, readers).to_json()
    # the reference's artifact carries its planner's signature; canonical
    # signatures arrive in the port with the planner
    for d in (rj, pj):
        d.pop("backend"), d.pop("signature")
    assert pj == rj


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("case", [LAYOUT_CASES[3], LAYOUT_CASES[8]],
                         ids=layout_id)
def test_saved_artifact_loads_in_the_other_package(tmp_path, case, writer):
    ref, port = _pair(case, ref_backend="jax")
    path = tmp_path / "plan.compiled.json"
    if writer == "reference":
        ref.save(path)
        loaded = port_core.CompiledBankingPlan.load(path)
        assert loaded.backend == "torch"      # "jax" is not a backend here
        want = port
    else:
        port.save(path)
        loaded = ref_core.CompiledBankingPlan.load(path, backend="numpy")
        want = ref
    assert strip_backend(loaded.to_json()) == strip_backend(want.to_json())
    assert loaded.layout.dims == want.layout.dims
    addr = np.arange(want.layout.logical_size, dtype=np.int64)
    a = loaded.resolve(torch.from_numpy(addr) if writer == "reference"
                       else addr)
    b = build_artifact(ref_core, case, backend="numpy").resolve(addr)
    assert_same(tuple(np.broadcast_to(np.asarray(x), addr.shape) for x in b),
                tuple(a))


def test_from_json_refuses_other_formats_and_backends():
    _, port = _pair(LAYOUT_CASES[0])
    with pytest.raises(ValueError, match="not a compiled banking plan"):
        port_core.CompiledBankingPlan.from_json({"format": "other"})
    with pytest.raises(ValueError, match="unknown backend"):
        port_core.CompiledBankingPlan.from_json(port.to_json(), backend="jax")


# ---------------------------------------------------------------------------
# pack / unpack / gather / scatter across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", LAYOUT_CASES, ids=layout_id)
def test_pack_unpack_equal_reference(case):
    ref, port = _pair(case, ref_backend="jax")
    A = port.layout.logical_size
    flat = _rows(np.random.default_rng(0), A, 3)
    want = np.asarray(ref.pack(jnp.asarray(flat)))
    got = port.pack(torch.from_numpy(flat))
    assert got.device.type == "cpu"
    assert_same(want, got, what="packed table")
    assert_same(flat, port.unpack(got), what="unpack(pack(x))")
    assert_same(flat, port.pack(flat, device="cpu")[port._index_tables("cpu")])


@pytest.mark.parametrize("case", LAYOUT_CASES, ids=layout_id)
def test_gather_equals_reference(case):
    ref, port = _pair(case)                 # reference: numpy backend
    A = port.layout.logical_size
    rng = np.random.default_rng(1)
    flat = _rows(rng, A, 5)
    table = port.pack(torch.from_numpy(flat))
    one = rng.integers(0, A, size=13)
    stacked = rng.integers(0, A, size=(4, 6))
    for idx in (one, stacked):
        got = port.gather(table, idx)
        assert_same(ref.gather(table.numpy(), idx), got)
        assert_same(port_ref.banked_gather_reference(flat, idx), got)
    assert tuple(port.gather(table, stacked).shape) == (4, 6, 5)
    # index containers: numpy, list, int32 / int64 tensors all work
    for idx in (one.tolist(), torch.from_numpy(one),
                torch.from_numpy(one.astype(np.int32))):
        assert_same(flat[one], ops.gather_banked(table, idx, port))


@pytest.mark.parametrize("case", PALLAS_CASES, ids=layout_id)
def test_gather_equals_reference_pallas_kernel(case):
    ref, port = _pair(case, ref_backend="jax")
    A = port.layout.logical_size
    rng = np.random.default_rng(2)
    flat = _rows(rng, A, 4)
    stacked = rng.integers(0, A, size=(3, 4)).astype(np.int32)
    want = ref.gather(ref.pack(jnp.asarray(flat)), jnp.asarray(stacked))
    got = port.gather(port.pack(torch.from_numpy(flat)), stacked)
    assert_same(want, got)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("case", LAYOUT_CASES, ids=layout_id)
def test_scatter_with_duplicates_equals_reference(case, dtype):
    ref, port = _pair(case)
    A = port.layout.logical_size
    rng = np.random.default_rng(3)
    flat = _rows(rng, A, 4, dtype)
    rows = rng.integers(0, A, size=40)
    rows[5::4] = rows[1]                       # many writes to one address
    vals = _rows(rng, 40, 4, dtype)
    cols = rng.integers(0, 4, size=40)
    cols[5::8] = cols[1]                       # ... and to one element
    want_rows, want_elems = flat.copy(), flat.copy()
    for t in range(40):                        # last write wins, in order
        want_rows[rows[t]] = vals[t]
        want_elems[rows[t], cols[t]] = vals[t, 0]

    table = port.pack(torch.from_numpy(flat))
    ref_table = table.numpy().copy()
    out = port.scatter(table, rows, vals)
    assert out is table                        # in place, and returned
    assert_same(ref.scatter(ref_table, rows, vals), out)
    assert_same(want_rows, port.unpack(out))

    table = port.pack(torch.from_numpy(flat))
    out = ops.scatter_banked(table, rows, vals[:, 0], port, col=cols)
    assert out is table
    assert_same(ref.scatter(ref_table, rows, vals[:, 0], col=cols), out)
    assert_same(want_elems, port.unpack(out))


@pytest.mark.parametrize("case", PALLAS_CASES[:2], ids=layout_id)
def test_scatter_equals_reference_pallas_kernels(case):
    ref, port = _pair(case, ref_backend="jax")
    A = port.layout.logical_size
    rng = np.random.default_rng(4)
    flat = _rows(rng, A, 4, np.int32)
    rows = np.asarray([3, 7, 3, A - 1, 7, 3], np.int32)
    vals = _rows(rng, 6, 4, np.int32)
    cols = np.asarray([1, 3, 1, 0, 2, 1], np.int32)
    ref_table = ref.pack(jnp.asarray(flat))
    want = ref.scatter(ref_table, jnp.asarray(rows), jnp.asarray(vals))
    got = port.scatter(port.pack(torch.from_numpy(flat)), rows, vals)
    assert_same(want, got)
    want = ref.scatter(ref.pack(jnp.asarray(flat)), jnp.asarray(rows),
                       jnp.asarray(vals[:, 0]), col=jnp.asarray(cols))
    got = port.scatter(port.pack(torch.from_numpy(flat)), rows, vals[:, 0],
                       col=cols)
    assert_same(want, got)


def test_numpy_backend_of_the_port_equals_its_torch_backend():
    case = LAYOUT_CASES[5]
    tor = build_artifact(port_core, case, backend="torch")
    npy = build_artifact(port_core, case, backend="numpy")
    A = tor.layout.logical_size
    rng = np.random.default_rng(5)
    flat = _rows(rng, A, 3)
    table = tor.pack(torch.from_numpy(flat))
    idx = rng.integers(0, A, size=(3, 5))
    assert_same(npy.gather(table.numpy(), idx), tor.gather(table, idx))
    rows = rng.integers(0, A, size=9)
    vals = _rows(rng, 9, 3)
    want = npy.scatter(table.numpy(), rows, vals)     # a copy
    assert_same(want, tor.scatter(table, rows, vals))


# ---------------------------------------------------------------------------
# The wrappers' argument checks and hooks (what surrounds the kernels)
# ---------------------------------------------------------------------------


def _small():
    port = build_artifact(port_core, LAYOUT_CASES[2], backend="torch")
    flat = _rows(np.random.default_rng(6), port.layout.logical_size, 4)
    return port, port.pack(torch.from_numpy(flat))


@pytest.mark.parametrize("bad", ["host index", "host column", "table shape",
                                 "values shape", "index shape", "float index",
                                 "not contiguous", "too many writes",
                                 "not a tensor"])
def test_wrappers_raise_on_what_the_kernels_do_not_take(bad):
    port, table = _small()
    A = port.layout.logical_size
    vals = torch.zeros((2, 4))
    if bad == "host index":
        with pytest.raises(IndexError):
            port.gather(table, [0, A])
        with pytest.raises(IndexError):
            port.scatter(table, [-1, 0], vals)
    elif bad == "host column":
        with pytest.raises(IndexError):
            port.scatter(table, [0, 1], vals[:, 0], col=[0, 4])
    elif bad == "table shape":
        with pytest.raises(ValueError, match="bank-major"):
            port.gather(table.reshape(1, -1, 4), [0])
    elif bad == "values shape":
        with pytest.raises(ValueError, match="values have shape"):
            port.scatter(table, [0, 1], vals[:, :3])
    elif bad == "index shape":
        with pytest.raises(ValueError):
            bg.banked_gather(table, np.zeros((2, 2), np.int64), port)
        with pytest.raises(ValueError):
            port.scatter(table, [0, 1], vals[:, 0], col=[0])
    elif bad == "float index":
        with pytest.raises(TypeError):
            port.gather(table, np.asarray([0.5]))
    elif bad == "not contiguous":
        with pytest.raises(ValueError, match="contiguous"):
            port.gather(table.transpose(0, 1).contiguous().transpose(0, 1),
                        [0])
    elif bad == "too many writes":
        n = bg.SCATTER_MAX_T + 1
        with pytest.raises(ValueError, match="at most"):
            port.scatter(table, np.zeros(n, np.int64), torch.zeros((n, 4)))
    else:
        with pytest.raises(TypeError):
            port.gather(table.numpy(), [0])


def test_no_kernel_is_launched_for_a_cpu_table():
    port, table = _small()
    before = dict(bg.LAUNCHES)
    port.gather(table, [0, 1])
    port.scatter(table, [0], torch.zeros((1, 4)))
    port.scatter(table, [0], torch.zeros(1), col=[2])
    assert bg.LAUNCHES == before


def test_program_struct_matches_the_kernel_program():
    """The packed words the kernels take (multidim Ns=(4, 1), the middle
    bucket): header, instructions (fused), the split of both dimensions,
    both bank folds, and no sum of terms (two dimensions)."""
    from repro_torch.core import transforms as T

    port = build_artifact(port_core, LAYOUT_CASES[8], backend="torch")
    prog = port.kernel_program()
    w = bg.program_words(port)
    assert w is bg.program_words(port)                 # packed once
    n_instrs, n_regs, n_dims, n_ba, bo_reg, size, volume, cap = w[:8]
    assert (n_dims, n_ba, size, volume, cap) == (2, 2, 96, port.bank_volume,
                                                 32)
    fused = T.fuse_linear_steps([T._packed_instr(*i) for i in prog.instrs],
                                set(prog.ba_regs) | {prog.bo_reg})
    assert (n_instrs, n_regs, bo_reg) == (len(fused), prog.n_regs,
                                          prog.bo_reg)
    assert n_instrs < len(prog.instrs)
    slots = w[8:8 + 4 * 32].reshape(32, 4).astype(np.int64)
    assert [tuple(row) for row in slots[:n_instrs].tolist()] == [
        tuple(np.int64(v).astype(np.int32).item() for v in row)
        for row in fused]
    split = w[8 + 4 * 32:8 + 4 * 32 + 24].reshape(8, 3)
    assert list(split[:2, 0]) == [8, 12]
    fold = w[8 + 4 * 32 + 24:8 + 4 * 32 + 40].reshape(8, 2)
    assert [tuple(f) for f in fold[:2].tolist()] == list(
        zip(prog.ba_regs, port.geometry.Ns))
    assert not w[8 + 4 * 32 + 40:].any()


@pytest.mark.parametrize("which,source", [
    ("server", "BkTerms<3>"), (LAYOUT_CASES[8], "BkDev<16,32>"),
    (LAYOUT_CASES[3], "BkDev<32,192>")], ids=["server", "multidim", "long"])
def test_kernel_source_follows_the_program(which, source):
    """The server's six LINEAR steps go to the kernels by value as a sum of
    three terms of the address; a two-dimensional layout and an 87-step
    program from device memory, in the bucket that holds them."""
    art = (page_solution(None, 1024, 16, 8) if which == "server" else
           build_artifact(port_core, which, backend="torch"))
    assert bg.kernel_source(art) == source


# ---------------------------------------------------------------------------
# B3's choice of the last write, modelled step by step in numpy
# ---------------------------------------------------------------------------


def _hash_winners(idx, size, order, bits=11):
    """The one-block path of ``bk_scatter_rows``: each write claims its
    address in a hash of 2^bits slots (compare-and-swap, linear probing)
    and raises the slot's winner to its t; the threads run in ``order``.
    Returns the writes that copy."""
    key = np.full(1 << bits, -1, np.int64)
    win = np.full(1 << bits, -1, np.int64)
    slot = np.full(len(idx), -1, np.int64)
    for t in order:
        a = int(idx[t])
        if not 0 <= a < size:
            continue
        h = ((a * 0x85EBCA77) & 0xFFFFFFFF) >> (32 - bits)
        while key[h] not in (-1, a):
            h = (h + 1) & ((1 << bits) - 1)
        key[h] = a
        win[h] = max(win[h], t)
        slot[t] = h
    return np.array([t for t in range(len(idx))
                     if slot[t] >= 0 and win[slot[t]] == t], np.int64)


def _table_winners(win, idx, order):
    """The overflow path: ``win`` holds one int32 a logical address, zero
    between calls; a call raises each address to t + 1 in ``order``
    (atomicMax), keeps the writes that find their own t + 1, and zeroes
    what it used.  Updates ``win`` in place; returns the writes that
    copy."""
    size = len(win)
    inside = [t for t in order if 0 <= idx[t] < size]
    for t in inside:
        win[idx[t]] = max(int(win[idx[t]]), t + 1)
    keep = sorted(t for t in inside if int(win[idx[t]]) == t + 1)
    for t in inside:
        win[idx[t]] = 0
    return np.array(keep, np.int64)


def _want_winners(idx, size):
    inside = np.flatnonzero((idx >= 0) & (idx < size))
    last = bg._last_occurrence(torch.from_numpy(idx[inside])).numpy()
    return np.sort(inside[last])


@pytest.mark.parametrize("T,distinct", [(1, 1), (64, 3), (1024, 64),
                                        (1024, 1024), (1000, 700)])
def test_block_winners_are_the_last_occurrences(T, distinct):
    """Random duplicate-heavy index sets, a few stray addresses, threads in
    random orders: the hash keeps exactly the last write of each address
    (what the plain version keeps through ``_last_occurrence``)."""
    rng = np.random.default_rng(T + distinct)
    size = 1024
    idx = rng.choice(size, size=distinct, replace=False)[
        rng.integers(0, distinct, size=T)]
    idx[rng.random(T) < 0.02] = size + 3
    for _ in range(3):
        got = _hash_winners(idx, size, rng.permutation(T))
        np.testing.assert_array_equal(got, _want_winners(idx, size))


def test_table_winners_over_calls_in_a_row_and_two_artifacts():
    """Several calls in a row on each of two winner tables (two artifacts of
    other sizes), alternating: each call keeps exactly the last write of
    each address and leaves its table zero, as the next call needs it."""
    rng = np.random.default_rng(7)
    tables = {96: np.zeros(96, np.int32), 1024: np.zeros(1024, np.int32)}
    for call in range(12):
        size = (96, 1024)[call % 2]
        T = int(rng.integers(1025, 4097))
        distinct = int(rng.integers(1, min(size, 64) + 1))
        idx = rng.choice(size, size=distinct, replace=False)[
            rng.integers(0, distinct, size=T)]
        idx[rng.random(T) < 0.01] = -1
        got = _table_winners(tables[size], idx, rng.permutation(T))
        np.testing.assert_array_equal(got, _want_winners(idx, size))
        assert not tables[size].any()


# ---------------------------------------------------------------------------
# B2's choice of the last write, modelled step by step in numpy
# ---------------------------------------------------------------------------


def _claims(writes, key, bits, rng):
    """{pair: write} of the writes that win their pair's slot in a hash of
    2^bits slots, claimed in a random order (linear probing from
    ``pair_slot``, raising the slot's winner)."""
    slots = 1 << bits
    hkey = np.full(slots, -1, np.int64)
    win = np.full(slots, -1, np.int64)
    slot = {}
    for t in rng.permutation(writes):
        h = int(bg.pair_slot(key[t:t + 1], bits)[0])
        while hkey[h] not in (-1, key[t]):
            h = (h + 1) & (slots - 1)
        hkey[h] = key[t]
        win[h] = max(win[h], t)
        slot[int(t)] = h
    assert (hkey >= 0).sum() <= slots // 2   # at most half full
    return {int(key[t]): t for t, h in slot.items() if win[h] == t}


def _elems_winners(idx, cols, size, D, rng):
    """``bk_scatter_elems_kernel``'s choice, thread by thread in random
    orders: up to ``ELEMS_PER_BLOCK`` writes, a thread a write, whose
    lanes of one pair in a warp find each other by a match; the highest of
    them stores in one warp, and in more claims the pair in a hash of
    2^ELEMS_ONE_HASH_BITS slots.  Past that, ``elems_blocks`` blocks that
    each list the writes to the pairs they own (``pair_owner``) -- all of
    them, or, past ``ELEMS_OWN``, window by window of ``ELEMS_OWN`` writes
    in index order -- claim each pair in a hash of 2^ELEMS_HASH_BITS slots.
    Returns {pair: the write whose value the table holds at the end}."""
    T = len(idx)
    key = idx.astype(np.int64) * D + cols
    ok = (idx >= 0) & (idx < size) & (cols >= 0) & (cols < D)
    if T <= bg.ELEMS_PER_BLOCK:
        warp_last = []
        for t in rng.permutation(T):
            w0 = t - t % 32
            peers = [u for u in range(w0, min(T, w0 + 32))
                     if ok[u] and key[u] == key[t]]
            if ok[t] and max(peers) == t:
                warp_last.append(int(t))
        if T <= bg.ELEMS_WARP:
            return {int(key[t]): t for t in warp_last}
        return _claims(np.array(warp_last, np.int64), key,
                       bg.ELEMS_ONE_HASH_BITS, rng)
    final = {}
    nb = bg.elems_blocks(T)
    owner = bg.pair_owner(key, nb)
    for b in range(nb):
        mine = np.flatnonzero(ok & (owner == b))
        spans = ([(0, T)] if len(mine) <= bg.ELEMS_OWN else
                 [(w, w + bg.ELEMS_OWN) for w in range(0, T, bg.ELEMS_OWN)])
        for w0, w1 in spans:                   # in order, barrier between
            listed = mine[(mine >= w0) & (mine < w1)]
            assert len(listed) <= bg.ELEMS_OWN
            final.update(_claims(listed, key, bg.ELEMS_HASH_BITS, rng))
    return final


@pytest.mark.parametrize("case", [
    "8 records", "31 with duplicates", "32 with strays", "33 distinct",
    "100 over 12 pairs", "128 with strays", "129 over 40 pairs",
    "8000 distinct (admit)", "65536 over 3 x 8", "one block overflows"])
def test_elems_winners_are_the_last_occurrences(case):
    """The warp's match, the one block's match and pair hash, and the
    blocks' pair hash, with its windows where a block owns more writes
    than it lists, keep exactly the last write of each (address, column)
    pair -- what the plain version keeps through ``_last_occurrence`` --
    whatever order the threads run in."""
    rng = np.random.default_rng(len(case))
    size, D = 1024, 8
    if case == "8 records":
        idx, cols = rng.integers(0, size, 8), np.arange(8)
    elif case == "31 with duplicates":
        idx, cols = rng.integers(0, 4, 31), rng.integers(0, 2, 31)
    elif case == "32 with strays":
        idx, cols = rng.integers(0, size, 32), rng.integers(0, D, 32)
        idx[::5], cols[1::7] = size + 3, -1
    elif case == "33 distinct":
        idx, cols = rng.choice(size, 33, replace=False), rng.integers(0, D, 33)
    elif case == "100 over 12 pairs":
        idx, cols = rng.integers(0, 3, 100), rng.integers(0, 4, 100)
    elif case == "128 with strays":
        idx, cols = rng.integers(0, 40, 128), rng.integers(0, D, 128)
        idx[::9], cols[2::11] = -1, D
    elif case == "129 over 40 pairs":
        idx, cols = rng.integers(0, 10, 129), rng.integers(0, 4, 129)
    elif case == "8000 distinct (admit)":
        idx, cols = np.tile(np.arange(1000), 8), np.repeat(np.arange(8), 1000)
    elif case == "65536 over 3 x 8":
        idx = rng.choice(size, 3, replace=False)[rng.integers(0, 3, 65536)]
        cols = rng.integers(0, D, 65536)
    else:   # 3,000 pairs of a table 128 wide, all owned by block 0
        D, T = 128, 4096
        owned = np.flatnonzero(bg.pair_owner(np.arange(size * D),
                                             bg.elems_blocks(T)) == 0)
        keys = rng.choice(owned, 3000, replace=False)
        keys = keys[np.concatenate([rng.permutation(3000),
                                    rng.integers(0, 3000, T - 3000)])]
        idx, cols = keys // D, keys % D
    key = idx.astype(np.int64) * D + cols
    ok = (idx >= 0) & (idx < size) & (cols >= 0) & (cols < D)
    inside = np.flatnonzero(ok)
    last = inside[bg._last_occurrence(torch.from_numpy(key[inside])).numpy()]
    want = {int(key[t]): int(t) for t in last}
    for _ in range(2):
        assert _elems_winners(idx, cols, size, D, rng) == want


def test_telemetry_sink_sees_every_gather_and_scatter():
    port, table = _small()
    seen = []

    class Sink:
        def observe(self, art, op, shape, seconds):
            seen.append((art is port, op, shape, seconds >= 0))

    port.enable_telemetry(Sink())
    port.gather(table, np.zeros((2, 3), np.int64))
    port.scatter(table, [0, 1], torch.zeros((2, 4)))
    port.disable_telemetry()
    port.gather(table, [0])
    assert seen == [(True, "gather", (2, 3), True),
                    (True, "scatter", (2,), True)]


def test_as_compiled_and_banked_dims():
    port, _ = _small()
    assert port_core.as_compiled(port) is port
    with pytest.raises(TypeError):
        port_core.as_compiled(object())
    assert port.banked_dims() == (0,)
    md = build_artifact(port_core, LAYOUT_CASES[8], backend="torch")
    assert md.banked_dims() == (0,)                    # Ns = (4, 1)
    with pytest.raises(ValueError, match="logical rows"):
        port.pack(torch.zeros((3, 2)))
    with pytest.raises(ValueError, match="does not match layout"):
        port.unpack(torch.zeros((1, 2, 3)))
