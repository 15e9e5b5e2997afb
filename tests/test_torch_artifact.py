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
    bucket): header, instructions, the split of both dimensions, both bank
    folds."""
    from repro_torch.core import transforms as T

    port = build_artifact(port_core, LAYOUT_CASES[8], backend="torch")
    prog = port.kernel_program()
    w = bg.program_words(port)
    assert w is bg.program_words(port)                 # packed once
    n_instrs, n_regs, n_dims, n_ba, bo_reg, size, volume, cap = w[:8]
    assert (n_dims, n_ba, size, volume, cap) == (2, 2, 96, port.bank_volume,
                                                 32)
    assert (n_instrs, n_regs, bo_reg) == (len(prog.instrs), prog.n_regs,
                                          prog.bo_reg)
    slots = w[8:8 + 4 * 32].reshape(32, 4).astype(np.int64)
    assert [tuple(row) for row in slots[:n_instrs].tolist()] == [
        tuple(np.int64(v).astype(np.int32).item()
              for v in T._packed_instr(*ins)) for ins in prog.instrs]
    split = w[8 + 4 * 32:8 + 4 * 32 + 24].reshape(8, 3)
    assert list(split[:2, 0]) == [8, 12]
    fold = w[8 + 4 * 32 + 24:].reshape(8, 2)
    assert [tuple(f) for f in fold[:2].tolist()] == list(
        zip(prog.ba_regs, port.geometry.Ns))


@pytest.mark.parametrize("which,source", [
    ("server", "BkFast<6>"), (LAYOUT_CASES[8], "BkDev<16,32>"),
    (LAYOUT_CASES[3], "BkDev<32,192>")], ids=["server", "multidim", "long"])
def test_kernel_source_follows_the_program(which, source):
    """The server's six LINEAR steps go to the kernels by value, decoded;
    a two-dimensional layout and an 87-step program from device memory, in
    the bucket that holds them."""
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
        h = ((a * 2654435761) & 0xFFFFFFFF) >> (32 - bits)
        while key[h] not in (-1, a):
            h = (h + 1) & ((1 << bits) - 1)
        key[h] = a
        win[h] = max(win[h], t)
        slot[t] = h
    return np.array([t for t in range(len(idx))
                     if slot[t] >= 0 and win[slot[t]] == t], np.int64)


def _table_winners(win, idx, order):
    """The grid path: ``win`` holds one uint64 a logical address and the
    epoch last; a call raises each address to (epoch + 1) << 24 | t in
    ``order``, keeps the writes that still find their own key, and stores
    the new epoch.  Updates ``win`` in place; returns the writes that
    copy."""
    size = len(win) - 1
    e = int(win[size]) + 1
    for t in order:
        if 0 <= idx[t] < size:
            win[idx[t]] = max(int(win[idx[t]]), e << 24 | int(t))
    keep = [t for t in range(len(idx))
            if 0 <= idx[t] < size and int(win[idx[t]]) == e << 24 | t]
    win[size] = e
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
    other sizes), alternating, never cleared: each call keeps exactly the
    last write of each address, whatever earlier calls left."""
    rng = np.random.default_rng(7)
    tables = {96: np.zeros(97, np.uint64), 1024: np.zeros(1025, np.uint64)}
    for call in range(12):
        size = (96, 1024)[call % 2]
        T = int(rng.integers(1025, 4097))
        distinct = int(rng.integers(1, min(size, 64) + 1))
        idx = rng.choice(size, size=distinct, replace=False)[
            rng.integers(0, distinct, size=T)]
        idx[rng.random(T) < 0.01] = -1
        got = _table_winners(tables[size], idx, rng.permutation(T))
        np.testing.assert_array_equal(got, _want_winners(idx, size))
        assert int(tables[size][size]) == call // 2 + 1


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
