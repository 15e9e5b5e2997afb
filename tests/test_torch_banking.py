"""Banking math of the port against the reference: same solutions from the
solver, and the same BA/BO for EVERY logical address from each lowering of
the resolution circuit (numpy int64, torch, the int32 register program the
CUDA kernels interpret, and that program packed into the words the kernels
read, with their split of a flat address)."""

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from repro.core import problems as ref_problems
from repro.core.artifact import graph_to_json as ref_graph_json
from repro.runtime.server import _page_program as ref_page_program
from repro_torch.core import problems as port_problems
from repro_torch.core import transforms as T
from repro_torch.core.artifact import graph_to_json as port_graph_json
from repro_torch.kernels import banked_gather as bg
from repro_torch.runtime.server import _page_program as port_page_program
from repro_torch.runtime.server import page_solution

from torch_parity import LAYOUT_CASES, build_artifact, layout_id


# ---------------------------------------------------------------------------
# solve(): same solutions, in the same order
# ---------------------------------------------------------------------------


def _solve(core, prog, memname, opts=None):
    up = core.unroll(prog)
    return core.solve(prog.memories[memname], core.build_groups(up, memname),
                      up.iterators, opts or core.SolverOptions())


def _solution_key(sol, graph_json):
    ba = sol.resolution_ba
    roots = list(ba) if isinstance(ba, tuple) else [ba]
    res = sol.resources
    return {
        "kind": sol.kind, "geometry": repr(sol.geometry), "P": sol.P,
        "pad": sol.pad, "ports": sol.required_ports, "banks": sol.num_banks,
        "volume": sol.bank_volume, "fan_outs": sol.fan_outs,
        "fan_in": sol.max_fan_in, "duplicates": sol.duplicates,
        "raw_ops": sol.raw_ops, "note": sol.note,
        "graphs": graph_json(roots + [sol.resolution_bo]),
        "weighted": None if res is None else res.total.weighted(),
    }


@pytest.mark.parametrize("app", ["sobel", "motion-lh", "sgd", "md_grid"])
def test_solve_matches_reference_on_apps(app):
    rp, pp = ref_problems.build(app), port_problems.build(app)
    mem = list(rp.memories)[0]
    ref = [_solution_key(s, ref_graph_json) for s in _solve(ref_core, rp, mem)]
    port = [_solution_key(s, port_graph_json)
            for s in _solve(port_core, pp, mem)]
    assert len(ref) > 0
    assert port == ref


@pytest.mark.parametrize("max_len,page,readers", [(64, 16, 4), (1024, 16, 8)])
def test_solve_matches_reference_on_kv_pool(max_len, page, readers):
    def run(core, prog):
        opts = core.SolverOptions(b_candidates=(page, 1),
                                  allow_multidim=False)
        return _solve(core, prog, "kv_pool", opts)

    ref = [_solution_key(s, ref_graph_json)
           for s in run(ref_core, ref_page_program(max_len, page, readers))]
    port = [_solution_key(s, port_graph_json)
            for s in run(port_core, port_page_program(max_len, page, readers))]
    assert len(ref) > 0
    assert port == ref


# ---------------------------------------------------------------------------
# BA/BO of every address, every lowering
# ---------------------------------------------------------------------------


def _fold(bas, art):
    fold = art.geometry.Ns if art.kind == "multidim" else (1,)
    out = 0
    for b, n in zip(bas, fold):
        out = out * n + b
    return out


def _check_all_lowerings(port_art, ref_art):
    """The whole logical address range: the reference's numpy lowering
    (int64) is the yardstick for the port's torch lowering and for the
    int32 register program; all agree with the raw Eq. 1-2 tables."""
    A = port_art.layout.logical_size
    addr = np.arange(A, dtype=np.int64)
    want_ba, want_bo = ref_art.resolve(addr)
    want_ba = np.broadcast_to(np.asarray(want_ba), (A,))
    want_bo = np.broadcast_to(np.asarray(want_bo), (A,))

    got_ba, got_bo = port_art.resolve(torch.from_numpy(addr))
    assert got_ba.dtype == got_bo.dtype == torch.int64
    np.testing.assert_array_equal(got_ba.numpy(), want_ba)
    np.testing.assert_array_equal(got_bo.numpy(), want_bo)

    prog = port_art.kernel_program()
    assert len(prog.instrs) <= T.KERNEL_MAX_INSTRS
    assert prog.n_regs <= T.KERNEL_MAX_REGS
    xs = [np.asarray(x) for x in ref_art._split(addr)]
    bas, bo = T.run_kernel_program(prog, xs)
    assert bo.dtype == np.int32
    np.testing.assert_array_equal(_fold(bas, port_art), want_ba)
    np.testing.assert_array_equal(bo, want_bo)

    # the packed words and the kernels' split, from flat addresses, with a
    # few outside the range on either side
    words = bg.program_words(port_art)
    cap = T.kernel_bucket(prog)
    assert cap in T.KERNEL_BUCKETS
    assert words.dtype == np.int32
    assert words.size == T.kernel_program_words(cap[0])
    edge = np.array([-2, -1, A, A + 1])
    rows = T.run_packed_program(words, np.concatenate([addr, edge]))
    np.testing.assert_array_equal(
        rows[:A], want_ba.astype(np.int64) * port_art.bank_volume + want_bo)
    np.testing.assert_array_equal(rows[A:], -1)
    # the sum of terms, where the host found one (one dimension, LINEAR)
    n_terms = int(words[T.kernel_program_words(cap[0])
                        - T.KERNEL_TERMS_WORDS])
    if n_terms:
        assert bg.kernel_source(port_art) == f"BkTerms<{n_terms}>"
        np.testing.assert_array_equal(
            T.run_packed_terms(words, np.concatenate([addr, edge])), rows)
    else:
        with pytest.raises(ValueError):
            T.run_packed_terms(words, addr)

    tab_ba, tab_bo = port_art._tables()
    np.testing.assert_array_equal(tab_ba, want_ba)
    np.testing.assert_array_equal(tab_bo, want_bo)
    assert want_bo.max() < port_art.bank_volume
    assert want_ba.max() < port_art.n_banks


@pytest.mark.parametrize("level", ["full", "basic"])
@pytest.mark.parametrize("case", LAYOUT_CASES, ids=layout_id)
def test_every_address_every_lowering(case, level):
    port = build_artifact(port_core, case, backend="torch", level=level)
    ref = build_artifact(ref_core, case, backend="numpy", level=level)
    _check_all_lowerings(port, ref)


@pytest.mark.parametrize("dims", [(60,), (6, 10)])
def test_every_address_trivial_fallback(dims):
    pm = port_core.MemorySpec("m", dims=dims, word_bits=32, ports=1)
    rm = ref_core.MemorySpec("m", dims=dims, word_bits=32, ports=1)
    _check_all_lowerings(port_core.compile_trivial(pm),
                         ref_core.compile_trivial(rm, backend="numpy"))


@pytest.mark.parametrize("max_len,page,readers", [(64, 16, 4), (1024, 16, 8)])
def test_every_address_server_layouts(max_len, page, readers):
    from repro.runtime.server import page_solution as ref_page_solution

    port = page_solution(None, max_len, page, readers)
    ref = ref_page_solution(None, max_len, page, readers)
    assert port.layout == port_core.BankingLayout(
        dims=ref.layout.dims, pad=ref.layout.pad, n_banks=ref.layout.n_banks,
        bank_volume=ref.layout.bank_volume)
    ref_np = ref_core.CompiledBankingPlan.from_json(ref.to_json(),
                                                    backend="numpy")
    _check_all_lowerings(port, ref_np)


@pytest.mark.parametrize("max_len,page,readers,volume,shift", [
    (64, 16, 4, 16, 2), (1024, 16, 8, 128, 3)])
def test_server_program_is_three_terms(max_len, page, readers, volume,
                                       shift):
    """Both server layouts reach the kernels as ``BkTerms<3>``: ``volume *
    ((a >> 4) & (banks - 1)) + ((a >> log2 banks) & -16) + (a & 15)``,
    their six steps fused into four for the other sources."""
    art = page_solution(None, max_len, page, readers)
    w = bg.program_words(art)
    assert bg.kernel_source(art) == "BkTerms<3>"
    assert int(w[0]) == 4 < len(art.kernel_program().instrs) == 6
    at = T.kernel_program_words(8) - T.KERNEL_TERMS_WORDS
    base, terms = int(w[at + 1]), w[at + 2:at + 17].reshape(3, 5).tolist()
    banks = art.n_banks
    assert base == 0 and sorted(map(tuple, terms)) == sorted([
        (1, 0, 4, banks - 1, volume), (1, 0, shift, -16, 1),
        (1, 0, 0, 15, 1)])


_PAIRS = [("shr", "and"), ("shr", "shl"), ("shr", "shr"), ("and", "shr"),
          ("and", "and"), ("and", "shl"), ("shl", "shr"), ("mul", "and"),
          ("mul", "shr"), ("add", "shr"), ("sub", "and"), ("const", "shl")]


@pytest.mark.parametrize("first,second", _PAIRS)
def test_fused_steps_compute_what_the_two_steps_did(first, second):
    """A LINEAR step whose value only the next one reads is merged into it
    where one LINEAR step holds both; the merged step gives the two steps'
    value on int32 registers near both ends of the range, with shifts at
    their edges and negative masks.  A shift then a mask or a shift (the
    server's pairs) always merge."""
    rng = np.random.default_rng(len(first) * 7 + len(second))
    edge = np.array([0, 1, -1, 2 ** 31 - 1, -2 ** 31, 12345, -54321],
                    np.int64)
    regs = [np.concatenate([edge, rng.integers(-2 ** 31, 2 ** 31, 300)])
            .astype(np.int32) for _ in range(3)]
    imms = {"shr": [0, 1, 4, 31], "shl": [1, 4, 30], "and": [7, -16, 0xFF0],
            "mul": [3, -5], "const": [5], "add": [0], "sub": [0]}
    op = T.KERNEL_OPCODE
    merged = 0
    for i1 in imms[first]:
        for i2 in imms[second]:
            prog = [(op[first], 2, 0, 1, i1), (op[second], 2, 2, 0, i2)]
            want = T._interpret(prog, 3, regs)[2]
            packed = [T._packed_instr(*i) for i in prog]
            fused = T.fuse_linear_steps(packed, {2})
            got = T.run_packed_instrs(fused, [r.copy() for r in regs])[2]
            np.testing.assert_array_equal(got, want, err_msg=f"{i1} {i2}")
            merged += len(fused) == 1
            if first == "shr" and second != "shl" or \
                    (first, second) == ("shr", "shl") and i1 >= i2:
                assert len(fused) == 1, (i1, i2)
    assert merged


def test_a_value_read_twice_is_not_fused():
    """``shr`` read by an ``and`` and again by the ``add`` after it stays a
    step of its own; the ``and`` then merges into nothing."""
    op = T.KERNEL_OPCODE
    prog = [(op["shr"], 1, 0, 0, 4), (op["and"], 2, 1, 0, 7),
            (op["add"], 1, 1, 2, 0)]
    packed = [T._packed_instr(*i) for i in prog]
    assert T.fuse_linear_steps(packed, {1}) == [
        tuple(int(x) for x in p) for p in packed]
    regs = [np.arange(-50, 50, dtype=np.int32)] + [
        np.zeros(100, np.int32)] * 2
    np.testing.assert_array_equal(
        T.run_packed_instrs(T.fuse_linear_steps(packed, {1}),
                            [r.copy() for r in regs])[1],
        T._interpret(prog, 3, regs)[1])


# ---------------------------------------------------------------------------
# The kernel program: semantics at the edges, and its limits
# ---------------------------------------------------------------------------


def test_kernel_program_floors_and_shifts_like_python():
    """div/mod floor for negative dividends, shr is arithmetic, and NAF
    products come back from a transiently negative ``sub``."""
    x = T.var("x0")
    neg = T.const(0) - x
    roots = [T.raw_div(neg, 3), T.raw_mod(neg, 3), neg >> 1,
             T.mul_const(x, 7), T.raw_mod(x, -3), T.raw_div(x, -3)]
    prog = T.lower_kernel_program(roots, T.raw_mul(x, 5), 1)
    xs = np.arange(0, 200, dtype=np.int64)
    bas, bo = T.run_kernel_program(prog, [xs])
    want = [(-xs) // 3, (-xs) % 3, (-xs) >> 1, xs * 7, xs % -3, xs // -3]
    for got, w in zip(bas, want):
        np.testing.assert_array_equal(got, w)
    np.testing.assert_array_equal(bo, xs * 5)
    for root, w in zip(roots, want):     # and the torch lowering agrees
        got = T.lower_torch(root)(x0=torch.from_numpy(xs))
        np.testing.assert_array_equal(got.numpy(), w)


def test_kernel_program_shares_subexpressions_and_reuses_registers():
    x = T.var("x0")
    shared = T.mod_const(x, 7, in_bits=16)          # Crandall: a long chain
    prog = T.lower_kernel_program([shared], shared + shared, 1)
    alone = T.lower_kernel_program([shared], shared, 1)
    assert len(prog.instrs) == len(alone.instrs) + 1   # evaluated once
    assert prog.n_regs < len(prog.instrs)              # registers recycled


@pytest.mark.parametrize("what", ["program length", "shift", "immediate",
                                  "dimensions", "division by zero"])
def test_kernel_program_raises_beyond_its_limits(what):
    x = T.var("x0")
    if what == "program length":
        node = x
        for i in range(T.KERNEL_MAX_INSTRS + 1):
            node = node + (i + 1)
        build = lambda: T.lower_kernel_program([x], node, 1)
    elif what == "shift":
        build = lambda: T.lower_kernel_program([x], x << 32, 1)
    elif what == "immediate":
        build = lambda: T.lower_kernel_program([x], T.raw_mul(x, 1 << 31), 1)
    elif what == "dimensions":
        build = lambda: T.lower_kernel_program([x], x, T.KERNEL_MAX_DIMS + 1)
    else:
        build = lambda: T.lower_kernel_program([x], T.raw_div(x, 0), 1)
    with pytest.raises(ValueError):
        build()


# ---------------------------------------------------------------------------
# The packed program: the split's multipliers, the encoding, its capacities
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 2, 3, 5, 6, 7, 10, 12, 24, 60, 96, 127,
                               1024, 65535, 65536, 100003, (1 << 30) + 1,
                               (1 << 31) - 1])
def test_split_constants_divide_every_31_bit_dividend(d):
    """``(n * m) >> s == n // d`` in uint64 for every 31-bit n: the two ends,
    the multiples of d and their neighbours, and random draws."""
    m, s = T.split_constants(d)
    assert 0 < m < 1 << 32 and 31 <= s <= 62
    rng = np.random.default_rng(d)
    q = rng.integers(0, (1 << 31) // d, size=2000, dtype=np.int64)
    n = np.concatenate([rng.integers(0, 1 << 31, size=4000, dtype=np.int64),
                        q * d, q * d + d - 1, q * d - 1,
                        [0, 1, d - 1, d, (1 << 31) - 1]])
    n = n[(n >= 0) & (n < 1 << 31)].astype(np.uint64)
    got = (n * np.uint64(m)) >> np.uint64(s)
    np.testing.assert_array_equal(got, n // np.uint64(d))


@pytest.mark.parametrize("d", [0, 1 << 31])
def test_split_constants_refuse_what_the_kernels_cannot_split(d):
    with pytest.raises(ValueError):
        T.split_constants(d)


def test_packed_program_round_trips_the_kernel_program():
    """Header, instruction slots, split, fold and sum of terms at the
    offsets of ``BkLayout<8>`` in ``banked.cu``, for the server's layout
    (one dimension, one bank graph, six steps fused into four, four
    registers: the smallest bucket; three terms)."""
    art = page_solution(None, 1024, 16, 8)
    prog = art.kernel_program()
    w = bg.program_words(art)
    assert w is bg.program_words(art)                 # packed once
    assert T.kernel_bucket(prog) == (8, 4)
    assert w.size == T.kernel_program_words(8) == 8 + 4 * 8 + 24 + 16 + 22
    fused = T.fuse_linear_steps([T._packed_instr(*i) for i in prog.instrs],
                                set(prog.ba_regs) | {prog.bo_reg})
    n = len(fused)
    assert n == 4 < len(prog.instrs) == 6
    assert list(w[:T.KERNEL_HEADER_WORDS]) == [
        n, prog.n_regs, 1, 1, prog.bo_reg, 1024, art.bank_volume, 8]
    slots = w[8:8 + 32].reshape(8, 4)
    assert [tuple(int(x) for x in row) for row in slots[:n]] == [
        tuple(np.int64(v).astype(np.int32).item() for v in row)
        for row in fused]
    assert not slots[n:].any()
    split = w[40:64].reshape(8, 3)
    assert list(split[0].view(np.uint32)) == [1024, *T.split_constants(1024)]
    assert not split[1:].any()
    fold = w[64:80].reshape(8, 2)
    assert list(fold[0]) == [prog.ba_regs[0], 1] and not fold[1:].any()
    terms = w[80:102]
    assert list(terms[:2]) == [3, 0]
    assert sorted(tuple(t) for t in terms[2:17].reshape(3, 5).tolist()) == [
        (1, 0, 0, 15, 1), (1, 0, 3, -16, 1), (1, 0, 4, 7, 128)]
    assert not terms[17:].any()


@pytest.mark.parametrize("op", T.KERNEL_OPS)
def test_every_op_packs_into_what_it_computes(op):
    """Each op, packed (the LINEAR form or its own kind), against the
    reference interpreter on int32 registers near both ends of the range,
    with the immediates at their edges (shifts 0 and 31, negative masks and
    factors, divisors of either sign)."""
    rng = np.random.default_rng(len(op))
    edge = np.array([0, 1, -1, 2 ** 31 - 1, -2 ** 31, 12345, -54321],
                    np.int64)
    regs = [np.concatenate([edge, rng.integers(-2 ** 31, 2 ** 31, 200)])
            .astype(np.int32) for _ in range(3)]
    code = T.KERNEL_OPCODE[op]
    imms = {"const": [0, 7, -9, 2 ** 31 - 1], "shl": [0, 1, 13, 31],
            "shr": [0, 1, 13, 31], "and": [0, 15, -16, 2 ** 31 - 1],
            "mul": [0, 3, -5, 2 ** 20 + 1], "div": [1, 3, -7, 2 ** 30],
            "mod": [1, 3, -7, 2 ** 30]}.get(op, [2])
    for imm in imms:
        ins = (code, 2, 0, 1, imm)
        want = T._interpret([ins], 3, regs)[2]
        got = T.run_packed_instrs([T._packed_instr(*ins)],
                                  [r.copy() for r in regs])[2]
        np.testing.assert_array_equal(got, want, err_msg=f"{op} {imm}")


@pytest.mark.parametrize("n_instrs,n_regs,cap", [
    (1, 1, (8, 4)), (6, 4, (8, 4)), (8, 4, (8, 4)), (9, 4, (32, 16)),
    (6, 5, (32, 16)), (32, 16, (32, 16)), (33, 4, (192, 32)),
    (87, 11, (192, 32)), (192, 32, (192, 32))])
def test_kernel_bucket_is_the_smallest_that_holds_the_program(
        n_instrs, n_regs, cap):
    prog = T.KernelProgram(n_vars=1, instrs=((0, 0, 0, 0, 0),) * n_instrs,
                           ba_regs=(0,), bo_reg=0, n_regs=n_regs)
    assert T.kernel_bucket(prog) == cap


def test_kernel_bucket_refuses_more_than_it_holds():
    for n_instrs, n_regs in ((193, 4), (4, 33)):
        prog = T.KernelProgram(n_vars=1, instrs=((0, 0, 0, 0, 0),) * n_instrs,
                               ba_regs=(0,), bo_reg=0, n_regs=n_regs)
        with pytest.raises(ValueError):
            T.kernel_bucket(prog)
