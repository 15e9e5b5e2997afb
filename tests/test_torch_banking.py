"""Banking math of the port against the reference: same solutions from the
solver, and the same BA/BO for EVERY logical address from each lowering of
the resolution circuit (numpy int64, torch, and the int32 register program
the CUDA kernels interpret)."""

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
