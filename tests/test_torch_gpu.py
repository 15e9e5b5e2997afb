"""The CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and ``nvcc`` (the kernels have no CPU mode)
and skip where there is none; run them on a GPU machine with

    PYTHONPATH=src python -m pytest tests/test_torch_gpu.py -m gpu -q

``python3 chip_smoke.py`` holds the kernels to the same comparison over more
dtypes and widths and also drives the server."""

import numpy as np
import pytest
import torch

import repro_torch.core as port_core
from repro_torch.kernels import banked_gather as bg
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_dispatch as md
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_chunk as sc
from repro_torch.models import moe
from repro_torch.runtime.server import page_solution

from torch_parity import (CHUNK_LAYOUTS, LAYOUT_CASES, build_artifact,
                          chunk_views, layout_id)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on a GPU")
    return torch.device("cuda")


def _int_rows(rng, n, D, device):
    return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, size=(n, D))
                            .astype(np.int32)).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 32, 1024, 1025, 4096, bg.SCATTER_MAX_T])
def test_gather_and_row_scatter_at_every_size(cuda, T):
    """The server's layout, rows of 8 int32, random addresses with
    duplicates: one block up to 1024 writes, the winner table past it, up
    to ``SCATTER_MAX_T``; one launch a call."""
    art = page_solution(None, 1024, 16, 8)
    rng = np.random.default_rng(T)
    flat = _int_rows(rng, 1024, 8, cuda)
    table = art.pack(flat)
    idx = torch.from_numpy(rng.integers(0, 1024, size=T)).to(cuda)
    vals = _int_rows(rng, T, 8, cuda)
    before = dict(bg.LAUNCHES)
    assert torch.equal(art.gather(table, idx), flat[idx])
    mine, theirs = table.clone(), table.clone()
    art.scatter(mine, idx, vals)
    bg.banked_scatter_plain(theirs, idx, vals, art)
    torch.cuda.synchronize()
    assert torch.equal(mine, theirs)
    assert bg.LAUNCHES["banked_gather"] == before["banked_gather"] + 1
    assert bg.LAUNCHES["banked_scatter"] == before["banked_scatter"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("T,distinct", [(1024, 64), (4096, 64), (4096, 2),
                                        (3000, 1)])
def test_many_writes_to_few_addresses_last_one_wins(cuda, T, distinct):
    """T writes over a few addresses, held to a sequential loop on the host:
    rows (B3) and single elements (B2).  Over one or two addresses a block
    owns more writes than it keeps in shared memory and takes the winner
    table."""
    art = page_solution(None, 1024, 16, 8)
    rng = np.random.default_rng(T + distinct)
    flat = _int_rows(rng, 1024, 8, cuda)
    table = art.pack(flat)
    idx = rng.choice(1024, size=distinct, replace=False)[
        rng.integers(0, distinct, size=T)]
    vals = _int_rows(rng, T, 8, cuda)
    cols = rng.integers(0, 8, size=T)
    want_rows = flat.cpu().numpy().copy()
    want_elems = want_rows.copy()
    v = vals.cpu().numpy()
    for t in range(T):
        want_rows[idx[t]] = v[t]
        want_elems[idx[t], cols[t]] = v[t, 0]
    got_rows = art.unpack(art.scatter(table.clone(), idx, vals))
    got_elems = art.unpack(art.scatter(table.clone(), idx, vals[:, 0],
                                       col=cols))
    assert np.array_equal(got_rows.cpu().numpy(), want_rows)
    assert np.array_equal(got_elems.cpu().numpy(), want_elems)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [8, 2000])
def test_out_of_range_indices_on_the_card(cuda, T):
    """Addresses already on the card outside [0, 1024): the gather gives
    zero rows, both scatters drop the write (one block and winner table)."""
    art = page_solution(None, 1024, 16, 8)
    rng = np.random.default_rng(T)
    flat = _int_rows(rng, 1024, 8, cuda)
    table = art.pack(flat)
    idx = rng.integers(0, 1024, size=T)
    bad = rng.random(T) < 0.3
    idx[bad] = rng.choice([-1, -5000, 1024, 1 << 30], size=int(bad.sum()))
    on_card = torch.from_numpy(idx).to(cuda)
    got = art.gather(table, on_card)
    good = torch.from_numpy(~bad).to(cuda)
    assert bool((got[~good] == 0).all())
    assert torch.equal(got[good], flat[on_card[good]])
    vals = _int_rows(rng, T, 8, cuda)
    mine, theirs = table.clone(), table.clone()
    art.scatter(mine, on_card, vals)
    bg.banked_scatter_plain(theirs, on_card[good], vals[good], art)
    assert torch.equal(mine, theirs)
    cols = torch.from_numpy(rng.integers(0, 8, size=T)).to(cuda)
    art.scatter(mine, on_card, vals[:, 0], col=cols)
    bg.banked_scatter_elems_plain(theirs, on_card[good], cols[good],
                                  vals[good, 0], art)
    torch.cuda.synchronize()
    assert torch.equal(mine, theirs)


@pytest.mark.gpu
def test_repeated_scatters_on_two_artifacts_in_turn(cuda):
    """Calls in a row on one table and two artifacts alternating (the server's
    layout and a multidim one): 3000 writes over 2 addresses (a block
    overflows into the winner table), 3000 over 40 and 700 over 40 (shared
    memory only), in turn.  Each call equals the plain version, so the
    winner table is left as the next call needs it."""
    arts = [page_solution(None, 1024, 16, 8),
            build_artifact(port_core, LAYOUT_CASES[8], backend="torch")]
    rng = np.random.default_rng(3)
    tables = [a.pack(_int_rows(rng, a.layout.logical_size, 8, cuda))
              for a in arts]
    plain = [t.clone() for t in tables]
    for call in range(12):
        art, i = arts[call % 2], call % 2
        A = art.layout.logical_size
        T, distinct = ((3000, 2), (3000, 40), (700, 40))[call // 2 % 3]
        idx = torch.from_numpy(rng.choice(A, size=distinct)[
            rng.integers(0, distinct, size=T)]).to(cuda)
        vals = _int_rows(rng, T, 8, cuda)
        art.scatter(tables[i], idx, vals)
        bg.banked_scatter_plain(plain[i], idx, vals, art)
        torch.cuda.synchronize()
        assert torch.equal(tables[i], plain[i]), call


def _elems_case(art, rng, idx, cols, D, cuda):
    """B2 on the card against a sequential host loop (last write wins in
    index order; writes out of range dropped) and against the plain
    version on the writes in range; one launch."""
    A = art.layout.logical_size
    flat = _int_rows(rng, A, D, cuda)
    table = art.pack(flat)
    T = len(idx)
    vals = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, size=T)
                            .astype(np.int32)).to(cuda)
    want = flat.cpu().numpy().copy()
    v = vals.cpu().numpy()
    for t in range(T):
        if 0 <= idx[t] < A and 0 <= cols[t] < D:
            want[idx[t], cols[t]] = v[t]
    before = bg.LAUNCHES["banked_scatter_elems"]
    mine = art.scatter(table.clone(), torch.from_numpy(idx).to(cuda), vals,
                       col=torch.from_numpy(cols).to(cuda))
    good = (idx >= 0) & (idx < A) & (cols >= 0) & (cols < D)
    theirs = bg.banked_scatter_elems_plain(
        table.clone(), torch.from_numpy(idx[good]).to(cuda),
        torch.from_numpy(cols[good]).to(cuda),
        vals[torch.from_numpy(good).to(cuda)], art)
    torch.cuda.synchronize()
    assert bg.LAUNCHES["banked_scatter_elems"] == before + 1
    assert torch.equal(mine, theirs)
    assert np.array_equal(art.unpack(mine).cpu().numpy(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 31, 32, 33, 46, 100, 128, 129, 8000])
def test_elems_scatter_equals_a_host_loop(cuda, T):
    """One warp up to 32 writes (the tick), one block up to 128 (a flush
    after short prompts), blocks past it: random (address, column) pairs
    with duplicates, and at 8,000 the admit flush's distinct pairs
    (positions 0-999 x slots 0-7, slot-major)."""
    art = page_solution(None, 1024, 16, 8)
    rng = np.random.default_rng(T)
    if T == 8000:
        idx, cols = np.tile(np.arange(1000), 8), np.repeat(np.arange(8), 1000)
    else:
        idx, cols = rng.integers(0, 40, size=T), rng.integers(0, 3, size=T)
    _elems_case(art, rng, idx, cols, 8, cuda)


@pytest.mark.gpu
def test_elems_scatter_of_65536_writes_over_24_pairs(cuda):
    """``SCATTER_MAX_T`` writes over 3 addresses x 8 columns: a few blocks
    own all of them and walk them in windows."""
    art = page_solution(None, 1024, 16, 8)
    rng = np.random.default_rng(24)
    idx = rng.choice(1024, size=3, replace=False)[
        rng.integers(0, 3, size=bg.SCATTER_MAX_T)]
    _elems_case(art, rng, idx, rng.integers(0, 8, size=idx.size), 8, cuda)


@pytest.mark.gpu
def test_elems_scatter_when_one_block_owns_more_than_its_hash_holds(cuda):
    """4,096 writes over 3,000 distinct pairs of a table 128 wide, every
    one owned by block 0 (more pairs than its hash has slots): the block
    goes by windows.  The split is the library's own."""
    art = page_solution(None, 1024, 16, 8)
    rng = np.random.default_rng(3000)
    lib = bg._library()
    T, D = 4096, 128
    nb = bg.elems_blocks(T)
    assert lib.bk_elems_blocks(T) == nb
    owned = np.flatnonzero(bg.pair_owner(np.arange(1024 * D), nb) == 0)
    assert all(lib.bk_elems_owner(int(k), nb) == 0 for k in owned[:64])
    keys = rng.choice(owned, size=3000, replace=False)
    keys = keys[np.concatenate([rng.permutation(3000),
                                rng.integers(0, 3000, size=T - 3000)])]
    assert 3000 > 1 << bg.ELEMS_HASH_BITS
    _elems_case(art, rng, keys // D, keys % D, D, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [20, 100, 3000])
def test_elems_scatter_drops_addresses_and_columns_out_of_range(cuda, T):
    """Addresses and columns already on the card outside their ranges (not
    inspected by the wrapper): those writes are dropped, in the warp, the
    one block and the blocks."""
    art = page_solution(None, 1024, 16, 8)
    rng = np.random.default_rng(T + 1)
    idx, cols = rng.integers(0, 1024, size=T), rng.integers(0, 8, size=T)
    bad = rng.random(T) < 0.3
    idx[bad] = rng.choice([-1, 1024, 1 << 30], size=int(bad.sum()))
    worse = rng.random(T) < 0.2
    cols[worse] = rng.choice([-1, 8, 1 << 20], size=int(worse.sum()))
    _elems_case(art, rng, idx, cols, 8, cuda)


@pytest.mark.gpu
def test_repeated_elems_scatters_on_two_artifacts_in_turn(cuda):
    """B2 in calls in a row on two tables of two artifacts alternating (the
    server's layout and a multidim one), at 20, 3000 and 5000 writes in
    turn: each call equals the plain version; nothing carries over."""
    arts = [page_solution(None, 1024, 16, 8),
            build_artifact(port_core, LAYOUT_CASES[8], backend="torch")]
    rng = np.random.default_rng(5)
    tables = [a.pack(_int_rows(rng, a.layout.logical_size, 8, cuda))
              for a in arts]
    plain = [t.clone() for t in tables]
    for call in range(12):
        art, i = arts[call % 2], call % 2
        T = (20, 3000, 5000)[call // 2 % 3]
        idx = torch.from_numpy(rng.integers(0, min(art.layout.logical_size,
                                                   50), size=T)).to(cuda)
        cols = torch.from_numpy(rng.integers(0, 8, size=T)).to(cuda)
        vals = _int_rows(rng, T, 1, cuda)[:, 0]
        art.scatter(tables[i], idx, vals, col=cols)
        bg.banked_scatter_elems_plain(plain[i], idx, cols, vals, art)
        torch.cuda.synchronize()
        assert torch.equal(tables[i], plain[i]), call


@pytest.mark.gpu
@pytest.mark.parametrize("level", ["full", "basic"])
@pytest.mark.parametrize("case", LAYOUT_CASES, ids=layout_id)
def test_kernels_equal_plain_versions_on_the_card(cuda, case, level):
    art = build_artifact(port_core, case, backend="torch", level=level)
    A = art.layout.logical_size
    rng = np.random.default_rng(0)
    flat = torch.from_numpy(rng.normal(size=(A, 8)).astype(np.float32))
    table = art.pack(flat, device=cuda)
    before = dict(bg.LAUNCHES)

    every = torch.arange(A, device=cuda)
    assert torch.equal(art.gather(table, every), flat.to(cuda))
    idx = torch.from_numpy(rng.integers(0, A, size=64)).to(cuda)
    vals = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32)
                            ).to(cuda)
    cols = torch.from_numpy(rng.integers(0, 8, size=64)).to(cuda)
    mine, theirs = table.clone(), table.clone()
    art.scatter(mine, idx, vals)
    bg.banked_scatter_plain(theirs, idx, vals, art)
    assert torch.equal(mine, theirs)
    art.scatter(mine, idx, vals[:, 0], col=cols)
    bg.banked_scatter_elems_plain(theirs, idx, cols, vals[:, 0], art)
    assert torch.equal(mine, theirs)
    torch.cuda.synchronize()
    assert all(bg.LAUNCHES[k] == before[k] + 1 for k in before)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [16, 2048])
def test_moe_dispatch_equals_its_plain_version_on_the_card(cuda, dtype, D):
    rng = np.random.default_rng(D)
    T, E, K = 64, 8, 2
    C = 16                          # below T * K / E = 16 on average: drops
    x = torch.from_numpy(rng.normal(size=(T, D)).astype(np.float32)).to(
        device=cuda, dtype=dtype)
    top_i = torch.from_numpy(np.stack(
        [rng.permutation(E)[:K] for _ in range(T)])).to(cuda)
    slot, *_, keep = moe.dispatch_slots(top_i, C, E)
    x_padded = torch.cat([x, x.new_zeros((1, D))])
    before = md.LAUNCHES["moe_dispatch"]
    want = md.moe_dispatch_plain(x_padded, slot)
    assert torch.equal(md.moe_dispatch(x_padded, slot), want)
    assert torch.equal(ops.dispatch(x, slot), want)
    bad = torch.tensor([-1, T + 1, 3], device=cuda, dtype=torch.int32)
    got = md.moe_dispatch(x_padded, bad)
    assert bool((got[:2] == 0).all()) and torch.equal(got[2], x[3])
    torch.cuda.synchronize()
    assert md.LAUNCHES["moe_dispatch"] == before + 3
    assert not bool(keep.all())


@pytest.mark.gpu
@pytest.mark.parametrize("layout", CHUNK_LAYOUTS)
@pytest.mark.parametrize("P,N", [(16, 16), (64, 64), (64, 128)])
@pytest.mark.parametrize("Q", [1, 7, 16, 100, 256])
def test_ssd_chunk_equals_its_plain_version_on_the_card(cuda, Q, P, N,
                                                        layout):
    """Within 1e-4 of the largest magnitude of the plain output, which runs
    in true float32 (``allow_tf32`` off, the default), at the (P, N) of
    both models and in each of ``CHUNK_LAYOUTS``; one launch, and one copy
    only for the offset view."""
    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(Q * P + N)
    B, H = 2, 3
    dt = rng.uniform(0.01, 0.3, size=(B, H, Q))
    dt[0, 0] = rng.uniform(0.0, 1e-6, size=Q)          # dt near 0
    dt[1, 2] = rng.uniform(4.0, 8.0, size=Q)           # dt large: 1000 nats
    A = -rng.uniform(0.5, 2.0, size=(H,))
    f32 = {"x": rng.normal(size=(B, H, Q, P)), "dt": dt,
           "bm": rng.normal(size=(B, Q, N)), "cm": rng.normal(size=(B, Q, N)),
           "cum": np.cumsum(dt * A[None, :, None], axis=-1),
           "s_prev": rng.normal(size=(B, H, P, N))}
    args = chunk_views({k: torch.from_numpy(v.astype(np.float32)).to(cuda)
                        for k, v in f32.items()}, layout)
    before = sc.LAUNCHES["ssd_chunk"]
    copies = sc.COPIES["ssd_chunk"]
    y, s = sc.ssd_chunk(**args)
    yw, sw = sc.ssd_chunk_plain(**args)
    torch.cuda.synchronize()
    assert sc.LAUNCHES["ssd_chunk"] == before + 1
    assert sc.COPIES["ssd_chunk"] == copies + (layout == "offset view")
    for got, want in ((y, yw), (s, sw)):
        assert bool(torch.isfinite(got).all())
        tol = 1e-4 * float(want.abs().max())
        assert float((got - want).abs().max()) <= tol
    assert torch.equal(ops.ssd(**args)[0], y)          # deterministic


@pytest.mark.gpu
def test_the_ssd_chunk_kernel_fits_the_sm(cuda):
    """One block a SM of three warpgroups, with all of its shared memory
    (three raw stages, two split buffers): the runtime's own report."""
    info = sc.kernel_info()
    assert info["blocks_per_sm"] == 1
    assert 0 < info["registers"] <= 168
    assert info["shared_bytes"] <= 232448


@pytest.mark.gpu
@pytest.mark.parametrize("slots", [512, 81920], ids=["decode", "prefill"])
def test_moe_dispatch_is_bit_exact_at_olmoes_sizes(cuda, slots):
    """olmoe's decode call (8 tokens of 2048 bf16, 512 slots: rows cut in
    pieces across the card) and a prefill-sized dispatch (81,920 slots):
    bit for bit the plain version and ``index_select``, empty slots
    zero."""
    rng = np.random.default_rng(slots)
    T = 8 if slots == 512 else 8192
    x = torch.from_numpy(rng.normal(size=(T, 2048)).astype(np.float32)).to(
        device=cuda, dtype=torch.bfloat16)
    x_padded = torch.cat([x, x.new_zeros((1, 2048))])
    slot = torch.from_numpy(rng.integers(0, T + 1, size=slots).astype(
        np.int32)).to(cuda)
    before = md.LAUNCHES["moe_dispatch"]
    got = md.moe_dispatch(x_padded, slot)
    torch.cuda.synchronize()
    assert md.LAUNCHES["moe_dispatch"] == before + 1
    assert torch.equal(got, md.moe_dispatch_plain(x_padded, slot))
    assert torch.equal(got, torch.index_select(x_padded, 0, slot))
    assert bool((got[slot == T] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["contiguous", "offset view"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32), (False, 0)],
                         ids=["causal", "window", "full"])
@pytest.mark.parametrize("D", [64, 72, 80, 128, 240])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_equals_its_plain_version_on_the_card(
        cuda, dtype, D, causal, window, layout):
    """Within 2e-5 (float32) or 2e-2 (bfloat16) of the largest magnitude of
    the plain output, which runs in true float32 (``allow_tf32`` off, the
    default); 7 query heads over one kv head, ragged 100-row tiles.  In
    bf16, D 72 and a q one element past an aligned base go through one
    aligned copy (``COPIES``); the head sizes of the models do not."""
    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(D)
    B, S, Hkv, rep = 2, 100, 1, 7
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(device=cuda, dtype=dtype)
               for shape in ((B, S, Hkv * rep, D), (B, S, Hkv, D),
                             (B, S, Hkv, D)))
    if layout == "offset view":
        flat = torch.zeros(q.numel() + 1, device=cuda, dtype=dtype)
        flat[1:] = q.reshape(-1)
        q = flat[1:].view(q.shape)
    before = fa.LAUNCHES["flash_attention"]
    copies = fa.COPIES["flash_attention"]
    got = ops.mha(q, k, v, causal=causal, window=window)
    want = fa.mha_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    copied = dtype == torch.bfloat16 and (D % 16 or layout != "contiguous")
    assert fa.COPIES["flash_attention"] == copies + int(bool(copied))
    assert got.dtype == dtype and tuple(got.shape) == tuple(q.shape)
    assert bool(torch.isfinite(got.float()).all())
    tol = (2e-5 if dtype == torch.float32 else 2e-2) * max(
        1.0, float(want.float().abs().max()))
    assert float((got.float() - want.float()).abs().max()) <= tol
    assert torch.equal(ops.mha(q, k, v, causal=causal, window=window), got)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 80, 128, 240])
def test_the_bf16_flash_attention_kernel_fits_the_sm(cuda, D):
    """One block a SM of 384 threads: the runtime's own report."""
    info = fa.kernel_info(D)
    assert info["blocks_per_sm"] >= 1
    assert 0 < info["registers"] <= 168
    assert info["shared_bytes"] <= 232448


@pytest.mark.gpu
@pytest.mark.parametrize("kw,S,row0", [
    (dict(kv_len=0), 8, 0), (dict(causal=False, window=2, kv_len=4), 8, 5),
    (dict(causal=True, window=3, kv_len=2), 8, 4),
    (dict(causal=True, window=40, kv_len=50), 100, 89)],
    ids=["kv_len0", "window-full", "window-causal", "window-long"])
@pytest.mark.parametrize("D", [64, 72])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rows_that_see_no_key_equal_the_plain_version(cuda, dtype, D, kw, S,
                                                      row0):
    """Rows that see no key get the mean of v over all keys (the JAX
    oracle's rows), from ``fa_blind_rows``; the attention kernel runs over
    the rows before them (none when kv_len is 0).  S query rows and keys,
    4 query heads on 2 kv heads; tolerances as above."""
    rng = np.random.default_rng(D + row0)
    B, H, Hkv = 2, 4, 2
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(device=cuda, dtype=dtype)
               for shape in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    launches = fa.LAUNCHES["flash_attention"]
    blind = fa.BLIND_LAUNCHES["flash_attention"]
    got = ops.mha(q, k, v, **kw)
    want = fa.mha_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.first_blind_row(S, min(kw["kv_len"], S), kw.get("window", 0)
                              ) == row0
    assert fa.BLIND_LAUNCHES["flash_attention"] == blind + 1
    assert fa.LAUNCHES["flash_attention"] == launches + int(row0 > 0)
    tol = (2e-5 if dtype == torch.float32 else 2e-2) * max(
        1.0, float(want.float().abs().max()))
    assert float((got.float() - want.float()).abs().max()) <= tol
