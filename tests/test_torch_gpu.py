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

from torch_parity import (CHUNK_LAYOUTS, LAYOUT_CASES, build_artifact,
                          chunk_views, layout_id)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on a GPU")
    return torch.device("cuda")


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
