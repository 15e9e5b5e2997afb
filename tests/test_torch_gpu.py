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
from repro_torch.kernels import moe_dispatch as md
from repro_torch.kernels import ops
from repro_torch.models import moe

from torch_parity import LAYOUT_CASES, build_artifact, layout_id


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
