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

from torch_parity import LAYOUT_CASES, build_artifact, layout_id


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the banked kernels run only on a GPU")
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
