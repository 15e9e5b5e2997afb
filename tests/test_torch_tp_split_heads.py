"""Tensor parallelism with head-misaligned cuts: the attention weights cut
by ``param_specs`` over ``model`` off head boundaries, in worlds of CPU
``gloo`` processes, against the JAX package on a mesh of XLA host devices
whose parameters are placed by its own ``param_specs``
(``tests/torch_tp.py``).

Odd head counts on a ``model`` axis of 2 split heads: the reduced
qwen2-7b with 3 heads and 1 kv head (``wq`` 96 columns, 48 a rank: 1.5
heads; ``wk``/``wv``/``bk``/``bv`` half a head), and the reduced
olmoe-1b-7b with 3 heads and 3 kv heads, 4 experts, top 2, through
``sorted`` at a capacity factor of 1.0 (its inputs keep the routing
margin, ROADMAP F9).  The kv heads do not bank over 2, so ``cache_specs``
cuts the cache on its positions: 12 of ``MESH_MAX_LEN`` 24 a rank, every
kv head.  Each layer gathers q, k and v whole, attends on the heads its
``wo`` rows touch (2 for 1.5) and sums its channels' products over
``model``; a decode step merges the ranks' partial softmax.  Each case
runs in a world of 2 ranks (``model`` 2) and of 4 (``data`` 2 x ``model``
2).  Compared, as in ``tests/test_torch_tensor_parallel.py``: the blocks
and bytes a rank and of its cache against the dry-run, the loss, every
gradient leaf joined per spec, the prefill's logits and its cache joined
per ``cache_specs``, three serve steps across the prompt's end, and one
``make_train_step``.  Tolerances: bf16 2e-2 of max(1, |ref|), a cosine
above 0.999 for every gradient leaf, a token held where the reference's
top-2 gap exceeds twice the bound.
"""

import pytest

import torch_tp
from torch_worlds import MESH_MAX_LEN

CASES = {
    "qwen2_split": dict(arch="qwen2_7b", impl="sorted",
                        replace=dict(n_heads=3, n_kv_heads=1)),
    "olmoe_split": dict(arch="olmoe_1b_7b", impl="sorted",
                        replace=dict(n_experts=4, top_k=2,
                                     capacity_factor=1.0, n_heads=3,
                                     n_kv_heads=3)),
}
WORLDS = torch_tp.WORLDS
CUT = ["layers/wq", "layers/wk", "layers/wv", "layers/wo", "embed",
       "lm_head"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return torch_tp.run(tmp_path_factory.mktemp("tp_split_heads"), CASES)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_the_reference_runs_its_tensor_parallel_program(runs, name, world):
    torch_tp.check_reference_cuts(runs, name, world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_exactly_its_blocks(runs, name, world):
    """Beside the blocks and bytes: ``wq`` is 1.5 heads a rank, ``wk``
    half a head (qwen2) or 1.5 (olmoe), and the cache every kv head of
    half the positions."""
    torch_tp.check_blocks(runs, name, CASES[name], world, CUT)
    cfg = torch_tp.config(CASES[name])
    for got in runs["worlds"][world]:
        assert got[f"{name}/shape/layers/wq"][-1] == 3 * cfg.hd // 2
        assert got[f"{name}/shape/layers/wk"][-1] == \
            cfg.n_kv_heads * cfg.hd // 2
        L, _, rows, heads, _ = got[f"{name}/cache/k"].shape
        assert (rows, heads) == (MESH_MAX_LEN // 2, cfg.n_kv_heads)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_loss_matches_the_reference(runs, name, world):
    torch_tp.check_loss(runs, name, world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_the_reference(runs, name, world):
    """A head two ranks touch takes both ranks' cotangents through the
    gathers' reduce-scatter."""
    torch_tp.check_gradients(runs, name, CASES[name], world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_prefill_matches_the_reference(runs, name, world):
    torch_tp.check_prefill(runs, name, CASES[name], world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_decode_matches_the_reference(runs, name, world):
    assert torch_tp.check_decode(runs, name, world, CASES[name]), \
        "no token clear of the bound to hold"


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_one_train_step_matches_the_reference(runs, name, world):
    torch_tp.check_train_step(runs, name, CASES[name], world)
