"""Tensor parallelism of the encoder-decoder: the reduced whisper-base
with its weights cut by ``param_specs`` over ``model``, in worlds of CPU
``gloo`` processes, against the JAX package on a mesh of XLA host
devices whose parameters are placed by its own ``param_specs``
(``tests/torch_tp.py``).

Two cases: the reduced config (vocab 512: ``embed`` cut on the
vocabulary, the logits and the loss vocabulary-parallel) and the same
with a vocabulary of 511, which does not divide, so ``embed`` stays
whole in every rank, as whisper's 51,865 does at full width.  In both,
the self and cross attention run on a rank's heads (4 and 2 kv heads, so
2 and 1 a rank), ``wo`` and the MLP end with the row-parallel sum and
``b_down`` is added once after it.  Each case runs in a world of 2 ranks
(``model`` 2) and of 4 (``data`` 2 x ``model`` 2) under the dry-run's
policies, whose train and prefill ``"residual"`` cuts the sequence of
the frames and of the tokens.  Compared: every rank's blocks and bytes
and its caches' against the dry-run, the loss, every gradient leaf
(joined per spec), the prefill's logits and its self and cross caches
(the ranks' kv heads joined), three serve steps and one
``make_train_step``.

Without worlds: whisper-base's full-width blocks on ``model`` 2 and 4
on ``meta`` against the dry-run (``embed`` whole); with whole weights
and no mesh, every output ``torch.equal`` to the functions as they stood
before the encoder-decoder was cut (``tests/torch_parent_layers.py``).
"""

import pytest

import torch_tp

CASES = {
    "whisper": dict(arch="whisper_base", replace={}),
    "whisper_511": dict(arch="whisper_base", replace={"vocab": 511}),
}
CUT = ["enc/attn/wq", "enc/attn/wk", "enc/attn/wo", "enc/mlp/w_up",
       "enc/mlp/b_up", "enc/mlp/w_down", "dec/self/wq", "dec/cross/wk",
       "dec/cross/wo", "dec/mlp/w_down"]
WORLDS = torch_tp.WORLDS


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return torch_tp.run(tmp_path_factory.mktemp("tp_encdec"), CASES)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_the_reference_runs_its_tensor_parallel_program(runs, name, world):
    torch_tp.check_reference_cuts(runs, name, world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_exactly_its_blocks(runs, name, world):
    """Beside the blocks and bytes: ``embed`` is cut where the vocabulary
    divides and whole where it does not, and ``b_down`` whole."""
    torch_tp.check_blocks(runs, name, CASES[name], world,
                          CUT + (["embed"] if name == "whisper" else []))
    specs = torch_tp.specs_of(CASES[name], world)
    assert ("model" in str(specs["embed"])) == (name == "whisper")
    assert "model" not in str(specs["enc/mlp/b_down"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_loss_matches_the_reference(runs, name, world):
    torch_tp.check_loss(runs, name, world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_the_reference(runs, name, world):
    torch_tp.check_gradients(runs, name, CASES[name], world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_prefill_matches_the_reference(runs, name, world):
    torch_tp.check_prefill(runs, name, CASES[name], world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_decode_matches_the_reference(runs, name, world):
    torch_tp.check_decode(runs, name, world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_one_train_step_matches_the_reference(runs, name, world):
    torch_tp.check_train_step(runs, name, CASES[name], world)


# ---------------------------------------------------------------------------
# Without worlds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_full_width_blocks_are_what_the_specs_imply(n):
    """Every attention and MLP weight of whisper-base is cut at full
    width; its vocabulary of 51,865 does not divide, so ``embed`` stays
    whole."""
    cut = torch_tp.check_full_width_blocks("whisper_base", n)
    assert set(CUT) <= cut
    assert "embed" not in cut


def test_a_cache_cut_per_cache_specs_joins_back():
    from repro_torch.configs import get_arch

    torch_tp.check_cache_roundtrip(get_arch("whisper_base").reduced())


@pytest.mark.parametrize("vocab", [512, 511])
def test_whole_weights_give_the_earlier_outputs_bit_for_bit(vocab,
                                                            monkeypatch):
    torch_tp.check_whole_weights_bit_for_bit("whisper_base", monkeypatch,
                                             {"vocab": vocab})
