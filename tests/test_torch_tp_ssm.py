"""Tensor parallelism of the SSM and hybrid families: the reduced
mamba2-370m and zamba2-2.7b with their weights cut by ``param_specs``
over ``model``, in worlds of CPU ``gloo`` processes, against the JAX
package on a mesh of XLA host devices whose parameters are placed by its
own ``param_specs`` (``tests/torch_tp.py``).

At the reduced size ``in_proj`` has 560 output columns and ``conv_w`` 288
channels, so on a ``model`` axis of 2 rank 0's blocks end 24 and 144
channels into ``x``: the contiguous cuts do not fall on heads, and the
block bridges them with its two gathers.  Each case runs in a world of 2
ranks (``model`` 2) and of 4 (``data`` 2 x ``model`` 2) under the
dry-run's policies, whose train and prefill ``"residual"`` cuts the
channels.  Compared: every rank's blocks and bytes and its cache's
against the dry-run, the loss, every gradient leaf (joined per spec), the
prefill's logits and cache (joined per ``cache_specs``: the conv tails'
channels, the states' heads, the hybrid's kv heads), three serve steps
and one ``make_train_step``.

Without worlds: the full-width blocks of mamba2-370m and zamba2-2.7b on
``model`` 2 and 4 on ``meta`` against the dry-run; the refusal of an SSM
cut that splits a head; with whole weights and no mesh, every output
``torch.equal`` to the functions as they stood before the channel cut
(``tests/torch_parent_layers.py``).
"""

import dataclasses

import pytest

import torch_tp

CASES = {
    "mamba2": dict(arch="mamba2_370m", replace={}),
    "zamba2": dict(arch="zamba2_2_7b", replace={}),
}
CUT = {"mamba2": ["layers/in_proj", "layers/conv_w", "layers/conv_b",
                  "layers/A_log", "layers/D_skip", "layers/dt_bias",
                  "layers/gate_ln", "layers/out_proj", "embed"],
       "zamba2": ["ssm/in_proj", "ssm/conv_w", "ssm/out_proj",
                  "ssm/gate_ln", "shared_attn/wq", "shared_attn/wk",
                  "shared_attn/wo", "shared_attn/w_down", "embed"]}
WORLDS = torch_tp.WORLDS


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return torch_tp.run(tmp_path_factory.mktemp("tp_ssm"), CASES)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_the_reference_runs_its_tensor_parallel_program(runs, name, world):
    torch_tp.check_reference_cuts(runs, name, world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_exactly_its_blocks(runs, name, world):
    torch_tp.check_blocks(runs, name, CASES[name], world, CUT[name])


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
@pytest.mark.parametrize("arch", ["mamba2_370m", "zamba2_2_7b"])
def test_full_width_blocks_are_what_the_specs_imply(arch, n):
    """Every SSM leaf is cut at full width, and so is the shared block's
    attention: mamba2's ``in_proj`` into blocks of 4384 / n columns, its
    conv into 2304 / n channels, its 32 heads into 32 / n."""
    cut = torch_tp.check_full_width_blocks(arch, n)
    prefix = "layers" if arch == "mamba2_370m" else "ssm"
    for leaf in ("in_proj", "conv_w", "conv_b", "A_log", "D_skip", "dt_bias",
                 "gate_ln", "out_proj"):
        assert f"{prefix}/{leaf}" in cut, leaf
    if arch == "zamba2_2_7b":
        assert {"shared_attn/wq", "shared_attn/wk", "shared_attn/wv",
                "shared_attn/wo", "shared_attn/w_gate", "shared_attn/w_up",
                "shared_attn/w_down"} <= cut


@pytest.mark.parametrize("leaf", ["gate_ln", "out_proj"])
def test_an_ssm_cut_that_splits_a_head_raises(leaf):
    """The reduced mamba2-370m with 12 heads of 16 channels (d_inner 192)
    on a model axis of 8: ``param_specs`` cuts ``gate_ln`` and
    ``out_proj`` on the 192 channels (8 divides them), into blocks of 24,
    not whole heads of 16, which is refused by name."""
    from repro_torch.configs import get_arch
    from repro_torch.convert import for_ranks
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import get_model, param_shapes
    from repro_torch.parallel.sharding import head_widths, param_specs

    cfg = dataclasses.replace(get_arch("mamba2_370m").reduced(), d_model=96)
    assert cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim == 12
    mesh = MeshShape(("data", "model"), (1, 8))
    shapes = param_shapes(get_model(cfg))
    specs = param_specs(shapes, mesh)
    assert "model" in specs["layers"][leaf]
    assert "model" not in specs["layers"]["A_log"]      # 12 heads over 8
    tree = {"layers": {leaf: shapes["layers"][leaf]}}
    with pytest.raises(ValueError, match=f"layers/{leaf}.*not whole heads"):
        for_ranks(tree, specs={"layers": {leaf: specs["layers"][leaf]}},
                  mesh=mesh, coords={"data": 0, "model": 1},
                  head_dim=head_widths(cfg))


@pytest.mark.parametrize("arch", ["mamba2_370m", "zamba2_2_7b"])
def test_a_cache_cut_per_cache_specs_joins_back(arch):
    from repro_torch.configs import get_arch

    torch_tp.check_cache_roundtrip(get_arch(arch).reduced())


@pytest.mark.parametrize("arch", ["mamba2_370m", "zamba2_2_7b"])
def test_whole_weights_give_the_earlier_outputs_bit_for_bit(arch,
                                                            monkeypatch):
    torch_tp.check_whole_weights_bit_for_bit(arch, monkeypatch)
