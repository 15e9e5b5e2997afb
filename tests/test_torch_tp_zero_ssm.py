"""ZeRO-3 and ZeRO-1 of the SSM, hybrid and encoder-decoder families: the
weights cut over ``data`` as well as over ``model`` by ``param_specs(...,
fsdp=True)``, and the AdamW state by the dry-run's opt specs, in a world
of 4 CPU ``gloo`` processes (``data`` 2 x ``model`` 2), against the JAX
package on a 2x2 mesh of XLA host devices whose parameters are placed by
its own ``param_specs(..., fsdp=True)`` (``tests/torch_tp.py``).

Three cases, the first two deep enough that a stack's layer dims are cut
over ``data`` too: the reduced mamba2-370m at 4 layers (``A_log``, ``D_skip``
and ``dt_bias`` cut on the layers), the reduced zamba2-2.7b as one group
of 4 Mamba2 blocks (the ``(G, per)`` stacks cut on ``per``; the shared
block's leaves cut over ``data``) and the reduced
whisper-base (the cross attention's leaves cut over ``data`` like the
self attention's, its 2-layer stacks past the layer dim).  The policies declare the weights' cut
(``"__params__"``) and, to the train step, the state's (``"__opt__"``).
Compared with the reference at the harness's bounds: every rank's blocks,
bytes and state bytes, the loss, every gradient leaf, the prefill's
logits and cache (the hybrid's SSM states after the first shared block
held to the bound widened by the reference's own spread, at most to
twice it: ROADMAP F23), three serve steps and one train step.  In the
same rank processes each case runs again with the weights whole over
``data`` and the state still cut (ZeRO-1 alone): the two runs agree bit
for bit.
"""

import numpy as np
import pytest

import torch_tp

CASES = {
    "mamba2_zero": dict(arch="mamba2_370m", replace=dict(n_layers=4),
                        fsdp=True),
    "zamba2_zero": dict(arch="zamba2_2_7b",
                        replace=dict(hybrid_period=4), fsdp=True),
    "whisper_zero": dict(arch="whisper_base", replace={}, fsdp=True),
}
WORLD = 4
# the leaves each case's model cut must reach
CUT = {"mamba2_zero": ["layers/in_proj", "layers/conv_w", "layers/A_log",
                       "layers/out_proj", "embed"],
       "zamba2_zero": ["ssm/in_proj", "ssm/A_log", "ssm/out_proj",
                       "shared_attn/wq", "shared_attn/wk", "shared_attn/wo",
                       "embed"],
       "whisper_zero": ["enc/attn/wq", "dec/self/wk", "dec/cross/wq",
                        "dec/cross/wo", "dec/mlp/w_up", "embed"]}
# the leaves each case's data cut must reach (mamba2 and zamba2: a layer
# dim among them)
DATA_CUT = {"mamba2_zero": ["layers/A_log", "layers/dt_bias", "layers/ln",
                            "layers/in_proj", "layers/out_proj", "ln_f",
                            "embed"],
            "zamba2_zero": ["ssm/A_log", "ssm/dt_bias", "ssm/in_proj", "ssm/ln",
                            "shared_attn/wq", "shared_attn/w_down",
                            "shared_attn/ln1", "ln_f", "embed"],
            "whisper_zero": ["dec/mlp/b_down", "dec/cross/wq", "dec/cross/wk",
                             "dec/self/wo", "enc/attn/wq", "enc/mlp/b_down",
                             "ln_enc", "ln_f", "embed"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's run on its 2x2 mesh and the port's world of 4."""
    return torch_tp.run(tmp_path_factory.mktemp("tp_zero_ssm"), CASES,
                        worlds=(WORLD,))


@pytest.mark.parametrize("name", list(CASES))
def test_the_reference_runs_its_zero3_program(runs, name):
    torch_tp.check_reference_cuts(runs, name, WORLD)


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_exactly_its_blocks(runs, name):
    """Every rank's leaves have the block shapes ``param_specs(...,
    fsdp=True)`` assigns it, their storage no more, the bytes the
    dry-run's a device, and its cache's the dry-run's too."""
    torch_tp.check_blocks(runs, name, CASES[name], WORLD, CUT[name])
    specs = torch_tp.specs_of(CASES[name], WORLD)
    for leaf in DATA_CUT[name]:
        assert "data" in str(specs[leaf]), leaf


@pytest.mark.parametrize("name", list(CASES))
def test_the_state_is_cut_as_the_dry_runs_opt_specs(runs, name):
    """Each rank's AdamW state holds the dry-run's optimizer bytes a
    device, with the weights cut over ``data`` and whole over it; the
    weights cut over ``data`` take fewer bytes a rank."""
    for got in runs["worlds"][WORLD]:
        for key in (name, name + "/zero1"):
            assert got[f"{key}/state_bytes"] == got[
                f"{key}/dryrun_state_bytes"], key
        assert got[f"{name}/zero1/param_bytes"] > 1.8 * got[
            f"{name}/param_bytes"]


@pytest.mark.parametrize("name", list(CASES))
def test_loss_matches_the_reference(runs, name):
    torch_tp.check_loss(runs, name, WORLD)


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_the_reference(runs, name):
    torch_tp.check_gradients(runs, name, CASES[name], WORLD)


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_matches_the_reference(runs, name):
    torch_tp.check_prefill(runs, name, CASES[name], WORLD)


@pytest.mark.parametrize("name", list(CASES))
def test_decode_matches_the_reference(runs, name):
    """Three serve steps, each gathering every block's weights over
    ``data``: logits within the bf16 bound, tokens held where the
    reference's top-2 gap clears twice the bound."""
    torch_tp.check_decode(runs, name, WORLD)


@pytest.mark.parametrize("name", list(CASES))
def test_one_train_step_matches_the_reference(runs, name):
    torch_tp.check_train_step(runs, name, CASES[name], WORLD)


@pytest.mark.parametrize("name", list(CASES))
def test_zero3_equals_the_weights_whole_over_data(runs, name):
    """The same world with the weights whole over ``data`` (ZeRO-1
    alone): the prefill's logits and cache, the serve steps, the loss and
    step 1's loss, every gradient leaf and every parameter after the
    step, ``np.array_equal``."""
    case = CASES[name]
    ranks = runs["worlds"][WORLD]
    for r, got in enumerate(ranks):
        keys = [k[len(name) + 1:] for k in got
                if k.startswith(name + "/")
                and k.split("/")[1] in ("logits", "cache", "loss",
                                        "step_loss")
                or k.startswith(name + "/decode")]
        assert len(keys) >= 9
        for k in keys:
            np.testing.assert_array_equal(
                got[f"{name}/{k}"], got[f"{name}/zero1/{k}"],
                err_msg=f"{name} {k} rank {r}")
    for kind in ("g", "s"):
        zero3 = torch_tp._joined(ranks, name, case, kind, WORLD)
        zero1 = torch_tp._joined(ranks, name + "/zero1", case, kind, WORLD,
                                 fsdp=False)
        assert zero3.keys() == zero1.keys()
        for leaf, v in zero3.items():
            np.testing.assert_array_equal(
                v, zero1[leaf], err_msg=f"{name} {kind}/{leaf}")
