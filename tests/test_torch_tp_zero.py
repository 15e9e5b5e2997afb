"""ZeRO-3 and ZeRO-1 over cut leaves: the weights cut over ``data`` as well
as over ``model`` by ``param_specs(..., fsdp=True)``, and the AdamW state
by the dry-run's opt specs (``fsdp_axes=("data", "pod")``), in a world of
4 CPU ``gloo`` processes (``data`` 2 x ``model`` 2), against the JAX
package on a 2x2 mesh of XLA host devices whose parameters are placed by
its own ``param_specs(..., fsdp=True)``.

Two cases: the reduced qwen2-7b at 4 layers, so that its biases ``bq``,
``bk`` and ``bv`` are cut on the layer dim over ``data`` (a rank holds 2
of the 4 layers' columns of its heads), and the reduced llama4-maverick
through ``sorted`` (4 experts, top-1, a shared expert; its expert stacks
cut on D over ``data``), and again through ``a2a``, whose serve steps'
one token takes the layer's fallback to ``moe_ffn_sorted`` over the
gathered expert blocks, the inputs clear of routing near-ties (ROADMAP
F9).  The policies declare the weights' cut (``"__params__"``) and, to
the train step, the state's (``"__opt__"``): each pass gathers a layer's
leaves inside its recomputed body, and each rank updates its own block of
the state.  Compared with the reference at the harness's bounds
(``tests/torch_tp.py``): the loss, every gradient leaf (the ranks' blocks
joined per spec), the prefill's logits and cache, three serve steps and
one train step.  In the same rank processes each case runs again with the
weights whole over ``data`` and the state still cut (ZeRO-1 alone): the
two runs agree bit for bit, the gather adding no arithmetic and each
gradient summed in the same order.
"""

import numpy as np
import pytest

import torch_tp

CASES = {
    "qwen2_zero": dict(arch="qwen2_7b", impl="sorted",
                       replace=dict(n_layers=4), fsdp=True),
    "llama4_zero": dict(arch="llama4_maverick", impl="sorted", replace={},
                        fsdp=True),
    "llama4_zero_a2a": dict(arch="llama4_maverick", impl="a2a", replace={},
                            fsdp=True),
}
WORLD = 4
CUT = ["layers/wq", "layers/wk", "layers/wo", "embed", "lm_head"]
# the leaves each case's data cut must reach
DATA_CUT = {"qwen2_zero": ["layers/bq", "layers/bk", "layers/bv",
                           "layers/wq", "layers/ln1", "ln_f", "embed"],
            "llama4_zero": ["layers/we_gate", "layers/we_down",
                            "layers/router", "layers/w_gate", "ln_f"],
            "llama4_zero_a2a": ["layers/we_gate", "layers/we_down",
                                "layers/router", "layers/w_gate", "ln_f"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's run on its 2x2 mesh and the port's world of 4."""
    return torch_tp.run(tmp_path_factory.mktemp("tp_zero"), CASES,
                        worlds=(WORLD,))


@pytest.mark.parametrize("name", list(CASES))
def test_the_reference_runs_its_zero3_program(runs, name):
    """The reference's parameters were laid over its mesh by its own
    ``param_specs(..., fsdp=True)``: most of its leaves are cut."""
    torch_tp.check_reference_cuts(runs, name, WORLD)


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_exactly_its_blocks(runs, name):
    """Every rank's leaves have the block shapes ``param_specs(...,
    fsdp=True)`` assigns it, cut over ``data`` where the spec says so,
    their storage no more, and the bytes the dry-run's a device."""
    torch_tp.check_blocks(runs, name, CASES[name], WORLD, CUT)
    specs = torch_tp.specs_of(CASES[name], WORLD)
    assert all("data" in str(specs[leaf]) for leaf in DATA_CUT[name])


@pytest.mark.parametrize("name", list(CASES))
def test_the_state_is_cut_as_the_dry_runs_opt_specs(runs, name):
    """Each rank's AdamW state (``m``, ``v``, ``master`` and ``step``)
    holds the dry-run's optimizer bytes a device, with the weights cut
    over ``data`` (ZeRO-3) and whole over it (ZeRO-1 alone), where the
    state is a block of the weight's block (every leaf of these cases is
    cut over ``data``: a rank holds half the weights' bytes under
    ZeRO-3)."""
    for got in runs["worlds"][WORLD]:
        for key in (name, name + "/zero1"):
            assert got[f"{key}/state_bytes"] == got[
                f"{key}/dryrun_state_bytes"], key
        assert got[f"{name}/zero1/param_bytes"] == 2 * got[
            f"{name}/param_bytes"]


@pytest.mark.parametrize("name", list(CASES))
def test_loss_matches_the_reference(runs, name):
    torch_tp.check_loss(runs, name, WORLD)


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_the_reference(runs, name):
    """Every leaf, the ranks' blocks joined per spec (over ``data`` and
    ``model``), within the bf16 bound and pointing the reference's way."""
    torch_tp.check_gradients(runs, name, CASES[name], WORLD)


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_matches_the_reference(runs, name):
    torch_tp.check_prefill(runs, name, CASES[name], WORLD)


@pytest.mark.parametrize("name", list(CASES))
def test_decode_matches_the_reference(runs, name):
    """Three serve steps, each gathering every layer's weights over
    ``data``: logits within the bf16 bound, tokens held where the
    reference's top-2 gap clears twice the bound."""
    assert torch_tp.check_decode(runs, name, WORLD), \
        "no token clear of the bound to hold"


@pytest.mark.parametrize("name", list(CASES))
def test_one_train_step_matches_the_reference(runs, name):
    """``make_train_step`` once, AdamW on each rank's block of the state:
    the loss and every parameter after it, joined from the ranks'
    blocks."""
    torch_tp.check_train_step(runs, name, CASES[name], WORLD)


@pytest.mark.parametrize("name", list(CASES))
def test_zero3_equals_the_weights_whole_over_data(runs, name):
    """The same world with the weights whole over ``data`` (ZeRO-1
    alone): the prefill's logits and cache, the serve steps' logits and
    tokens, the loss and step 1's loss, every gradient leaf and every
    parameter after the step, ``np.array_equal`` -- the gather adds no
    arithmetic, and a leaf whole over ``model`` sums its gradient over
    ``model`` before ``data`` in both layouts."""
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


def test_host_buffers_stay_at_the_largest_staged_tensor():
    """``through_host``'s host buffers (``collectives._host_buffer``):
    tensors of many shapes and dtypes staged through one role and index
    share one buffer, grown to the largest of them, not to their sum;
    each view holds what is written to it; another thread stages through
    its own; ``release_host_buffers`` (a world's end) frees them all."""
    import threading

    import torch

    from repro_torch.parallel import collectives as col

    col.release_host_buffers()
    shapes = [((3, 5), torch.float32), ((1000,), torch.bfloat16),
              ((7, 7, 7), torch.float32), ((2,), torch.int64),
              ((), torch.int32)]
    for shape, dtype in shapes * 3:
        t = torch.ones(shape, dtype=dtype)
        buf = col._host_buffer("r", 0, t)
        assert buf.shape == t.shape and buf.dtype == dtype
        buf.copy_(t)
        assert torch.equal(buf, t)
    largest = max(torch.empty(s, dtype=d).nbytes for s, d in shapes)
    assert col.host_buffer_bytes() == largest
    col._host_buffer("w", 0, torch.ones(10, dtype=torch.float32))
    assert col.host_buffer_bytes() == largest + 40
    other = threading.Thread(
        target=col._host_buffer, args=("r", 0, torch.ones(4, 4)))
    other.start()
    other.join()
    assert col.host_buffer_bytes() == largest + 40 + 64
    col.release_host_buffers()
    assert col.host_buffer_bytes() == 0
