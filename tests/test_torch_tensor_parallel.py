"""Tensor parallelism of the attention families: the dense/GQA and MoE
models with their weights cut by ``param_specs`` over ``model``, in
worlds of CPU ``gloo`` processes, against the JAX package on a mesh of
XLA host devices whose parameters are placed by its own ``param_specs``.

Three cases, each in a world of 2 ranks (``model`` 2) and of 4 (``data`` 2
x ``model`` 2): the reduced qwen2-7b (4 heads and 2 kv heads, so 2 and 1
a rank, ``lm_head`` and ``embed`` cut on the vocabulary, the FFN on F),
and the reduced olmoe-1b-7b with 4 experts, top-2, through ``sorted`` at
a capacity factor of 1.0 (pairs are dropped: the whole batch's pairs are
ranked against one capacity, over the data cut too) and through ``a2a``
at 8 (that layer routes each data row apart: the world of 2 is held to
the reference's 1x2 mesh).  Each rank holds exactly the blocks that
``param_specs`` assigns it (``convert.for_ranks``), their bytes the
port's dry-run's bytes a device.  Compared: the loss and every gradient
leaf (the ranks' blocks joined per spec), the prefill's last-position
logits and its cache (the ranks' kv heads joined), three serve steps'
logits and tokens under the decode policy, fed the same tokens in both
packages, and the parameters after one ``make_train_step``.  Tolerances:
bf16 2e-2 of max(1, |ref|), and a cosine above 0.999 for every gradient
leaf; a token is held where the reference's top-2 logit gap exceeds twice
the bound; the MoE inputs keep the routing margin (ROADMAP F9).  The
reference's run, the worlds and the checks are ``tests/torch_tp.py``'s,
shared with the SSM, hybrid and encoder-decoder files.

Without worlds: the blocks of every leaf of qwen2-7b, gemma3-12b and
olmoe-1b-7b at full width (shapes on ``meta``) on ``model`` 2 and 4, of
all ten configs on the production meshes (1, 8), (1, 16) and (16, 16),
every rank's, and of the eight configs the dry-run cuts over ``data``
too (ZeRO-3) on (2, 2), zamba2-2.7b among them, against what
``param_specs`` implies and the dry-run's bytes, joined back whole; a data-cut tree's blocks joined back
whole; the AdamW state of all ten configs on the multi-pod mesh (2, 16,
16), cut over ``('data', 'pod')``, data-major; the SSM, hybrid and
encoder-decoder families' blocks under a ``data`` cut joined back whole;
a head-misaligned cut's blocks, contiguous ranges of columns joined back
whole; the ``experts=`` cut as the expert specs' case;
and, with whole weights and no mesh, every output of the changed layers
``torch.equal`` to the code path before tensor parallelism
(``tests/torch_parent_layers.py``).
"""

import dataclasses

import pytest
import torch

import torch_tp
from repro_torch.configs import ARCH_IDS
from repro_torch.parallel.sharding import P
from torch_worlds import flatten

MOE = dict(n_experts=4, top_k=2)
CASES = {
    "qwen2": dict(arch="qwen2_7b", impl="sorted", replace={}),
    "olmoe_sorted": dict(arch="olmoe_1b_7b", impl="sorted",
                         replace=dict(MOE, capacity_factor=1.0)),
    "olmoe_a2a": dict(arch="olmoe_1b_7b", impl="a2a",
                      replace=dict(MOE, capacity_factor=8.0)),
}
# the expert-parallel blocks (``expert_specs``) in the world of 2: the a2a
# prefill, then serve steps whose one token takes the layer's fallback to
# ``moe_ffn_sorted``
EXPERT_CASES = {
    "olmoe_a2a_experts": dict(arch="olmoe_1b_7b", impl="a2a",
                              replace=dict(MOE, capacity_factor=8.0),
                              experts=True, worlds=[2]),
}
WORLDS = torch_tp.WORLDS
CUT = ["layers/wq", "layers/wk", "layers/wo", "embed", "lm_head"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's run and the port's worlds of 2 and 4 ranks; the
    ``a2a`` world of 2 is held to the reference's 1x2 mesh."""
    cases = {**CASES, **EXPERT_CASES}
    return torch_tp.run(tmp_path_factory.mktemp("tensor_parallel"), cases,
                        ref_mesh={(2, n): "1x2" for n, c in cases.items()
                                  if c["impl"] == "a2a"})


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_the_reference_runs_its_tensor_parallel_program(runs, name, world):
    """The reference's parameters were laid over its mesh by its own
    ``param_specs``: most of its leaves are cut over ``model``."""
    torch_tp.check_reference_cuts(runs, name, world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_exactly_its_blocks(runs, name, world):
    """Every rank's leaves have the block shapes ``param_specs`` assigns
    it, no rank holds a whole copy of a leaf its spec cuts (each tensor's
    storage is its block), and the bytes of its parameters and of its
    cache equal the port's dry-run's bytes a device."""
    torch_tp.check_blocks(runs, name, CASES[name], world, CUT)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_loss_matches_the_reference(runs, name, world):
    torch_tp.check_loss(runs, name, world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_the_reference(runs, name, world):
    """Every leaf, the ranks' blocks joined per spec, within the bf16
    bound and pointing the reference's way."""
    torch_tp.check_gradients(runs, name, CASES[name], world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_prefill_matches_the_reference(runs, name, world):
    """Last-position logits, whole and equal in every rank of a data
    row, and the cache, the ranks' kv heads joined, each within the bf16
    bound of the reference's rows."""
    torch_tp.check_prefill(runs, name, CASES[name], world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_decode_matches_the_reference(runs, name, world):
    """Three serve steps on the head-cut cache, fed the same tokens: the
    whole vocabulary's logits within the bf16 bound, and the next token
    (the argmax of the whole row) equal wherever the reference's top-2
    gap exceeds twice the bound; at least one token is held."""
    assert torch_tp.check_decode(runs, name, world), \
        "no token clear of the bound to hold"


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_one_train_step_matches_the_reference(runs, name, world):
    """``make_train_step`` once: the loss, and every parameter after it
    joined from the ranks' blocks (AdamW on the blocks, clipped by the
    whole model's norm)."""
    torch_tp.check_train_step(runs, name, CASES[name], world)


@pytest.mark.parametrize("name", list(EXPERT_CASES))
def test_the_a2a_decode_fallback_over_expert_blocks_matches(runs, name):
    """The expert-parallel blocks in the world of 2, held to the
    reference's 1x2 mesh: the a2a prefill's logits, then three serve
    steps, each layer's one token taking ``moe_ffn_a2a``'s fallback to
    ``moe_ffn_sorted`` over the rank's 2 of 4 experts, the combine summed
    over ``model``: the logits within the bf16 bound, the tokens held
    where the reference's top-2 gap clears twice it."""
    ranks = runs["worlds"][2]
    ref = torch_tp.ref_of(runs, name, 2)
    for r, got in enumerate(ranks):
        assert tuple(got[f"{name}/shape/layers/we_gate"])[1] == 2
        torch_tp.assert_same(ref[f"{name}/logits"], got[f"{name}/logits"],
                             tol=torch_tp.BF16_TOL, what=f"{name} rank {r}")
    assert torch_tp.check_decode(runs, name, 2), \
        "no token clear of the bound to hold"


# ---------------------------------------------------------------------------
# Without worlds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ["qwen2_7b", "gemma3_12b", "olmoe_1b_7b"])
def test_full_width_blocks_are_what_the_specs_imply(arch, n):
    """At full width on a (1, n) mesh, with the dry-run's FSDP rule (its
    ``data`` entries on an axis of 1 cut nothing): every rank's block of
    every leaf, on ``meta``, has the shape ``param_specs`` implies, and a
    rank's bytes are the dry-run's bytes a device."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import (default_fsdp,
                                           param_bytes_per_device,
                                           params_structs)
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import get_model, param_shapes
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel.sharding import rank_blocks

    cfg = get_arch(arch)
    mesh = MeshShape(("data", "model"), (1, n))
    fsdp = default_fsdp(cfg, mesh)
    structs, specs = params_structs(cfg, mesh, fsdp=fsdp)
    shapes = param_shapes(get_model(cfg))
    axes = {"data": 1, "model": n}
    want = [s.local_shape(axes) for s in tree_leaves(structs)]
    for m in range(n):
        blocks = rank_blocks(shapes, specs, mesh, {"data": 0, "model": m},
                             head_dim=cfg.hd)
        leaves = tree_leaves(blocks)
        assert [tuple(b.shape) for b in leaves] == want
        assert all(b.device.type == "meta" for b in leaves)
        assert (sum(b.numel() * b.element_size() for b in leaves)
                == param_bytes_per_device(cfg, mesh))
    assert sum(tuple(b.shape) != tuple(w.shape) for b, w in zip(
        leaves, tree_leaves(shapes))) >= 8


# the configs whose bf16 parameters pass 2 GiB a device after a cut over
# 16: the dry-run cuts them over 'data' too (ZeRO-3) at (16, 16)
FSDP_ARCHS = ("deepseek_67b", "internlm2_20b", "chameleon_34b",
              "llama4_maverick")
PRODUCTION_MESHES = [(1, 8), (1, 16), (16, 16)]


@pytest.mark.parametrize("mesh", PRODUCTION_MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_production_meshes_give_every_rank_its_blocks(arch, mesh):
    """Every config on the reference's production meshes at full width
    (shapes on ``meta``): every rank's block of every leaf, ``data`` and
    ``model`` coordinates alike, has the shape ``param_specs`` implies, a
    rank's bytes are the dry-run's and the blocks join back whole --
    qwen2-7b's 3.5 heads a rank at (1, 8), gemma3-12b's and
    whisper-base's half a kv head at (1, 16) included, and the four FSDP
    configs at (16, 16), which ``param_specs`` cuts over ``data`` too
    (ZeRO-3): a rank holds 1/256 of them."""
    data, n = mesh
    cut = torch_tp.check_full_width_blocks(arch, n, data)
    assert cut
    if data > 1 and arch in FSDP_ARCHS:
        assert "layers/ln1" in cut and "ln_f" in cut


# the configs whose bf16 parameters pass 2 GiB a device after a cut over
# 2: the dry-run cuts them over 'data' too at (2, 2)
FSDP_2X2_ARCHS = FSDP_ARCHS + ("qwen2_7b", "gemma3_12b", "olmoe_1b_7b",
                               "zamba2_2_7b")


@pytest.mark.parametrize("arch", FSDP_2X2_ARCHS)
def test_zero3_on_a_2x2_mesh_gives_every_rank_its_blocks(arch):
    """Every config the dry-run's rule makes FSDP on the (2, 2) layout at
    full width, zamba2-2.7b's hybrid included: every one of the four
    ranks' blocks as ``param_specs(..., fsdp=True)`` implies, the
    dry-run's bytes a device (internlm2-20b's 9,930,872,832), joined back
    whole.  The rule makes no other config FSDP there."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import (default_fsdp,
                                           param_bytes_per_device)
    from repro_torch.launch.mesh import MeshShape

    mesh = MeshShape(("data", "model"), (2, 2))
    assert {a for a in ARCH_IDS
            if default_fsdp(get_arch(a), mesh)} == set(FSDP_2X2_ARCHS)
    cut = torch_tp.check_full_width_blocks(arch, 2, 2)
    assert {"ln_f", "embed"} <= cut
    assert "layers/ln1" in cut or "ssm/ln" in cut
    if arch == "internlm2_20b":
        assert param_bytes_per_device(get_arch(arch), mesh) == 9_930_872_832


@pytest.mark.parametrize("leaf,heads", [("wk", dict(n_kv_heads=2)),
                                        ("wq", dict(n_heads=4,
                                                    n_kv_heads=4))])
def test_a_head_misaligned_cut_raises(leaf, heads):
    """The reduced qwen2-7b (head dim 32) on a model axis of 4 with 2 kv
    heads, and of 8 with 4 heads: ``param_specs`` cuts the columns (they
    divide) off head boundaries -- half a head a rank -- which a rank
    takes no longer raises on: every rank's block is the contiguous
    range of columns the spec implies, and ``join_blocks`` gives the
    whole leaf back."""
    from repro_torch.configs import get_arch
    from repro_torch.convert import for_ranks
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import get_model
    from repro_torch.parallel.sharding import (head_span, head_widths,
                                               join_blocks, param_specs)

    cfg = dataclasses.replace(get_arch("qwen2_7b").reduced(), **heads)
    n = 4 if leaf == "wk" else 8
    mesh = MeshShape(("data", "model"), (1, n))
    params = get_model(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    specs = param_specs(params, mesh)
    assert "model" in specs["layers"][leaf]
    whole = params["layers"][leaf]
    width = whole.shape[-1]
    assert (width // n) % cfg.hd
    blocks = [for_ranks(params, specs=specs, mesh=mesh,
                        coords={"data": 0, "model": m},
                        head_dim=head_widths(cfg)) for m in range(n)]
    for m, tree in enumerate(blocks):
        (lo, hi), (h0, h1) = head_span(width, n, m, cfg.hd)
        got = tree["layers"][leaf]
        assert torch.equal(got, whole[..., lo:hi])
        assert got.data_ptr() == whole[..., lo:hi].data_ptr()
        assert h1 - h0 == 1 and h0 == lo // cfg.hd
    joined = join_blocks(blocks, specs, mesh)
    for k, v in flatten(params).items():
        assert torch.equal(flatten(joined)[k], v), k


def test_a_zero3_cut_over_data_raises():
    """A spec that names ``data`` on an axis of more than one rank (FSDP
    / ZeRO-3) cuts a running model's weights since ZeRO-3 reached the
    port: every rank's blocks of the reduced qwen2-7b at 4 layers on a
    (2, 2) mesh under ``param_specs(..., fsdp=True)`` are views of their
    ranges, the two data rows hold different blocks of a data-cut leaf
    (``bq``'s layers, ``wq``'s rows), and ``join_blocks`` gives every
    leaf back whole, refusing ranks that hold one block with different
    values."""
    from repro_torch.configs import get_arch
    from repro_torch.convert import for_ranks
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import get_model
    from repro_torch.parallel.sharding import join_blocks, param_specs

    cfg = dataclasses.replace(get_arch("qwen2_7b").reduced(), n_layers=4)
    mesh = MeshShape(("data", "model"), (2, 2))
    params = get_model(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    specs = param_specs(params, mesh, fsdp=True)
    assert specs["layers"]["bq"] == ("data", "model")
    assert specs["layers"]["wq"] == (None, "data", "model")
    blocks = [for_ranks(params, specs=specs, mesh=mesh,
                        coords={"data": r // 2, "model": r % 2})
              for r in range(4)]
    whole = params["layers"]["bq"]
    for r, tree in enumerate(blocks):
        d, m = divmod(r, 2)
        got = tree["layers"]["bq"]
        want = whole[2 * d:2 * d + 2, 64 * m:64 * m + 64]
        assert torch.equal(got, want) and got.data_ptr() == want.data_ptr()
        assert tree["layers"]["wq"].shape == (4, 64, 64)
    joined = flatten(join_blocks(blocks, specs, mesh))
    for k, v in flatten(params).items():
        assert torch.equal(joined[k], v), k
    # ranks (1, 0) and (1, 1) hold ln_f's second block: they must agree
    blocks[2] = {**blocks[2], "ln_f": blocks[2]["ln_f"] + 1}
    with pytest.raises(ValueError, match="different values"):
        join_blocks(blocks, specs, mesh)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_adamw_state_on_the_multipod_mesh_is_cut_over_data_and_pod(arch):
    """The dry-run's AdamW state specs (``param_specs(..., fsdp=True,
    fsdp_axes=("data", "pod"))`` of ``m``, ``v`` and ``master``) of every
    config on the multi-pod mesh (2, 16, 16): every leaf the rule cuts
    over the data axes names ``('data', 'pod')``, ``model`` where the
    weights' rule puts it; a rank's blocks of the state, on ``meta``,
    have the shapes the specs imply and the dry-run's optimizer bytes a
    device; and the entry is data-major, against the mesh's order: the
    rank at pod 1, data 0 holds block 1 of 32, at pod 0, data 1 block
    2."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import _tree_structs, tree_bytes
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import get_model, param_shapes
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import (leaf_block, mesh_axes,
                                               param_specs, rank_blocks)

    cfg = get_arch(arch)
    mesh = make_production_mesh(multi_pod=True)
    axes = mesh_axes(mesh)
    assert tuple(axes) == ("pod", "data", "model")
    state = adamw.init(param_shapes(get_model(cfg)))
    opt = param_specs(state.m, mesh, fsdp=True, fsdp_axes=("data", "pod"))
    weights = flatten(param_specs(state.m, mesh))
    entries = [e for s in flatten(opt).values() for e in s]
    assert ("data", "pod") in entries
    assert all(e in (None, "model", ("data", "pod")) for e in entries)
    for k, s in flatten(opt).items():
        assert [e == "model" for e in s] == [e == "model"
                                            for e in weights[k]], k
    specs = adamw.AdamWState(P(), opt, opt, opt)
    structs = _tree_structs(state, specs)
    coords = {"pod": 1, "data": 7, "model": 3}
    blocks = [rank_blocks(t, s, mesh, coords) for t, s in
              zip(state[1:], specs[1:])]
    got = 4 + sum(b.numel() * b.element_size()
                  for t in blocks for b in flatten(t).values())
    assert got == tree_bytes(structs, axes)
    x = torch.arange(64.0)
    spec = P(("data", "pod"))
    for c, block in (({"pod": 1, "data": 0}, 1), ({"pod": 0, "data": 1}, 2)):
        assert torch.equal(leaf_block("x", x, spec, axes, {**c, "model": 0}),
                           x[2 * block:2 * block + 2])


@pytest.mark.parametrize("arch", ["mamba2_370m", "zamba2_2_7b",
                                  "whisper_base"])
def test_the_ssm_hybrid_and_encdec_families_take_a_data_cut(arch):
    """The families whose passes gather their weights over ``data`` since
    ZeRO-3 reached them: every rank's blocks of their reduced configs on
    (2, 2) under ``param_specs(..., fsdp=True)`` are views of the ranges
    the specs imply, some leaves cut over ``data``, and ``join_blocks``
    gives every leaf back whole."""
    from repro_torch.configs import get_arch
    from repro_torch.convert import for_ranks
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import get_model
    from repro_torch.parallel.sharding import (head_widths, join_blocks,
                                               param_specs)

    cfg = get_arch(arch).reduced()
    mesh = MeshShape(("data", "model"), (2, 2))
    params = get_model(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    specs = param_specs(params, mesh, fsdp=True)
    assert sum("data" in str(s) for s in flatten(specs).values()) >= 4
    blocks = [for_ranks(params, specs=specs, mesh=mesh,
                        coords={"data": r // 2, "model": r % 2},
                        head_dim=head_widths(cfg)) for r in range(4)]
    whole = flatten(params)
    for tree in blocks:
        for k, v in flatten(tree).items():
            assert v.untyped_storage().data_ptr() == \
                whole[k].untyped_storage().data_ptr(), k
    assert not torch.equal(flatten(blocks[0])["embed"],
                           flatten(blocks[2])["embed"])
    joined = flatten(join_blocks(blocks, specs, mesh))
    for k, v in whole.items():
        assert torch.equal(joined[k], v), k


@pytest.mark.parametrize("rank", [0, 1])
def test_the_expert_cut_is_the_expert_specs_case(rank):
    """``for_ranks(experts=(rank, n))`` keeps what the expert stacks'
    specs keep, views of the same storage, every other leaf whole; and
    ``join_blocks`` gives the whole tree back."""
    from repro_torch.configs import get_arch
    from repro_torch.convert import for_ranks
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import get_model
    from repro_torch.parallel.sharding import join_blocks, param_specs

    cfg = dataclasses.replace(get_arch("olmoe_1b_7b").reduced(), **MOE)
    params = get_model(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    mesh = MeshShape(("data", "model"), (1, 2))
    specs = param_specs(params, mesh)
    by_experts = for_ranks(params["layers"], experts=(rank, 2))
    by_specs = for_ranks(params, specs=specs, mesh=mesh,
                         coords={"data": 0, "model": rank})
    for k, v in by_experts.items():
        want = by_specs["layers"][k] if k.startswith("we_") \
            else params["layers"][k]
        assert torch.equal(v, want), k
        assert v.data_ptr() == want.data_ptr(), k
    blocks = [for_ranks(params, specs=specs, mesh=mesh,
                        coords={"data": 0, "model": m}) for m in range(2)]
    whole = join_blocks(blocks, specs, mesh)
    for k, v in flatten(params).items():
        assert torch.equal(flatten(whole)[k], v), k


WHOLE_ARCHS = {
    "qwen2_7b": {},
    "gemma3_12b": {},
    "olmoe_1b_7b": dict(MOE, capacity_factor=1.0),
    "llama4_maverick": dict(n_experts=4, top_k=1),
}


@pytest.mark.parametrize("arch", list(WHOLE_ARCHS))
def test_whole_weights_give_the_earlier_outputs_bit_for_bit(arch,
                                                            monkeypatch):
    """With whole weights and no mesh every changed layer takes its
    earlier path: the loss, every gradient, a train step, the prefill and
    its cache and three decode steps are ``torch.equal`` to the functions
    as they stood before tensor parallelism."""
    torch_tp.check_whole_weights_bit_for_bit(arch, monkeypatch,
                                             WHOLE_ARCHS[arch])
