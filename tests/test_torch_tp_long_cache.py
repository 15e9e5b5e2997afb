"""KV caches cut on their positions: the encoder-decoder's self and cross
caches and the ``long_decode`` cache at batch 1, in worlds of CPU
``gloo`` processes against the JAX package on a mesh of XLA host devices
whose parameters are placed by its own ``param_specs``
(``tests/torch_tp.py``); and, without worlds, each family's cache laid out
per a declared cut.

Two cases, each in a world of 2 ranks (``model`` 2) and of 4 (``data`` 2
x ``model`` 2):

* the reduced whisper-base with 3 heads and 3 kv heads: self and cross
  attention split 1.5 heads a rank, both caches cut on their positions
  (the self cache's 24, the cross cache's 16 frames) over ``model``;
* the reduced gemma3-12b (window 16) at batch 1 under the ``long_500k``
  policy plus the mesh in both packages: ``cache_specs`` cuts the cache
  over ``('data', 'model')`` on its positions, 12 a rank in the world of
  2 and 6 in the world of 4, where the serve steps at positions 16-18
  cross a block boundary (rank 2's block ends at 18).  A batch of one row
  has no data rows to train on: prefill and decode only.

Compared: the blocks and bytes a rank and of its cache against the
dry-run, the prefill's logits and its caches joined per ``cache_specs``,
three serve steps, and for whisper the loss, every gradient leaf and one
``make_train_step``.  Tolerances as in ``tests/torch_tp.py``.

Without worlds: for a family of each kind with an attention cache (dense,
MoE, hybrid, encoder-decoder) under a policy that declares a cut on the
positions -- over ``model``, and over ``data`` x ``model`` -- every
rank's cache init and prefill give the block ``cache_blocks`` gives of the
whole cache, and ``join_caches`` of the ranks' blocks gives the whole
back; the partial softmax of the blocks merged in one process equals
``chunked_attention`` over the whole cache; and a ``wk`` that splits a kv
head without a declared cut on the positions is refused.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_tp
from torch_parity import BF16_TOL, assert_same
from torch_worlds import MESH_MAX_LEN

CASES = {
    "whisper_split": dict(arch="whisper_base",
                          replace=dict(n_heads=3, n_kv_heads=3)),
    "gemma3_long": dict(arch="gemma3_12b", replace={}, batch=1,
                        serve=["long_500k", "long_500k"]),
}
TRAINED = [n for n, c in CASES.items() if torch_tp.trains(c)]
CUT = {"whisper_split": ["enc/attn/wq", "enc/attn/wk", "enc/attn/wo",
                         "dec/self/wq", "dec/self/wv", "dec/cross/wk",
                         "dec/cross/wo", "embed"],
       "gemma3_long": ["layers/wq", "layers/wk", "layers/wo", "embed"]}
WORLDS = torch_tp.WORLDS


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return torch_tp.run(tmp_path_factory.mktemp("tp_long_cache"), CASES)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_the_reference_runs_its_tensor_parallel_program(runs, name, world):
    torch_tp.check_reference_cuts(runs, name, world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_exactly_its_blocks(runs, name, world):
    """Beside the blocks and bytes: every cache tensor holds every kv
    head of the rank's block of positions (the cross cache of frames)."""
    torch_tp.check_blocks(runs, name, CASES[name], world, CUT[name])
    cfg = torch_tp.config(CASES[name])
    n = world if name == "gemma3_long" else 2
    fields = {"k": MESH_MAX_LEN} if name == "gemma3_long" else {
        "k_self": MESH_MAX_LEN, "k_cross": torch_tp.S}
    for got in runs["worlds"][world]:
        for field, length in fields.items():
            rows, heads = got[f"{name}/cache/{field}"].shape[2:4]
            assert (rows, heads) == (length // n, cfg.n_kv_heads), field


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", TRAINED)
def test_loss_matches_the_reference(runs, name, world):
    torch_tp.check_loss(runs, name, world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", TRAINED)
def test_gradients_match_the_reference(runs, name, world):
    torch_tp.check_gradients(runs, name, CASES[name], world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_prefill_matches_the_reference(runs, name, world):
    torch_tp.check_prefill(runs, name, CASES[name], world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_decode_matches_the_reference(runs, name, world):
    """Three serve steps' logits within the bound; their tokens where
    the reference's top-2 gap clears twice it.  At least one token is
    held where the batch has two rows; gemma3's one row at these three
    steps has gaps of 0.023 to 0.027 against twice the bound, 0.04, so
    its logits alone are held."""
    held = torch_tp.check_decode(runs, name, world, CASES[name])
    assert held or torch_tp.batch_of(CASES[name]) == 1, \
        "no token clear of the bound to hold"


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", TRAINED)
def test_one_train_step_matches_the_reference(runs, name, world):
    torch_tp.check_train_step(runs, name, CASES[name], world)


# ---------------------------------------------------------------------------
# Without worlds
# ---------------------------------------------------------------------------


class PlacedMesh:
    """A mesh's shape and one rank's coordinates on it, as the policy's
    ``"__mesh__"``: what a layout is read from (no process group; the
    passes below run no collective)."""

    def __init__(self, shape, coords):
        self.mesh_dim_names = ("data", "model")
        self.shape, self.coords = tuple(shape), coords

    def size(self, i):
        return self.shape[i]

    def get_local_rank(self, axis):
        return self.coords[axis]

    def get_group(self, axis):
        return None


# the cut over ``model`` (1 kv head does not bank over 2; a batch of 2)
# and over ``data`` x ``model`` (``long_500k`` at batch 1)
CUTS = {"model": ((1, 2), "decode_32k", 2),
        "data_model": ((2, 2), "long_500k", 1)}
FAMILIES = {"dense": ("qwen2_7b", {}), "moe": ("olmoe_1b_7b", dict(
    n_experts=4, top_k=2, capacity_factor=8.0)),
    "hybrid": ("zamba2_2_7b", {}), "encdec": ("whisper_base", {})}


def _setup(family, cut):
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import get_model
    from repro_torch.parallel.sharding import cache_specs
    from test_torch_train import batch_for

    arch, replace = FAMILIES[family]
    cfg = dataclasses.replace(get_arch(arch).reduced(), n_kv_heads=1,
                              **replace)
    shape, shape_name, rows = CUTS[cut]
    mesh = MeshShape(("data", "model"), shape)
    specs = cache_specs(cfg, SHAPES[shape_name], mesh)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = batch_for(cfg, 1, B=rows, S=torch_tp.S)
    prompt = {k: torch.as_tensor(v) for k, v in batch.items()
              if k != "labels"}
    coords = [{"data": r // shape[1], "model": r % shape[1]}
              for r in range(shape[0] * shape[1])]
    return cfg, model, params, prompt, mesh, specs, coords


def _kv_fields(cache):
    return [f for f in cache._fields if f.startswith(("k", "v"))]


@pytest.mark.parametrize("family,cut", [
    (f, c) for f in FAMILIES for c in CUTS
    # the MoE layer's routing means its first choices over the data rows,
    # a collective this process group-less run cannot make
    if (f, c) != ("moe", "data_model")])
def test_a_cache_cut_on_positions_is_the_block_of_the_whole(family, cut):
    """Under a policy declaring ``cache_specs``' cut on the positions:
    each rank's cache init has the shapes ``cache_blocks`` gives of the
    whole cache, its prefill's cache is ``cache_blocks`` of the whole
    prefill's (the whole weights attend on whole heads and store the
    prompt's rows of the rank's block), and ``join_caches`` of the
    ranks' caches gives the whole back."""
    from repro_torch.parallel.hints import sharding_policy
    from repro_torch.parallel.sharding import cache_blocks, join_caches

    cfg, model, params, prompt, mesh, specs, coords = _setup(family, cut)
    _, whole = model.prefill(params, prompt, MESH_MAX_LEN)
    caches = []
    for c in coords:
        policy = {"__mesh__": PlacedMesh(mesh.sizes, c),
                  "__cache__": specs}
        want = cache_blocks(whole, specs, mesh, c)
        with sharding_policy(policy):
            if model.init_cache is not None:
                init = model.init_cache(prompt["tokens"].shape[0],
                                        MESH_MAX_LEN, device="cpu")
                for f in _kv_fields(init):
                    assert getattr(init, f).shape == getattr(want, f).shape
            _, got = model.prefill(params, prompt, MESH_MAX_LEN)
        for f in _kv_fields(got):
            g, w = getattr(got, f), getattr(want, f)
            assert g.shape == w.shape and g.shape[2] < getattr(
                whole, f).shape[2], f
            assert_same(w.float(), g.float(),
                                 tol=BF16_TOL, what=f)
        caches.append(got)
    kv = {f: i for i, f in enumerate(whole._fields) if f in _kv_fields(whole)}
    joined = join_caches(
        [type(whole)(*(t if f in kv else 0 for f, t in zip(
            whole._fields, c))) for c in caches],
        type(whole)(*(s if f in kv else None for f, s in zip(
            whole._fields, specs))), mesh)
    for f in kv:
        assert_same(getattr(whole, f).float(),
                             getattr(joined, f).float(),
                             tol=BF16_TOL, what=f)


def test_a_kv_head_split_needs_the_cache_cut_declared():
    """A ``wk`` block that splits a kv head (half of it a rank at
    ``model`` 2): without the policy's ``"__cache__"`` its cache's layout
    is refused, not inferred; declared (``cache_specs``' cut on the
    positions), every kv head of this rank's block of positions."""
    from repro_torch.models.transformer import kv_layout
    from repro_torch.parallel.hints import sharding_policy

    cfg, _, params, _, mesh, specs, coords = _setup("dense", "model")
    wk = params["layers"]["wk"][..., :cfg.hd // 2]
    policy = {"__mesh__": PlacedMesh(mesh.sizes, coords[1])}
    with sharding_policy(policy), pytest.raises(ValueError,
                                                match="splits a kv head"):
        kv_layout(cfg, wk)
    with sharding_policy({**policy, "__cache__": specs}):
        heads, seq = kv_layout(cfg, wk)
    assert heads == cfg.n_kv_heads and (seq.n, seq.index) == (2, 1)


@pytest.mark.parametrize("window,pos,blocks,empty", [
    (0, 10, 4, 2), (0, 23, 4, 0), (4, 20, 4, 2), (3, 5, 4, 3),
    (16, 18, 2, 0), (0, 0, 3, 2)])
def test_the_partial_softmax_merge_is_chunked_attention(window, pos,
                                                        blocks, empty):
    """The decode step's attention over a cache cut into ``blocks`` of
    positions: each block's partial softmax
    (``layers.attention_partials``, absolute positions for the causal and
    window masks and ``kv_len``) merged (``layers.merge_partials``)
    equals ``chunked_attention`` over the whole cache -- a block with no
    valid position included (past ``kv_len``; before the window)."""
    from repro_torch.models.layers import (attention_partials,
                                           chunked_attention,
                                           merge_partials)

    gen = torch.Generator().manual_seed(pos + blocks)
    B, H, Hkv, D, Smax = 2, 6, 2, 16, MESH_MAX_LEN
    q = torch.randn(B, 1, H, D, generator=gen)
    k = torch.randn(B, Smax, Hkv, D, generator=gen)
    v = torch.randn(B, Smax, Hkv, D, generator=gen)
    kw = dict(causal=True, window=window, q_offset=pos, kv_len=pos + 1)
    want = chunked_attention(q, k, v, block_k=8, **kw)
    rows = Smax // blocks
    parts = [attention_partials(q, k[:, i * rows:(i + 1) * rows],
                                v[:, i * rows:(i + 1) * rows],
                                k_offset=i * rows, **kw)
             for i in range(blocks)]
    blind = [i for i, (m, l, o) in enumerate(parts)
             if bool((m <= -1e29).all())]
    assert len(blind) == empty
    for i in blind:
        assert not parts[i][1].any() and not parts[i][2].any()
    m, l, o = (torch.stack(t) for t in zip(*parts))
    got = merge_partials(m, l, o, lambda t: t.amax(0), lambda t: t.sum(0))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
