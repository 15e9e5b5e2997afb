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
leaf; a token is held where the reference's top-2 logit gap exceeds the
bound; the MoE inputs keep the routing margin (ROADMAP F9).

Without worlds: the blocks of every leaf of qwen2-7b, gemma3-12b and
olmoe-1b-7b at full width (shapes on ``meta``) on ``model`` 2 and 4
against what ``param_specs`` implies and the dry-run's bytes; the error
of a head-misaligned cut; the ``experts=`` cut as the expert specs' case;
and, with whole weights and no mesh, every output of the changed layers
``torch.equal`` to the code path before tensor parallelism
(``tests/torch_parent_layers.py``).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import get_model as ref_get_model

from test_torch_attention import ROUTE_MARGIN, _routing_margin
from test_torch_train import COSINE, batch_for
from torch_parity import BF16_TOL, assert_same
from torch_worlds import flatten, python_rank, run_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 2, 16
OPT = dict(lr_peak=1e-3, warmup_steps=1, total_steps=3)
MOE = dict(n_experts=4, top_k=2)
CASES = {
    "qwen2": dict(arch="qwen2_7b", impl="sorted", replace={}),
    "olmoe_sorted": dict(arch="olmoe_1b_7b", impl="sorted",
                         replace=dict(MOE, capacity_factor=1.0)),
    "olmoe_a2a": dict(arch="olmoe_1b_7b", impl="a2a",
                      replace=dict(MOE, capacity_factor=8.0)),
}
WORLDS = (2, 4)
REF_MESH = {(w, name): "1x2" if w == 2 and CASES[name]["impl"] == "a2a"
            else "2x2" for w in WORLDS for name in CASES}

REFERENCE = """
import dataclasses, json
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding
from repro.configs import get_arch
from repro.configs.base import SHAPES
from repro.launch.dryrun import make_policy
from repro.launch.steps import make_serve_step, make_train_step
from repro.models import get_model
from repro.optim import adamw
from repro.parallel import sharding as shd
from repro.parallel.hints import sharding_policy

out = {OUT!r}
cases = json.load(open(out + "/tp_cases.json"))
inp = dict(np.load(out + "/inputs.npz"))
meshes = {{"2x2": jax.make_mesh((2, 2), ("data", "model"),
                               axis_types=(AxisType.Auto,) * 2),
          "1x2": jax.make_mesh((1, 2), ("data", "model"),
                               devices=jax.devices()[:2],
                               axis_types=(AxisType.Auto,) * 2)}}

def unflatten(flat):
    tree = {{}}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {{}})
        node[leaf] = v
    return tree

def flatten(tree, prefix=""):
    res = {{}}
    for k, v in tree.items():
        if isinstance(v, dict):
            res.update(flatten(v, prefix + k + "/"))
        else:
            res[prefix + k] = np.asarray(v, np.float32)
    return res

def place(tree, specs, mesh):
    # each leaf laid over the mesh by the reference's own param_specs
    if isinstance(tree, dict):
        return {{k: place(v, specs[k], mesh) for k, v in tree.items()}}
    return jax.device_put(tree, NamedSharding(mesh, specs))

res = {{}}
for mesh_id, name in {RUNS!r}:
    case, mesh = cases[name], meshes[mesh_id]
    cfg = dataclasses.replace(get_arch(case["arch"]).reduced(),
                              **case["replace"])
    model = get_model(cfg, moe_impl=case["impl"])
    flat = {{k[len(name) + 3:]: jnp.asarray(v, case["dtypes"][k[len(name) + 3:]])
            for k, v in inp.items() if k.startswith(name + "/p/")}}
    params = unflatten(flat)
    specs = shd.param_specs(params, mesh)
    params = place(params, specs, mesh)
    cut = sum(len(leaf.sharding.device_set) > 1
              and leaf.addressable_shards[0].data.shape != leaf.shape
              for leaf in jax.tree.leaves(params))
    batch = {{k: jnp.asarray(inp[name + "/" + k]) for k in ("tokens", "labels")}}
    policy = {{s: dict(make_policy(cfg, SHAPES[s], mesh), __mesh__=mesh)
              for s in ("train_4k", "prefill_32k", "decode_32k")}}
    with mesh, sharding_policy(policy["train_4k"]):
        loss, grads = jax.jit(jax.value_and_grad(model.loss))(params, batch)
        step = jax.jit(make_train_step(model, adamw.AdamWConfig(**case["opt"])))
        loss1, params1, _ = step(params, adamw.init(params), batch)
    with mesh, sharding_policy(policy["prefill_32k"]):
        logits, cache = model.prefill(params, {{"tokens": batch["tokens"]}},
                                      {MAX_LEN})
    key = mesh_id + ":" + name
    res[key + "/cut_leaves"] = np.asarray(cut)
    res[key + "/loss"] = np.asarray(loss, np.float32)
    res[key + "/step_loss"] = np.asarray(loss1, np.float32)
    res[key + "/logits"] = np.asarray(logits, np.float32)
    res[key + "/cache/k"] = np.asarray(cache.k, np.float32)
    res[key + "/cache/v"] = np.asarray(cache.v, np.float32)
    serve = make_serve_step(model)
    feed = jnp.asarray(inp[name + "/decode_tokens"])
    with mesh, sharding_policy(policy["decode_32k"]):
        for i in range({STEPS}):
            tok, lg, cache = serve(params, cache, feed[:, i:i + 1])
            res[key + "/decode%d/logits" % i] = np.asarray(lg, np.float32)
            res[key + "/decode%d/tokens" % i] = np.asarray(tok)
    res.update({{key + "/g/" + k: v for k, v in flatten(grads).items()}})
    res.update({{key + "/s/" + k: v for k, v in flatten(params1).items()}})
np.savez(out + "/tp_ref.npz", **res)
print("REF-OK")
"""


def _case_inputs(name, case, steps):
    """The reference's ``init(PRNGKey(0))`` weights of the case, flattened
    to float32 with their dtypes, a batch and the tokens the serve steps
    are fed; for the MoE cases the first seed whose prompt and fed tokens
    keep the routing margin (ROADMAP F9)."""
    cfg = dataclasses.replace(ref_get_arch(case["arch"]).reduced(),
                              **case["replace"])
    model = ref_get_model(cfg, moe_impl=case["impl"])
    params = model.init(jax.random.PRNGKey(0))
    for seed in range(1, 80):
        batch = batch_for(cfg, seed, B=B, S=S)
        feed = np.random.default_rng(seed).integers(
            2, cfg.vocab - 1, size=(B, steps)).astype(np.int32)
        if (cfg.family != "moe" or _routing_margin(
                cfg, params, np.concatenate([batch["tokens"], feed], 1))
                >= ROUTE_MARGIN):
            break
    else:
        raise AssertionError("no batch without a routing near-tie")
    flat = flatten(jax.tree_util.tree_map(np.asarray, params))
    arrays = {f"{name}/p/{k}": np.asarray(v, np.float32)
              for k, v in flat.items()}
    arrays.update({f"{name}/{k}": batch[k] for k in ("tokens", "labels")})
    arrays[f"{name}/decode_tokens"] = feed
    dtypes = {k: str(v.dtype) for k, v in flat.items()}
    return arrays, dict(case, dtypes=dtypes, opt=OPT)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's run and the port's worlds of 2 and 4 ranks."""
    from torch_worlds import MESH_MAX_LEN, TP_DECODE_STEPS

    tmp = tmp_path_factory.mktemp("tensor_parallel")
    arrays, cases = {}, {}
    for name, case in CASES.items():
        a, cases[name] = _case_inputs(name, case, TP_DECODE_STEPS)
        arrays.update(a)
    np.savez(tmp / "inputs.npz", **arrays)
    with open(tmp / "tp_cases.json", "w") as f:
        json.dump(cases, f)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    script = textwrap.dedent(REFERENCE.format(
        OUT=str(tmp), MAX_LEN=MESH_MAX_LEN, STEPS=TP_DECODE_STEPS,
        RUNS=sorted({(m, n) for (_, n), m in REF_MESH.items()})))
    ref = subprocess.Popen([sys.executable, "-c", script], cwd=ROOT, env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        for world in WORLDS:
            run_world(python_rank("tensor_parallel", world, tmp), world,
                      timeout=400)
        out, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0 and "REF-OK" in out, err[-3000:]

    def load(fname):
        with np.load(tmp / fname) as z:
            return {k: z[k] for k in z.files}

    return {"ref": load("tp_ref.npz"),
            "worlds": {w: [load(f"tensor_parallel_{w}_{r}.npz")
                           for r in range(w)] for w in WORLDS}}


def _mesh(world):
    from repro_torch.launch.mesh import MeshShape

    return MeshShape(("data", "model"), (world // 2, 2))


def _specs(name, world):
    """The port's spec of every leaf of the case on the world's mesh."""
    from repro_torch.configs import get_arch
    from repro_torch.models import get_model, param_shapes
    from repro_torch.parallel import sharding as shd

    case = CASES[name]
    cfg = dataclasses.replace(get_arch(case["arch"]).reduced(),
                              **case["replace"])
    return flatten(shd.param_specs(
        param_shapes(get_model(cfg, moe_impl=case["impl"])), _mesh(world)))


def _ref(runs, world, name):
    pre = REF_MESH[(world, name)] + ":"
    return {k[len(pre):]: v for k, v in runs["ref"].items()
            if k.startswith(pre + name + "/")}


def _joined(ranks, name, kind, world):
    """Every leaf of ``kind`` (``g`` or ``s``) joined from the ranks'
    blocks per its spec, after checking that the ranks that hold the same
    block hold the same values: a cut leaf equal in every data row, a
    whole leaf in every rank."""
    from repro_torch.parallel.sharding import join_blocks

    specs = _specs(name, world)
    trees = []
    for got in ranks:
        trees.append({leaf: got[f"{name}/{kind}/{leaf}"] for leaf in specs})
    for leaf in specs:
        for r, tree in enumerate(trees):
            np.testing.assert_array_equal(
                tree[leaf], trees[r % 2][leaf], err_msg=f"{leaf} rank {r}")
    return join_blocks(trees, specs, _mesh(world))


def _row(world, r):
    n_data = world // 2
    d = r // 2
    return slice(d * B // n_data, (d + 1) * B // n_data)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_the_reference_runs_its_tensor_parallel_program(runs, name, world):
    """The reference's parameters were laid over its mesh by its own
    ``param_specs``: most of its leaves are cut over ``model``."""
    assert int(_ref(runs, world, name)[f"{name}/cut_leaves"]) >= 8


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_exactly_its_blocks(runs, name, world):
    """Every rank's leaves have the block shapes ``param_specs`` assigns
    it, no rank holds a whole copy of a leaf its spec cuts (each tensor's
    storage is its block), and the bytes equal the port's dry-run's bytes
    a device."""
    from repro_torch.launch.dryrun import Struct

    specs = _specs(name, world)
    axes = dict(zip(_mesh(world).axis_names, _mesh(world).sizes))
    for r, got in enumerate(runs["worlds"][world]):
        whole = {k: runs["ref"][f"{REF_MESH[(world, name)]}:{name}/g/{k}"]
                 for k in specs}
        for leaf, spec in specs.items():
            want = Struct(whole[leaf].shape, torch.float32,
                          spec).local_shape(axes)
            assert tuple(got[f"{name}/shape/{leaf}"]) == want, (leaf, r)
        assert got[f"{name}/param_bytes"] == got[f"{name}/dryrun_bytes"]
        assert got[f"{name}/storage_bytes"] == got[f"{name}/param_bytes"]
    cut = [k for k, s in specs.items() if "model" in str(s)]
    assert {"layers/wq", "layers/wk", "layers/wo", "embed",
            "lm_head"} <= set(cut)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_loss_matches_the_reference(runs, name, world):
    want = _ref(runs, world, name)[f"{name}/loss"]
    ranks = runs["worlds"][world]
    for r, got in enumerate(ranks):
        assert_same(want, got[f"{name}/loss"], tol=BF16_TOL,
                    what=f"{name} rank {r}")
        assert got[f"{name}/loss"] == ranks[0][f"{name}/loss"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_the_reference(runs, name, world):
    """Every leaf, the ranks' blocks joined per spec, within the bf16
    bound and pointing the reference's way."""
    ref = _ref(runs, world, name)
    got = _joined(runs["worlds"][world], name, "g", world)
    assert got
    for leaf, g in got.items():
        w = ref[f"{name}/g/{leaf}"]
        assert_same(w, g, tol=BF16_TOL, what=f"{leaf} ({world} ranks)")
        w, g = w.ravel(), g.ravel()
        cos = float(w @ g / (np.linalg.norm(w) * np.linalg.norm(g)))
        assert cos > COSINE, (leaf, world, cos)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_prefill_matches_the_reference(runs, name, world):
    """Last-position logits, whole and equal in every rank of a data
    row, and the cache, the ranks' kv heads joined, each within the bf16
    bound of the reference's rows."""
    ref, ranks = _ref(runs, world, name), runs["worlds"][world]
    for r, got in enumerate(ranks):
        sl = _row(world, r)
        np.testing.assert_array_equal(got[f"{name}/logits"],
                                      ranks[r - r % 2][f"{name}/logits"])
        assert_same(ref[f"{name}/logits"][sl], got[f"{name}/logits"],
                    tol=BF16_TOL, what=f"{name} logits rank {r}")
        for field in ("k", "v"):
            key = f"{name}/cache/{field}"
            if r % 2:
                continue
            heads = np.concatenate([got[key], ranks[r + 1][key]], axis=3)
            assert got[key].shape[3] * 2 == ref[key].shape[3]
            assert_same(ref[key][:, sl], heads, tol=BF16_TOL,
                        what=f"{key} rank {r}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_decode_matches_the_reference(runs, name, world):
    """Three serve steps on the head-cut cache, fed the same tokens: the
    whole vocabulary's logits within the bf16 bound, and the next token
    (the argmax of the whole row) equal wherever the reference's top-2
    gap exceeds the bound."""
    from torch_worlds import TP_DECODE_STEPS

    ref, ranks = _ref(runs, world, name), runs["worlds"][world]
    held = 0
    for i in range(TP_DECODE_STEPS):
        key = f"{name}/decode{i}"
        want = ref[key + "/logits"]
        bound = BF16_TOL * max(1.0, float(np.abs(want).max()))
        top2 = np.sort(want, axis=-1)[:, -2:]
        for r, got in enumerate(ranks):
            sl = _row(world, r)
            assert_same(want[sl], got[key + "/logits"], tol=BF16_TOL,
                        what=f"{key} rank {r}")
            clear = (top2[sl, 1] - top2[sl, 0]) > 2 * bound
            np.testing.assert_array_equal(
                got[key + "/tokens"][clear], ref[key + "/tokens"][sl][clear],
                err_msg=f"{key} rank {r}")
            held += int(clear.sum())
    assert held, "no token clear of the bound to hold"


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_one_train_step_matches_the_reference(runs, name, world):
    """``make_train_step`` once: the loss, and every parameter after it
    joined from the ranks' blocks (AdamW on the blocks, clipped by the
    whole model's norm)."""
    ref, ranks = _ref(runs, world, name), runs["worlds"][world]
    for got in ranks:
        assert_same(ref[f"{name}/step_loss"], got[f"{name}/step_loss"],
                    tol=BF16_TOL, what=name)
    for leaf, p in _joined(ranks, name, "s", world).items():
        assert_same(ref[f"{name}/s/{leaf}"], p, tol=BF16_TOL,
                    what=f"{leaf} ({world} ranks)")


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


@pytest.mark.parametrize("leaf,heads", [("wk", dict(n_kv_heads=2)),
                                        ("wq", dict(n_heads=4,
                                                    n_kv_heads=4))])
def test_a_head_misaligned_cut_raises(leaf, heads):
    """The reduced qwen2-7b (head dim 32) on a model axis of 4 with 2 kv
    heads, and of 8 with 4 heads: ``param_specs`` cuts the columns (they
    divide), but not on a head boundary, which is refused by name."""
    from repro_torch.configs import get_arch
    from repro_torch.convert import for_ranks
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import get_model, param_shapes
    from repro_torch.parallel.sharding import param_specs

    cfg = dataclasses.replace(get_arch("qwen2_7b").reduced(), **heads)
    n = 4 if leaf == "wk" else 8
    mesh = MeshShape(("data", "model"), (1, n))
    shapes = param_shapes(get_model(cfg))
    specs = param_specs(shapes, mesh)
    assert "model" in specs["layers"][leaf]
    with pytest.raises(ValueError, match=f"layers/{leaf}.*not whole heads"):
        for_ranks(shapes, specs=specs, mesh=mesh,
                  coords={"data": 0, "model": 1}, head_dim=cfg.hd)


def test_a_zero3_cut_over_data_raises():
    """A spec that names ``data`` on an axis of more than one rank (FSDP
    / ZeRO-3) is not a tensor-parallel cut and is refused."""
    from repro_torch.configs import get_arch
    from repro_torch.convert import for_ranks
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import get_model, param_shapes
    from repro_torch.parallel.sharding import param_specs

    cfg = get_arch("qwen2_7b").reduced()
    mesh = MeshShape(("data", "model"), (2, 2))
    shapes = param_shapes(get_model(cfg))
    with pytest.raises(ValueError, match="ZeRO-3"):
        for_ranks(shapes, specs=param_specs(shapes, mesh, fsdp=True),
                  mesh=mesh, coords={"data": 0, "model": 0})


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


def _all_outputs(model, params, batch):
    """Loss and gradients, one train step's parameters, the prefill's
    logits and cache and three decode steps' logits, with whole weights
    and no policy."""
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.optim import adamw

    out = {}
    loss, grads = value_and_grad(model, params, batch)
    out["loss"] = loss
    out.update({"g/" + k: v for k, v in flatten(grads).items()})
    _, p1, _ = make_train_step(model, adamw.AdamWConfig(**OPT))(
        adamw.tree_map(torch.clone, params), adamw.init(params), batch)
    out.update({"s/" + k: v for k, v in flatten(p1).items()})
    logits, cache = model.prefill(
        params, {"tokens": torch.as_tensor(batch["tokens"])}, S + 4)
    out.update(logits=logits, k=cache.k.clone(), v=cache.v.clone())
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    for i in range(3):
        logits, cache = model.decode(params, cache, tok)
        out[f"decode{i}"] = logits
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    out["k_after"], out["v_after"] = cache.k, cache.v
    return out


@pytest.mark.parametrize("arch", list(WHOLE_ARCHS))
def test_whole_weights_give_the_earlier_outputs_bit_for_bit(arch,
                                                            monkeypatch):
    """With whole weights and no mesh every changed layer takes its
    earlier path: the loss, every gradient, a train step, the prefill and
    three decode steps are ``torch.equal`` to the functions as they stood
    before tensor parallelism."""
    import torch_parent_layers

    from repro_torch.configs import get_arch
    from repro_torch.models import get_model

    cfg = dataclasses.replace(get_arch(arch).reduced(), **WHOLE_ARCHS[arch])
    params = get_model(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    batch = batch_for(cfg, 3, B=B, S=S)
    now = _all_outputs(get_model(cfg), params, batch)
    torch_parent_layers.put_in_place(monkeypatch)
    before = _all_outputs(dataclasses.replace(get_model(cfg), grad_norm=None),
                          params, batch)
    assert now.keys() == before.keys()
    for k, v in now.items():
        assert torch.equal(v, before[k]), (arch, k)
