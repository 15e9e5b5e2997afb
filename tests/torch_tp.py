"""Shared harness of the tensor-parallel tests
(``tests/test_torch_tensor_parallel.py``, ``tests/test_torch_tp_ssm.py``,
``tests/test_torch_tp_encdec.py``, ``tests/test_torch_tp_split_heads.py``,
``tests/test_torch_tp_long_cache.py``): the reference's run on a mesh of XLA
host devices with its parameters placed by its own ``param_specs``, the
port's worlds of 2 (``model`` 2) and 4 (``data`` 2 x ``model`` 2) gloo
ranks (``torch_worlds.rank_tensor_parallel``), and the checks each file
parametrizes over its cases.

The reference runs once in a subprocess with 4 host devices on an
``Auto``-axis mesh (ROADMAP F21), 2x2 unless a file names the 1x2 mesh
for a (world, case), under the dry-run's policies: the train policy for
the loss, its gradients and one ``make_train_step``, the prefill policy
for the prefill, the decode policy for three serve steps fed the same
tokens in both packages (a case may name its own ``"serve"`` shapes,
``long_500k`` for both, and its ``"batch"``: a batch of one row is not
trained).  The port's prefill and serve policies also declare the
cache's layout (``"__cache__"``).  Every tensor of the cache is kept and
the ranks' blocks are joined per ``cache_specs``.  Tolerances: bf16 2e-2 of
max(1, |ref|) for every value, a cosine above 0.999 for every gradient
leaf, a token held where the reference's top-2 gap exceeds twice the
bound.

For the SSM, hybrid and encoder-decoder families the reference also runs
the prefill on one device without a policy: its own spread between its
two layouts, which must stay within the bound (on the reduced models
0.15 to 0.77 of it, seed 1).  The port's cache is held to the plain bound
but for the hybrid's float32 SSM states after the first shared block,
which are ill-conditioned (a head's decay ``exp(A dt)`` with ``A`` down
to -16 turns an ulp of ``dt`` into per cents of the state; ROADMAP F23):
there the reference's two layouts differ by 0.6 to 1.7 times the bound
on batches of seeds 1 to 3, and the port is held to the bound widened,
element by element, by that spread, at most to twice the bound.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

from test_torch_train import COSINE, batch_for
from torch_parity import BF16_TOL, assert_same
from torch_worlds import (MESH_MAX_LEN, TP_DECODE_STEPS, flatten,
                          python_rank, run_world)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 2, 16
OPT = dict(lr_peak=1e-3, warmup_steps=1, total_steps=3)
WORLDS = (2, 4)
# the families whose reference also runs its prefill on one device
SELF_SPREAD = ("ssm", "hybrid", "encdec")

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
    key = mesh_id + ":" + name
    cfg = dataclasses.replace(get_arch(case["arch"]).reduced(),
                              **case["replace"])
    model = get_model(cfg, moe_impl=case["impl"])
    flat = {{k[len(name) + 3:]: jnp.asarray(v, case["dtypes"][k[len(name) + 3:]])
            for k, v in inp.items() if k.startswith(name + "/p/")}}
    whole = unflatten(flat)
    specs = shd.param_specs(whole, mesh, fsdp=case["fsdp"])
    params = place(whole, specs, mesh)
    cut = sum(len(leaf.sharding.device_set) > 1
              and leaf.addressable_shards[0].data.shape != leaf.shape
              for leaf in jax.tree.leaves(params))
    batch = {{k: jnp.asarray(inp[name + "/" + k])
             for k in ("tokens", "labels", "frames")
             if name + "/" + k in inp}}
    prompt = {{k: v for k, v in batch.items() if k != "labels"}}
    prefill_shape, decode_shape = case["serve"]
    policy = {{s: dict(make_policy(cfg, SHAPES[s], mesh), __mesh__=mesh)
              for s in ("train_4k", prefill_shape, decode_shape)}}
    if case["train"]:
        with mesh, sharding_policy(policy["train_4k"]):
            loss, grads = jax.jit(jax.value_and_grad(model.loss))(params,
                                                                 batch)
            step = jax.jit(make_train_step(model,
                                           adamw.AdamWConfig(**case["opt"])))
            loss1, params1, _ = step(params, adamw.init(params), batch)
        res[key + "/loss"] = np.asarray(loss, np.float32)
        res[key + "/step_loss"] = np.asarray(loss1, np.float32)
        res.update({{key + "/g/" + k: v for k, v in flatten(grads).items()}})
        res.update({{key + "/s/" + k: v for k, v in flatten(params1).items()}})
    with mesh, sharding_policy(policy[prefill_shape]):
        logits, cache = model.prefill(params, prompt, {MAX_LEN})
    res[key + "/cut_leaves"] = np.asarray(cut)
    res.update({{key + "/whole/" + k: np.asarray(v.shape)
                for k, v in flat.items()}})
    res[key + "/logits"] = np.asarray(logits, np.float32)
    for field, v in cache._asdict().items():
        if np.ndim(v):
            res[key + "/cache/" + field] = np.asarray(v, np.float32)
    if case["self_spread"]:
        # the same prefill on one device, without a policy: the
        # reference's own spread between its two layouts
        _, one = model.prefill(whole, prompt, {MAX_LEN})
        for field, v in one._asdict().items():
            if np.ndim(v):
                res[key + "/one_device_cache/" + field] = np.asarray(
                    v, np.float32)
    serve = make_serve_step(model)
    feed = jnp.asarray(inp[name + "/decode_tokens"])
    with mesh, sharding_policy(policy[decode_shape]):
        for i in range({STEPS}):
            tok, lg, cache = serve(params, cache, feed[:, i:i + 1])
            res[key + "/decode%d/logits" % i] = np.asarray(lg, np.float32)
            res[key + "/decode%d/tokens" % i] = np.asarray(tok)
np.savez(out + "/tp_ref.npz", **res)
print("REF-OK")
"""


def batch_of(case):
    """The case's global batch: ``B`` unless it names its own."""
    return (case or {}).get("batch", B)


def serve_shapes(case):
    """The shapes whose dry-run policies the case's prefill and its serve
    steps run under: ``("prefill_32k", "decode_32k")`` unless it names
    its own (``"serve"``, e.g. ``long_500k`` for both)."""
    return tuple(case.get("serve", ("prefill_32k", "decode_32k")))


def trains(case):
    """Whether the case trains: a batch of one row has no data rows to
    train on."""
    return batch_of(case) > 1


def config(case, package="repro_torch"):
    """The case's reduced config in ``package``."""
    from importlib import import_module

    get_arch = import_module(package + ".configs").get_arch
    return dataclasses.replace(get_arch(case["arch"]).reduced(),
                               **case["replace"])


def _case_inputs(name, case):
    """The reference's ``init(PRNGKey(0))`` weights of the case, flattened
    to float32 with their dtypes, a batch (with frames for the
    encoder-decoder) and the tokens the serve steps are fed; for an MoE
    case the first seed whose prompt and fed tokens keep the routing
    margin (ROADMAP F9), else seed 1."""
    import jax

    from repro.models import get_model as ref_get_model

    cfg = config(case, "repro")
    impl = case.get("impl", "sorted")
    rows = batch_of(case)
    params = ref_get_model(cfg, moe_impl=impl).init(jax.random.PRNGKey(0))
    if cfg.family == "moe":
        from test_torch_attention import ROUTE_MARGIN, _routing_margin
    for seed in range(1, 80):
        batch = batch_for(cfg, seed, B=rows, S=S)
        feed = np.random.default_rng(seed).integers(
            2, cfg.vocab - 1, size=(rows, TP_DECODE_STEPS)).astype(np.int32)
        toks = np.concatenate([batch["tokens"], feed], 1)
        if (cfg.family != "moe"
                or _routing_margin(cfg, params, toks) >= ROUTE_MARGIN):
            break
    else:
        raise AssertionError("no batch without a routing near-tie")
    flat = flatten(jax.tree_util.tree_map(np.asarray, params))
    arrays = {f"{name}/p/{k}": np.asarray(v, np.float32)
              for k, v in flat.items()}
    arrays.update({f"{name}/{k}": v for k, v in batch.items()})
    arrays[f"{name}/decode_tokens"] = feed
    dtypes = {k: str(v.dtype) for k, v in flat.items()}
    return arrays, dict(case, impl=impl, dtypes=dtypes, opt=OPT,
                        fsdp=case.get("fsdp", False),
                        self_spread=cfg.family in SELF_SPREAD,
                        serve=list(serve_shapes(case)),
                        train=trains(case) and not case.get("experts"))


def run(tmp, cases, ref_mesh=None, worlds=WORLDS):
    """The reference's run and the port's worlds of 2 and 4 ranks (or
    ``worlds``) on the cases, in ``tmp``: ``{"ref": {...}, "ref_mesh":
    {(world, name): mesh}, "worlds": {world: [by rank]}}``.  ``ref_mesh``
    names the reference's mesh ("2x2", the default, or "1x2") a (world,
    case) is held to.  A case that names its ``"worlds"`` runs in those
    alone; one that names ``"experts"`` holds the expert-parallel cut
    (``sharding.expert_specs``: the expert stacks cut on their experts
    over ``model``, every other leaf whole) and runs its prefill and serve
    steps alone."""
    ref_mesh = {(w, n): (ref_mesh or {}).get((w, n), "2x2")
                for w in worlds for n, c in cases.items()
                if w in c.get("worlds", worlds)}
    arrays, spec = {}, {}
    for name, case in cases.items():
        a, spec[name] = _case_inputs(name, case)
        arrays.update(a)
    np.savez(tmp / "inputs.npz", **arrays)
    with open(tmp / "tp_cases.json", "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    script = textwrap.dedent(REFERENCE.format(
        OUT=str(tmp), MAX_LEN=MESH_MAX_LEN, STEPS=TP_DECODE_STEPS,
        RUNS=sorted({(m, n) for (_, n), m in ref_mesh.items()})))
    ref = subprocess.Popen([sys.executable, "-c", script], cwd=ROOT, env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        for world in worlds:
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

    return {"ref": load("tp_ref.npz"), "ref_mesh": ref_mesh,
            "worlds": {w: [load(f"tensor_parallel_{w}_{r}.npz")
                           for r in range(w)] for w in worlds}}


def ref_of(runs, name, world):
    """The reference's outputs for the case on the mesh the world is held
    to, keyed ``<name>/...``."""
    pre = runs["ref_mesh"][(world, name)] + ":"
    return {k[len(pre):]: v for k, v in runs["ref"].items()
            if k.startswith(pre + name + "/")}


def mesh_of(world):
    from repro_torch.launch.mesh import MeshShape

    return MeshShape(("data", "model"), (world // 2, 2))


def specs_of(case, world, fsdp=None):
    """The port's spec of every leaf of the case on the world's mesh (cut
    over ``data`` too where the case, or ``fsdp``, says so)."""
    from repro_torch.models import get_model, param_shapes
    from repro_torch.parallel import sharding as shd

    model = get_model(config(case), moe_impl=case.get("impl", "sorted"))
    fsdp = case.get("fsdp", False) if fsdp is None else fsdp
    return flatten(shd.param_specs(param_shapes(model), mesh_of(world),
                                   fsdp=fsdp))


def _row(world, r, case):
    """Rank ``r``'s rows of the case's batch: its data row's share, or
    the whole batch where it has fewer rows than the data axis (the
    dry-run's ``batch_specs`` leaves such a batch uncut)."""
    n_data, rows = world // 2, batch_of(case)
    if rows < n_data:
        return slice(0, rows)
    d = r // 2
    return slice(d * rows // n_data, (d + 1) * rows // n_data)


def _joined(ranks, name, case, kind, world, fsdp=None):
    """Every leaf of ``kind`` (``g`` or ``s``) joined from the ranks'
    blocks per its spec (``specs_of``), ``join_blocks`` checking that the
    ranks that hold the same block hold the same values: a leaf cut over
    ``model`` alone equal in every data row, a whole leaf in every
    rank."""
    from repro_torch.parallel.sharding import join_blocks

    specs = specs_of(case, world, fsdp)
    trees = [{leaf: got[f"{name}/{kind}/{leaf}"] for leaf in specs}
             for got in ranks]
    return join_blocks(trees, specs, mesh_of(world))


def cache_shape(length, case=None):
    """The prefill's cache as the dry-run sees it: the case's batch over
    the world's data rows, ``length`` positions, of the kind of the
    shape its serve steps run under (``decode``, or ``long_decode``,
    whose cache at batch 1 is cut over every axis)."""
    from repro_torch.configs.base import SHAPES, ShapeConfig

    case = case or {}
    return ShapeConfig("tp_prefill", length, batch_of(case),
                       SHAPES[serve_shapes(case)[1]].kind)


def cache_type(cfg):
    from repro_torch.models import encdec, hybrid, ssm
    from repro_torch.models import transformer as tfm

    return {"ssm": ssm.SSMCache, "hybrid": hybrid.HybridCache,
            "encdec": encdec.EncDecCache}.get(cfg.family, tfm.KVCache)


def _rank_cache(got, name, cfg):
    """A rank's cache from its saved fields (``pos`` 0: not compared)."""
    kind = cache_type(cfg)
    return kind(*(got.get(f"{name}/cache/{f}", 0) for f in kind._fields))


# ---------------------------------------------------------------------------
# The checks, each over (world, case)
# ---------------------------------------------------------------------------


def check_reference_cuts(runs, name, world):
    """The reference's parameters were laid over its mesh by its own
    ``param_specs``: most of its leaves are cut over ``model``."""
    assert int(ref_of(runs, name, world)[f"{name}/cut_leaves"]) >= 8


def check_blocks(runs, name, case, world, must_cut):
    """Every rank's leaves have the block shapes ``param_specs`` assigns
    it, its storage is its blocks, and its parameter bytes and cache
    bytes equal the port's dry-run's bytes a device."""
    from repro_torch.launch.dryrun import Struct, cache_structs, tree_bytes
    from repro_torch.parallel.sharding import mesh_axes

    cfg = config(case)
    specs = specs_of(case, world)
    mesh = mesh_of(world)
    axes = mesh_axes(mesh)
    structs = cache_structs(cfg, cache_shape(MESH_MAX_LEN, case), mesh)
    if cfg.family == "encdec":
        # the dry-run gives the cross K/V the cell's length; a prefill's
        # are its frames' (S here)
        frames = cache_structs(cfg, cache_shape(S, case), mesh)
        structs = structs._replace(k_cross=frames.k_cross,
                                   v_cross=frames.v_cross)
    ref = ref_of(runs, name, world)
    for r, got in enumerate(runs["worlds"][world]):
        for leaf, spec in specs.items():
            whole = tuple(ref[f"{name}/whole/{leaf}"])
            want = Struct(whole, torch.float32, spec).local_shape(axes)
            assert tuple(got[f"{name}/shape/{leaf}"]) == want, (leaf, r)
        assert got[f"{name}/param_bytes"] == got[f"{name}/dryrun_bytes"]
        assert got[f"{name}/storage_bytes"] == got[f"{name}/param_bytes"]
        held = 4                                  # pos: a 0-d int32
        for field, struct in zip(structs._fields, structs):
            if not struct.shape:
                continue
            t = got[f"{name}/cache/{field}"]
            assert t.shape == struct.local_shape(axes), (field, r)
            held += t.size * struct.dtype.itemsize
        assert held == tree_bytes(structs, axes), r
    cut = {k for k, s in specs.items() if "model" in str(s)}
    assert set(must_cut) <= cut, set(must_cut) - cut


def check_loss(runs, name, world):
    want = ref_of(runs, name, world)[f"{name}/loss"]
    ranks = runs["worlds"][world]
    for r, got in enumerate(ranks):
        assert_same(want, got[f"{name}/loss"], tol=BF16_TOL,
                    what=f"{name} rank {r}")
        assert got[f"{name}/loss"] == ranks[0][f"{name}/loss"]


def check_gradients(runs, name, case, world):
    """Every leaf, the ranks' blocks joined per spec, within the bf16
    bound and pointing the reference's way."""
    ref = ref_of(runs, name, world)
    got = _joined(runs["worlds"][world], name, case, "g", world)
    assert got
    for leaf, g in got.items():
        w = ref[f"{name}/g/{leaf}"]
        assert_same(w, g, tol=BF16_TOL, what=f"{leaf} ({world} ranks)")
        w, g = w.ravel(), g.ravel()
        cos = float(w @ g / (np.linalg.norm(w) * np.linalg.norm(g)))
        assert cos > COSINE, (leaf, world, cos)


def check_prefill(runs, name, case, world):
    """Last-position logits, whole and equal in every rank of a data
    row, within the bf16 bound of the reference's; every tensor of the
    cache, the ranks' blocks joined per ``cache_specs``, within that
    bound; where the reference ran its prefill on one device too, its own
    spread within the bound, but for the hybrid's states after the first
    shared block, where the bound is widened by it, at most to twice the
    bound (module docstring)."""
    from repro_torch.parallel.sharding import cache_specs, join_caches

    cfg = config(case)
    ref, ranks = ref_of(runs, name, world), runs["worlds"][world]
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[f"{name}/logits"],
                                      ranks[r - r % 2][f"{name}/logits"])
        assert_same(ref[f"{name}/logits"][_row(world, r, case)],
                    got[f"{name}/logits"], tol=BF16_TOL,
                    what=f"{name} logits rank {r}")
    mesh = mesh_of(world)
    specs = cache_specs(cfg, cache_shape(MESH_MAX_LEN, case), mesh)
    whole = join_caches([_rank_cache(got, name, cfg) for got in ranks],
                        specs, mesh)
    fields = [f for f in whole._fields if f"{name}/cache/{f}" in ref]
    assert len(fields) >= 2
    for field in fields:
        want = ref[f"{name}/cache/{field}"]
        got = getattr(whole, field)
        assert got.shape == want.shape, field
        assert any(s != w for s, w in zip(
            ranks[0][f"{name}/cache/{field}"].shape, want.shape)), field
        bound = BF16_TOL * max(1.0, float(np.abs(want).max()))
        widen = np.zeros_like(want)
        one = ref.get(f"{name}/one_device_cache/{field}")
        if one is not None:
            spread = np.abs(one - want)
            if cfg.family == "hybrid" and field == "state":
                # the groups after the first shared block (F23)
                widen[1:] = np.minimum(spread[1:], bound)
                spread[1:] = 0.0
            assert spread.max() <= bound, (
                f"{name} cache {field}: the reference's own spread "
                f"{float(spread.max())} past the bound {bound}")
        over = np.abs(got - want) - bound - widen
        assert over.max() <= 0, (
            f"{name} cache {field}: {int((over > 0).sum())} elements past "
            f"the bound, by up to {float(over.max())}")


def check_decode(runs, name, world, case=None):
    """Three serve steps on the rank's share of the cache, fed the same
    tokens: the whole vocabulary's logits within the bf16 bound, and the
    next token equal wherever the reference's top-2 gap exceeds twice
    the bound.  Returns how many tokens were held."""
    ref, ranks = ref_of(runs, name, world), runs["worlds"][world]
    held = 0
    for i in range(TP_DECODE_STEPS):
        key = f"{name}/decode{i}"
        want = ref[key + "/logits"]
        bound = BF16_TOL * max(1.0, float(np.abs(want).max()))
        top2 = np.sort(want, axis=-1)[:, -2:]
        for r, got in enumerate(ranks):
            sl = _row(world, r, case)
            assert_same(want[sl], got[key + "/logits"], tol=BF16_TOL,
                        what=f"{key} rank {r}")
            clear = (top2[sl, 1] - top2[sl, 0]) > 2 * bound
            np.testing.assert_array_equal(
                got[key + "/tokens"][clear], ref[key + "/tokens"][sl][clear],
                err_msg=f"{key} rank {r}")
            held += int(clear.sum())
    return held


def check_train_step(runs, name, case, world):
    """``make_train_step`` once: the loss, and every parameter after it
    joined from the ranks' blocks (AdamW on the blocks, clipped by the
    whole model's norm)."""
    ref, ranks = ref_of(runs, name, world), runs["worlds"][world]
    for got in ranks:
        assert_same(ref[f"{name}/step_loss"], got[f"{name}/step_loss"],
                    tol=BF16_TOL, what=name)
    for leaf, p in _joined(ranks, name, case, "s", world).items():
        assert_same(ref[f"{name}/s/{leaf}"], p, tol=BF16_TOL,
                    what=f"{leaf} ({world} ranks)")


# ---------------------------------------------------------------------------
# Without worlds
# ---------------------------------------------------------------------------


def check_full_width_blocks(arch, n, data=1):
    """At full width on a (data, n) mesh, with the dry-run's FSDP rule
    (its ``data`` entries on an axis of 1 cut nothing; on more, ZeRO-3):
    every rank's block of every leaf -- each ``data`` and ``model``
    coordinate -- on ``meta``, has the shape ``param_specs`` implies (the
    contiguous range of each cut dim, head boundary or not), a rank's
    bytes are the dry-run's bytes a device, and ``join_blocks`` gives
    every leaf back whole.  Returns the names of the leaves that are
    cut."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import (default_fsdp,
                                           param_bytes_per_device,
                                           params_structs)
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import get_model, param_shapes
    from repro_torch.parallel.sharding import (head_widths, join_blocks,
                                               rank_blocks)

    cfg = get_arch(arch)
    mesh = MeshShape(("data", "model"), (data, n))
    fsdp = default_fsdp(cfg, mesh)
    structs, specs = params_structs(cfg, mesh, fsdp=fsdp)
    shapes = param_shapes(get_model(cfg))
    axes = {"data": data, "model": n}
    want = [s.local_shape(axes) for s in flatten(structs).values()]
    dry = param_bytes_per_device(cfg, mesh)
    trees = []
    for r in range(data * n):
        blocks = flatten(rank_blocks(shapes, specs, mesh,
                                     {"data": r // n, "model": r % n},
                                     head_dim=head_widths(cfg)))
        assert [tuple(b.shape) for b in blocks.values()] == want
        assert all(b.device.type == "meta" for b in blocks.values())
        assert sum(b.numel() * b.element_size()
                   for b in blocks.values()) == dry
        trees.append(blocks)
    whole = flatten(shapes)
    joined = join_blocks(trees, flatten(specs), mesh)
    assert {k: tuple(v.shape) for k, v in joined.items()} == {
        k: tuple(v.shape) for k, v in whole.items()}
    return {k for k, b in blocks.items()
            if tuple(b.shape) != tuple(whole[k].shape)}


def check_cache_roundtrip(cfg):
    """``cache_blocks`` gives each rank of a 2 x 2 mesh its share of a
    cache under ``cache_specs`` (the batch over ``data``; kv heads, SSM
    heads and conv channels over ``model``), views of it; ``join_caches``
    gives the whole back, and refuses ranks that hold different values
    of one block."""
    import pytest

    from repro_torch.models import encdec, get_model
    from repro_torch.parallel.sharding import (cache_blocks, cache_specs,
                                               join_caches)

    mesh = mesh_of(4)
    gen = torch.Generator().manual_seed(0)
    if cfg.family == "encdec":
        kv = (cfg.n_layers, B, MESH_MAX_LEN, cfg.n_kv_heads, cfg.hd)
        cache = encdec.EncDecCache(*(torch.randn(kv, generator=gen)
                                     for _ in range(4)), 3)
    else:
        cache = get_model(cfg).init_cache(B, MESH_MAX_LEN, device="cpu")
        cache = cache._replace(**{
            f: torch.randn(t.shape, generator=gen).to(t.dtype)
            for f, t in cache._asdict().items() if torch.is_tensor(t)})
    specs = cache_specs(cfg, cache_shape(MESH_MAX_LEN), mesh)
    parts = [cache_blocks(cache, specs, mesh, {"data": r // 2,
                                               "model": r % 2})
             for r in range(4)]
    for f, t in cache._asdict().items():
        if torch.is_tensor(t):
            block = getattr(parts[3], f)
            assert block.numel() * 4 == t.numel(), f
            assert (block.untyped_storage().data_ptr()
                    == t.untyped_storage().data_ptr()), f
    whole = join_caches(parts, specs, mesh)
    for f, t in cache._asdict().items():
        got = getattr(whole, f)
        assert torch.equal(got, t) if torch.is_tensor(t) else got == t, f
    # one row a batch: both data rows hold every block, and must agree
    specs = cache_specs(cfg, dataclasses.replace(
        cache_shape(MESH_MAX_LEN), global_batch=1), mesh)
    parts = [cache_blocks(cache, specs, mesh, {"data": r // 2,
                                               "model": r % 2})
             for r in range(4)]
    assert torch.equal(join_caches(parts, specs, mesh)[0], cache[0])
    parts[2] = parts[2]._replace(**{cache._fields[0]: parts[2][0] + 1})
    with pytest.raises(ValueError, match="different values"):
        join_caches(parts, specs, mesh)


def all_outputs(model, params, batch):
    """Loss and gradients, one train step's parameters, the prefill's
    logits and every tensor of its cache and three decode steps' logits
    and caches, with whole weights and no policy."""
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.optim import adamw

    out = {}
    loss, grads = value_and_grad(model, params, batch)
    out["loss"] = loss
    out.update({"g/" + k: v for k, v in flatten(grads).items()})
    _, p1, _ = make_train_step(model, adamw.AdamWConfig(**OPT))(
        adamw.tree_map(torch.clone, params), adamw.init(params), batch)
    out.update({"s/" + k: v for k, v in flatten(p1).items()})
    prompt = {k: torch.as_tensor(v) for k, v in batch.items()
              if k != "labels"}
    logits, cache = model.prefill(params, prompt, S + 4)
    out["logits"] = logits

    def keep(tag, cache):
        for f, v in cache._asdict().items():
            if torch.is_tensor(v):
                out[f"{tag}/{f}"] = v.clone()

    keep("prefill", cache)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    for i in range(3):
        logits, cache = model.decode(params, cache, tok)
        out[f"decode{i}"] = logits
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    keep("decoded", cache)
    return out


def check_whole_weights_bit_for_bit(arch, monkeypatch, replace=None):
    """With whole weights and no mesh every changed function takes its
    earlier path: the loss, every gradient, a train step, the prefill and
    its cache and three decode steps are ``torch.equal`` to the functions
    as they stood before tensor parallelism reached the family."""
    import torch_parent_layers

    from repro_torch.configs import get_arch
    from repro_torch.models import get_model

    cfg = dataclasses.replace(get_arch(arch).reduced(), **(replace or {}))
    params = get_model(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    batch = batch_for(cfg, 3, B=B, S=S)
    now = all_outputs(get_model(cfg), params, batch)
    torch_parent_layers.put_in_place(monkeypatch)
    before = all_outputs(dataclasses.replace(get_model(cfg), grad_norm=None),
                         params, batch)
    assert now.keys() == before.keys()
    for k, v in now.items():
        assert torch.equal(v, before[k]), (arch, k)
