"""The decode variants over cut weights: ``grouped_decode_step`` (the
local layers' KV rings) and ``decode_step_quant`` (the int8 KV cache) with
their weights cut by ``param_specs`` and their caches laid out as the
dry-run lays its ``ring_cache`` and ``int8_kv`` cells
(``sharding.ring_cache_specs``, ``quant_cache_specs``), in worlds of CPU
``gloo`` processes, against the JAX package on a mesh of XLA host devices
(``Auto`` axes, ROADMAP F21) whose parameters are placed by its own
``param_specs`` and whose caches by the dry-run's inline specs.

Configs: the reduced gemma3-12b at 12 layers (2 groups of 5 local layers
and a global one; a window of 16, so the history of 22 positions has
wrapped every ring; 2 kv heads of 32 channels, so a ``model`` axis of 4
splits a kv head) and the reduced qwen2-7b for int8.  Layouts: the decode
layout (a batch of 2 rows: a ring whole over ``model``, the global
buffers cut on their positions over ``model``, the int8 cache on its kv
heads) and the long layout (one row: a ring's 16 slots cut over
``model``, the global buffers and the int8 cache on their positions over
``data`` then ``model``).  Meshes: (1, 2), (2, 2) with the weights cut
over ``data`` too (ZeRO-3), and, for gemma3, (1, 4) for the split kv
head; the worlds of 4 ranks run the (2, 2) and (1, 4) cases on two
meshes over the same processes.  Every case starts from the same numpy history at position 22
(a cache 32 long) and takes 3 steps fed the same tokens, the long
layout's crossing a block of positions (23 to 24 on (2, 2) and (1, 4))
and of ring slots (7 to 8 on (1, 2)).  Held: the whole vocabulary's
logits to the bf16 bound (2e-2 of max(1, |ref|)), the tokens where the
reference's top-2 gap clears twice it, the caches joined per spec to the
bf16 bound (int8: the dequantized rows; the history's scales to the
float32 bound 2e-5, the steps' scales, each the max of a bfloat16 row
over 127, to the bf16 bound of their own size), and every rank's cache
bytes to the dry-run's bytes a device.

Twelve random bfloat16 layers are ill-conditioned against that bound:
the reference's own logits on its mesh and on one device differ by up to
0.025, past the 0.02 bound (ring_decode_2x2, step 1), and the port's
one process, the variants' code before they ran cut, by 0.022.  So the
reference also runs every case on one device, and a value is held to the
bound widened, element by element, by the reference's own spread between
its two layouts, at most to twice the bound (the rule of ROADMAP F23).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_tp
from torch_parity import BF16_TOL, FP32_TOL
from torch_worlds import TP_DECODE_STEPS, python_rank, run_world

POS, MAX_LEN = 22, 32
GEMMA = dict(arch="gemma3_12b", replace=dict(n_layers=12))
QWEN = dict(arch="qwen2_7b", replace={})
LAYOUTS = {"decode": ("decode_32k", 2), "long": ("long_500k", 1)}


def _case(model, variant, layout, mesh):
    shape, batch = LAYOUTS[layout]
    return dict(model, variant=variant, shape=shape, batch=batch, mesh=mesh,
                fsdp=mesh == "2x2")


# the (1, 4) mesh for gemma3's split kv head
CASES = {f"{v}_{layout}_{mesh}": _case(GEMMA if v == "ring" else QWEN, v,
                                       layout, mesh)
         for v in ("ring", "int8") for layout in LAYOUTS
         for mesh in ("1x2", "2x2", "1x4") if v == "ring" or mesh != "1x4"}
WORLD_OF = {"1x2": 2, "2x2": 4, "1x4": 4}

REFERENCE = """
import dataclasses, json
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_arch
from repro.configs.base import SHAPES
from repro.launch.dryrun import make_policy
from repro.models import transformer as tfm
from repro.parallel import sharding as shd
from repro.parallel.hints import sharding_policy

out = {OUT!r}
cases = json.load(open(out + "/variant_cases.json"))
inp = dict(np.load(out + "/inputs.npz"))
auto = (AxisType.Auto,) * 2
meshes = {{"1x2": jax.make_mesh((1, 2), ("data", "model"),
                               devices=jax.devices()[:2], axis_types=auto),
          "2x2": jax.make_mesh((2, 2), ("data", "model"), axis_types=auto),
          "1x4": jax.make_mesh((1, 4), ("data", "model"), axis_types=auto)}}

def unflatten(flat):
    tree = {{}}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {{}})
        node[leaf] = v
    return tree

def place(tree, specs, mesh):
    if isinstance(tree, dict):
        return {{k: place(v, specs[k], mesh) for k, v in tree.items()}}
    return jax.device_put(tree, NamedSharding(mesh, specs))

res = {{}}
for name, case in cases.items():
    mesh = meshes[case["mesh"]]
    cfg = dataclasses.replace(get_arch(case["arch"]).reduced(),
                              **case["replace"])
    shape = dataclasses.replace(SHAPES[case["shape"]],
                                global_batch=case["batch"])
    whole = unflatten({{k[len(name) + 3:]: jnp.asarray(
        v, case["dtypes"][k[len(name) + 3:]])
        for k, v in inp.items() if k.startswith(name + "/p/")}})
    params = place(whole, shd.param_specs(whole, mesh, fsdp=case["fsdp"]),
                   mesh)
    if case["variant"] == "ring":
        # the dry-run's ring_cache cell, as it lays the cache
        B, dp = shape.global_batch, shd.dp_axes(mesh)
        nb = None if B == 1 else dp
        seq_all = tuple(a for a in (*dp, "model")) if B == 1 else "model"
        kv_loc = P(None, None, nb, "model" if B == 1 else None, None, None)
        kv_glob = P(None, nb, seq_all, None, None)
        kind, step = tfm.GroupedKVCache, tfm.grouped_decode_step
        specs = kind(kv_loc, kv_loc, kv_glob, kv_glob, P())
    else:
        # the dry-run's int8_kv cell
        base = shd.cache_specs(cfg, shape, mesh)
        kv, scale = base.k, P(*base.k[:-1])
        kind, step = tfm.QuantKVCache, tfm.decode_step_quant
        specs = kind(kv, kv, scale, scale, P())
    cache = kind(*(jax.device_put(
        jnp.asarray(inp[name + "/cache/" + f], case["cache_dtypes"][f]),
        NamedSharding(mesh, s)) if f != "pos"
        else jnp.asarray(case["pos"], jnp.int32)
        for f, s in zip(kind._fields, specs)))
    fn = jax.jit(lambda p, c, t, step=step, cfg=cfg: step(cfg, p, c, t))
    feed = jnp.asarray(inp[name + "/decode_tokens"])
    policy = dict(make_policy(cfg, SHAPES[case["shape"]], mesh),
                  __mesh__=mesh)
    with mesh, sharding_policy(policy):
        for i in range({STEPS}):
            logits, cache = fn(params, cache, feed[:, i:i + 1])
            res[name + "/decode%d/logits" % i] = np.asarray(logits,
                                                            np.float32)
            res[name + "/decode%d/tokens" % i] = np.asarray(
                jnp.argmax(logits, -1))
    for f, v in cache._asdict().items():
        if np.ndim(v):
            res[name + "/cache/" + f] = np.asarray(v, np.float32)
    # the same steps on one device, without a policy: the reference's own
    # spread between its two layouts
    one = kind(*(jnp.asarray(inp[name + "/cache/" + f],
                             case["cache_dtypes"][f]) if f != "pos"
                 else jnp.asarray(case["pos"], jnp.int32)
                 for f in kind._fields))
    for i in range({STEPS}):
        logits, one = fn(whole, one, feed[:, i:i + 1])
        res[name + "/one/decode%d/logits" % i] = np.asarray(logits,
                                                            np.float32)
    for f, v in one._asdict().items():
        if np.ndim(v):
            res[name + "/one/cache/" + f] = np.asarray(v, np.float32)
np.savez(out + "/variants_ref.npz", **res)
print("REF-OK")
"""


def _bf16(a):
    """``a`` rounded to bfloat16 values, as float32."""
    return torch.as_tensor(a, dtype=torch.float32).to(
        torch.bfloat16).float().numpy()


def _history(name, case, rng):
    """The case's whole cache at position ``POS``: random bf16 rows in
    every ring slot (the history has wrapped) and in the global buffers'
    first ``POS`` positions; for int8, random int8 rows and scales there;
    zeros past ``POS``."""
    cfg = torch_tp.config(case)
    B, Hkv, Dh, L = case["batch"], cfg.n_kv_heads, cfg.hd, cfg.n_layers
    out, dtypes = {}, {}
    if case["variant"] == "ring":
        from repro_torch.models.transformer import grouped_layout

        G, R = grouped_layout(cfg)
        W = cfg.sliding_window
        for f in ("k_local", "v_local"):
            out[f] = _bf16(rng.standard_normal((G, R, B, W, Hkv, Dh)))
            dtypes[f] = "bfloat16"
        for f in ("k_global", "v_global"):
            t = np.zeros((G, B, MAX_LEN, Hkv, Dh), np.float32)
            t[:, :, :POS] = _bf16(rng.standard_normal(t[:, :, :POS].shape))
            out[f], dtypes[f] = t, "bfloat16"
    else:
        for f in ("k_q", "v_q"):
            t = np.zeros((L, B, MAX_LEN, Hkv, Dh), np.int8)
            t[:, :, :POS] = rng.integers(-127, 128, t[:, :, :POS].shape)
            out[f], dtypes[f] = t, "int8"
        for f in ("k_s", "v_s"):
            t = np.zeros((L, B, MAX_LEN, Hkv), np.float32)
            t[:, :, :POS] = rng.uniform(0.01, 0.03, t[:, :, :POS].shape)
            out[f], dtypes[f] = t, "float32"
    return {f"{name}/cache/{f}": v for f, v in out.items()}, dtypes


def _inputs():
    """The reference's ``init(PRNGKey(0))`` weights of each case, its
    history and the tokens its steps are fed (seeded by the case's
    index)."""
    import jax

    from repro.models import get_model as ref_get_model

    arrays, spec = {}, {}
    for i, (name, case) in enumerate(CASES.items()):
        cfg = torch_tp.config(case, "repro")
        params = ref_get_model(cfg).init(jax.random.PRNGKey(0))
        flat = torch_tp.flatten(jax.tree_util.tree_map(np.asarray, params))
        arrays.update({f"{name}/p/{k}": np.asarray(v, np.float32)
                       for k, v in flat.items()})
        rng = np.random.default_rng(100 + i)
        hist, cache_dtypes = _history(name, case, rng)
        arrays.update(hist)
        arrays[f"{name}/decode_tokens"] = rng.integers(
            2, cfg.vocab - 1, size=(case["batch"], TP_DECODE_STEPS)
        ).astype(np.int32)
        spec[name] = dict(case, pos=POS, cache_dtypes=cache_dtypes,
                          dtypes={k: str(v.dtype) for k, v in flat.items()})
    return arrays, spec


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's run of every case, and the port's worlds of 2 (the
    (1, 2) cases) and 4 (the (2, 2) and (1, 4) cases)."""
    tmp = tmp_path_factory.mktemp("decode_variants")
    arrays, spec = _inputs()
    np.savez(tmp / "inputs.npz", **arrays)
    with open(tmp / "variant_cases.json", "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    script = textwrap.dedent(REFERENCE.format(OUT=str(tmp),
                                              STEPS=TP_DECODE_STEPS))
    ref = subprocess.Popen([sys.executable, "-c", script],
                           cwd=torch_tp.ROOT, env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        for world in (2, 4):
            run_world(python_rank("decode_variants", world, tmp), world,
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

    return {"ref": load("variants_ref.npz"),
            "worlds": {w: [load(f"decode_variants_{w}_{r}.npz")
                           for r in range(w)] for w in (2, 4)}}


def _mesh(case):
    from repro_torch.launch.mesh import MeshShape

    return MeshShape(("data", "model"),
                     tuple(int(n) for n in case["mesh"].split("x")))


def _specs(case):
    """The variant's spec tree on the case's mesh (the port's)."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.parallel import sharding as shd

    shape = dataclasses.replace(SHAPES[case["shape"]],
                                global_batch=case["batch"])
    fn = (shd.ring_cache_specs if case["variant"] == "ring"
          else shd.quant_cache_specs)
    return fn(torch_tp.config(case), shape, _mesh(case))


def _held(want, got, one, tol, what):
    """``got`` within ``tol`` of max(1, |want|) of the reference's
    ``want``, the bound widened element by element by the reference's own
    spread between its mesh and one device (``one``), at most to twice
    the bound (module docstring)."""
    bound = tol * max(1.0, float(np.abs(want).max()))
    widen = np.minimum(np.abs(one - want), bound)
    over = np.abs(got - want) - bound - widen
    assert over.max() <= 0, (
        f"{what}: {int((over > 0).sum())} elements past the bound {bound} "
        f"widened by the reference's spread, by up to {float(over.max())}")


def _ranks(runs, case):
    return runs["worlds"][WORLD_OF[case["mesh"]]]


def _rows(case, r):
    """Rank ``r``'s rows of the case's batch: its data row's share, or
    the whole of a batch of one row."""
    n_data = _mesh(case).shape["data"]
    if case["batch"] < n_data:
        return slice(0, case["batch"])
    b = case["batch"] // n_data
    d = r // _mesh(case).shape["model"]
    return slice(d * b, (d + 1) * b)


@pytest.mark.parametrize("name", list(CASES))
def test_logits_and_tokens_match_the_reference(runs, name):
    """Three steps: the whole vocabulary's logits within the bf16 bound
    in every rank, the next token equal wherever the reference's top-2
    gap clears twice the bound (at least one token held a case)."""
    case, ref = CASES[name], runs["ref"]
    held = 0
    for i in range(TP_DECODE_STEPS):
        key = f"{name}/decode{i}"
        want = ref[key + "/logits"]
        bound = BF16_TOL * max(1.0, float(np.abs(want).max()))
        top2 = np.sort(want, axis=-1)[:, -2:]
        one = ref[f"{name}/one/decode{i}/logits"]
        for r, got in enumerate(_ranks(runs, case)):
            sl = _rows(case, r)
            _held(want[sl], got[key + "/logits"], one[sl], BF16_TOL,
                  f"{key} rank {r}")
            clear = (top2[sl, 1] - top2[sl, 0]) > 2 * bound
            np.testing.assert_array_equal(
                got[key + "/tokens"][clear], ref[key + "/tokens"][sl][clear],
                err_msg=f"{key} rank {r}")
            held += int(clear.sum())
    assert held, "no token clear of the bound to hold"


@pytest.mark.parametrize("name", list(CASES))
def test_the_caches_match_the_reference(runs, name):
    """Every rank's block of every cache tensor after the steps, joined
    per the variant's specs (ranks that hold one block must hold the same
    values): the bf16 rows within the bf16 bound of the reference's;
    int8, the dequantized rows within the bf16 bound and the scales
    within the float32 bound.  Each rank's block is smaller than the
    whole."""
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.sharding import join_caches

    case, ref = CASES[name], runs["ref"]
    kind = (tfm.GroupedKVCache if case["variant"] == "ring"
            else tfm.QuantKVCache)
    ranks = _ranks(runs, case)
    parts = [kind(*(got.get(f"{name}/cache/{f}", 0) for f in kind._fields))
             for got in ranks]
    whole = join_caches(parts, _specs(case), _mesh(case))
    fields = [f for f in kind._fields if f != "pos"]
    want = {f: ref[f"{name}/cache/{f}"] for f in fields}
    one = {f: ref[f"{name}/one/cache/{f}"] for f in fields}
    for f, w in want.items():
        assert getattr(whole, f).shape == w.shape, f
        assert getattr(parts[0], f).size < w.size or f.endswith("_local"), f
    if case["variant"] == "ring":
        for f, w in want.items():
            _held(w, getattr(whole, f), one[f], BF16_TOL, f)
        return
    for q, s in (("k_q", "k_s"), ("v_q", "v_s")):
        def deq(c):
            return c[q] * c[s][..., None]
        _held(deq(want), deq(whole._asdict()), deq(one), BF16_TOL, q)
        # the history's scales are read, never rewritten: the float32
        # bound; the steps' are the max of a bfloat16 row over 127: the
        # bf16 bound of their own size
        got = getattr(whole, s)
        _held(want[s][:, :, :POS], got[:, :, :POS], one[s][:, :, :POS],
              FP32_TOL, s)
        new = slice(POS, POS + TP_DECODE_STEPS)
        _held(want[s][:, :, new] / want[s][:, :, new],
              got[:, :, new] / want[s][:, :, new],
              one[s][:, :, new] / want[s][:, :, new], BF16_TOL, s)


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_block_of_the_dry_runs_layout(runs, name):
    """Every rank's cache tensors have the shapes of its block under the
    dry-run's variant specs, and their bytes are the dry-run's cache
    bytes a device (``launch.dryrun.tree_bytes``)."""
    from repro_torch.launch.dryrun import _tree_structs, tree_bytes
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.sharding import mesh_axes

    case = CASES[name]
    cfg = torch_tp.config(case)
    axes = mesh_axes(_mesh(case))
    init = (tfm.init_grouped_cache(cfg, case["batch"], MAX_LEN, device="meta")
            if case["variant"] == "ring" else
            tfm.init_quant_cache(cfg, case["batch"], MAX_LEN, device="meta"))
    structs = _tree_structs(init, _specs(case))
    for r, got in enumerate(_ranks(runs, case)):
        held = 4                                  # pos: a 0-d int32
        for f, struct in zip(structs._fields, structs):
            if not struct.shape:
                continue
            t = got[f"{name}/cache/{f}"]
            assert t.shape == struct.local_shape(axes), (f, r)
            held += t.size * struct.dtype.itemsize
        assert held == tree_bytes(structs, axes), r
