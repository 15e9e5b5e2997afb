"""Whole models under the dry-run's sharding policy plus a live mesh, in
worlds of CPU ``gloo`` processes, against the JAX package on a 2x2 mesh of
XLA host devices.

Six cases: the reduced olmoe-1b-7b with 4 experts, top-2 and a capacity
factor of 8 (no token dropped at any batch size, so the data rows a rank
routes do not change what is kept) through the expert-parallel ``a2a``
layer, and the same model through ``sorted``, which routes the whole
gathered sequence in every ``model`` rank, also at a capacity factor of
1.0, which drops pairs: ``sorted`` ranks the whole batch's pairs, over
the data cut too, against one capacity; the reduced qwen2-7b, whose
residual is cut on the sequence like the MoE model's; the reduced
mamba2-370m and zamba2-2.7b, whose residual is cut on its channels
(each block gathers its input's channels whole).  Each runs
in a world of 2 ranks (``model`` 2) and of 4 (``data`` 2 x ``model`` 2):
the loss and every gradient leaf, the prefill's last-position logits and
cache, and the parameters after one ``make_train_step``, each rank on its
data row, with its share of the experts.  The reference runs once in a
subprocess with 4 XLA host devices, an ``Auto``-axis mesh (``jax.make_mesh``
defaults to ``Explicit`` axes in JAX 0.9, under which
``with_sharding_constraint`` refuses the policy's specs) and the same
policy.  Tolerances: bf16 2e-2 of max(1, |ref|) for every value, and a
cosine above 0.999 for every gradient leaf, as in
``tests/test_torch_train.py``.

Beside them, without worlds: the hint calls of every family's loss,
prefill and decode, counted by name, equal the reference's, and without a
policy every call returns its argument itself (so every output is bit
for bit what it is without the hints).
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
CASES = {
    "olmoe": dict(arch="olmoe_1b_7b", impl="a2a",
                  replace=dict(n_experts=4, top_k=2, capacity_factor=8.0)),
    "olmoe_sorted": dict(arch="olmoe_1b_7b", impl="sorted",
                         replace=dict(n_experts=4, top_k=2,
                                      capacity_factor=8.0)),
    # a capacity that drops pairs: the whole batch's pairs are ranked
    # against one capacity, as the reference ranks them, over the data cut
    "olmoe_sorted_drop": dict(arch="olmoe_1b_7b", impl="sorted",
                              replace=dict(n_experts=4, top_k=2,
                                           capacity_factor=1.0)),
    "qwen2": dict(arch="qwen2_7b", impl="sorted", replace={}),
    "mamba2": dict(arch="mamba2_370m", impl="sorted", replace={}),
    "zamba2": dict(arch="zamba2_2_7b", impl="sorted", replace={}),
}
WORLDS = (2, 4)
# The reference's mesh for each world and case: its 2x2 mesh, and its 1x2
# mesh for the a2a model in the world of 2, since that layer routes each
# data row apart -- its load-balancing loss is a row's, and a world with
# one data row routes the whole batch together.
REF_MESH = {(w, name): "1x2" if w == 2 and CASES[name]["impl"] == "a2a"
            else "2x2" for w in WORLDS for name in CASES}
OWN = ("we_gate", "we_up", "we_down")   # a rank's share of the experts

REFERENCE = """
import dataclasses, json
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_arch
from repro.configs.base import SHAPES
from repro.launch.dryrun import make_policy
from repro.launch.steps import make_train_step
from repro.models import get_model
from repro.optim import adamw
from repro.parallel.hints import sharding_policy

out = {OUT!r}
cases = json.load(open(out + "/mesh_cases.json"))
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

res = {{}}
for mesh_id, name in {RUNS!r}:
    case, mesh = cases[name], meshes[mesh_id]
    cfg = dataclasses.replace(get_arch(case["arch"]).reduced(),
                              **case["replace"])
    model = get_model(cfg, moe_impl=case["impl"])
    flat = {{k[len(name) + 3:]: jnp.asarray(v, case["dtypes"][k[len(name) + 3:]])
            for k, v in inp.items() if k.startswith(name + "/p/")}}
    params = unflatten(flat)
    batch = {{k: jnp.asarray(inp[name + "/" + k]) for k in ("tokens", "labels")}}
    train = dict(make_policy(cfg, SHAPES["train_4k"], mesh), __mesh__=mesh)
    prefill = dict(make_policy(cfg, SHAPES["prefill_32k"], mesh),
                   __mesh__=mesh)
    with mesh, sharding_policy(train):
        loss, grads = jax.jit(jax.value_and_grad(model.loss))(params, batch)
        step = jax.jit(make_train_step(model, adamw.AdamWConfig(**case["opt"])))
        loss1, params1, _ = step(params, adamw.init(params), batch)
    with mesh, sharding_policy(prefill):
        logits, cache = model.prefill(params, {{"tokens": batch["tokens"]}},
                                      {MAX_LEN})
    key = mesh_id + ":" + name
    res[key + "/loss"] = np.asarray(loss, np.float32)
    res[key + "/step_loss"] = np.asarray(loss1, np.float32)
    res[key + "/logits"] = np.asarray(logits, np.float32)
    for field, v in cache._asdict().items():
        if np.ndim(v):
            res[key + "/cache/" + field] = np.asarray(v, np.float32)
    res.update({{key + "/g/" + k: v for k, v in flatten(grads).items()}})
    res.update({{key + "/s/" + k: v for k, v in flatten(params1).items()}})
np.savez(out + "/mesh_ref.npz", **res)
print("REF-OK")
"""


def _case_inputs(name, case):
    """The reference's ``init(PRNGKey(0))`` weights of the case, flattened
    to float32 with their dtypes, and a batch; for the MoE case the first
    seed whose tokens keep the routing margin (ROADMAP F9)."""
    cfg = dataclasses.replace(ref_get_arch(case["arch"]).reduced(),
                              **case["replace"])
    model = ref_get_model(cfg, moe_impl=case["impl"])
    params = model.init(jax.random.PRNGKey(0))
    for seed in range(1, 60):
        batch = batch_for(cfg, seed, B=B, S=S)
        if (cfg.family != "moe" or _routing_margin(
                cfg, params, batch["tokens"]) >= ROUTE_MARGIN):
            break
    else:
        raise AssertionError("no batch without a routing near-tie")
    flat = flatten(jax.tree_util.tree_map(np.asarray, params))
    arrays = {f"{name}/p/{k}": np.asarray(v, np.float32)
              for k, v in flat.items()}
    arrays.update({f"{name}/{k}": batch[k] for k in ("tokens", "labels")})
    dtypes = {k: str(v.dtype) for k, v in flat.items()}
    return arrays, dict(case, dtypes=dtypes, opt=OPT)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's run and the port's worlds of 2 and 4 ranks."""
    from torch_worlds import MESH_MAX_LEN

    tmp = tmp_path_factory.mktemp("mesh_model")
    arrays, cases = {}, {}
    for name, case in CASES.items():
        a, cases[name] = _case_inputs(name, case)
        arrays.update(a)
    np.savez(tmp / "inputs.npz", **arrays)
    with open(tmp / "mesh_cases.json", "w") as f:
        json.dump(cases, f)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    script = textwrap.dedent(REFERENCE.format(
        OUT=str(tmp), MAX_LEN=MESH_MAX_LEN,
        RUNS=sorted({(m, n) for (_, n), m in REF_MESH.items()})))
    ref = subprocess.Popen([sys.executable, "-c", script], cwd=ROOT, env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        for world in WORLDS:
            run_world(python_rank("mesh_model", world, tmp), world,
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

    return {"inputs": arrays, "ref": load("mesh_ref.npz"),
            "worlds": {w: [load(f"mesh_model_{w}_{r}.npz")
                           for r in range(w)] for w in WORLDS}}


def _whole(ranks, key, world):
    """A leaf as the reference holds it: a rank's share of the experts
    joined over ``model`` (dim -3), any other leaf as rank 0 holds it."""
    leaf = key.rsplit("/", 1)[-1]
    if leaf in OWN and "/olmoe/" in f"/{key}":
        return np.concatenate([ranks[m][key] for m in range(2)], axis=-3)
    return ranks[0][key]


def _leaves(ref, name, kind):
    pre = f"{name}/{kind}/"
    return sorted(k for k in ref if k.startswith(pre))


def _ref(runs, world, name):
    """The reference's results for ``name`` on the mesh ``world`` is held
    to, keyed as the ranks key theirs."""
    pre = REF_MESH[(world, name)] + ":"
    return {k[len(pre):]: v for k, v in runs["ref"].items()
            if k.startswith(pre + name + "/")}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_loss_matches_the_reference(runs, name, world):
    want = _ref(runs, world, name)[f"{name}/loss"]
    for r, got in enumerate(runs["worlds"][world]):
        assert_same(want, got[f"{name}/loss"], tol=BF16_TOL,
                    what=f"{name} rank {r}")
        assert got[f"{name}/loss"] == runs["worlds"][world][0][f"{name}/loss"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_the_reference(runs, name, world):
    """Every leaf within the bf16 bound and pointing the reference's way;
    a leaf each rank holds whole is equal in every rank (its gradient
    summed over the ranks), a rank's experts equal in each data row."""
    ref, ranks = _ref(runs, world, name), runs["worlds"][world]
    keys = _leaves(ref, name, "g")
    assert keys
    for key in keys:
        leaf = key.rsplit("/", 1)[-1]
        own = name == "olmoe" and leaf in OWN
        for r, got in enumerate(ranks):
            peer = ranks[r % 2] if own else ranks[0]
            np.testing.assert_array_equal(got[key], peer[key], err_msg=key)
        w, g = ref[key].ravel(), _whole(ranks, key, world).ravel()
        assert_same(ref[key], _whole(ranks, key, world), tol=BF16_TOL,
                    what=f"{key} ({world} ranks)")
        cos = float(w @ g / (np.linalg.norm(w) * np.linalg.norm(g)))
        assert cos > COSINE, (key, world, cos)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_prefill_matches_the_reference(runs, name, world):
    """Last-position logits equal in every rank of a data row, and the
    whole sequence's cache, each within the bf16 bound of the reference's
    rows."""
    ref, ranks = _ref(runs, world, name), runs["worlds"][world]
    n_data = world // 2
    rows = B // n_data
    for r, got in enumerate(ranks):
        d = r // 2
        sl = slice(d * rows, (d + 1) * rows)
        np.testing.assert_array_equal(got[f"{name}/logits"],
                                      ranks[2 * d][f"{name}/logits"])
        assert_same(ref[f"{name}/logits"][sl], got[f"{name}/logits"],
                    tol=BF16_TOL, what=f"{name} logits rank {r}")
        caches = [k for k in ref if k.startswith(f"{name}/cache/")]
        assert caches
        for key in caches:
            # the hybrid's SSM state is (G, per, B, ...), its K/V (G, B, ...)
            bdim = 2 if key.endswith(("/conv", "/state")) and \
                name == "zamba2" else 1
            want = np.take(ref[key], np.arange(sl.start, sl.stop), axis=bdim)
            assert_same(want, got[key], tol=BF16_TOL, what=f"{key} rank {r}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_one_train_step_matches_the_reference(runs, name, world):
    """``make_train_step`` once: the loss and every parameter after it;
    the leaves each rank holds whole stay equal in every rank."""
    ref, ranks = _ref(runs, world, name), runs["worlds"][world]
    for got in ranks:
        assert_same(ref[f"{name}/step_loss"], got[f"{name}/step_loss"],
                    tol=BF16_TOL, what=name)
    for key in _leaves(ref, name, "s"):
        leaf = key.rsplit("/", 1)[-1]
        own = name == "olmoe" and leaf in OWN
        for r, got in enumerate(ranks):
            peer = ranks[r % 2] if own else ranks[0]
            np.testing.assert_array_equal(got[key], peer[key], err_msg=key)
        assert_same(ref[key], _whole(ranks, key, world), tol=BF16_TOL,
                    what=f"{key} ({world} ranks)")


@pytest.mark.parametrize("world", WORLDS)
def test_the_a2a_model_runs_under_a_policy_of_the_mesh_alone(runs, world):
    """The fault this slice repairs: ``get_model(cfg, moe_impl="a2a")``'s
    loss under ``{"__mesh__": mesh}`` raised at the residual add; it runs
    now, in the layout the dry-run's policy gives, to the same loss."""
    for got in runs["worlds"][world]:
        assert got["olmoe/mesh_only_loss"] == got["olmoe/loss"]


@pytest.mark.parametrize("rank", [0, 1])
def test_a_split_takes_the_whole_sequence_or_a_block_and_nothing_else(rank):
    """Under a cut, ``block`` keeps this rank's block of a whole tensor
    and passes a block; ``gather`` passes a whole one; any other length
    along the sequence is a layout fault and raises where it happens.
    Without a cut every length passes."""
    from repro_torch.parallel.hints import Split

    split = Split(S=16, n=2, rank=rank, model=None, data=None, n_data=1)
    x = torch.arange(2 * 16 * 3).reshape(2, 16, 3)
    mine = x[:, 8 * rank:8 * (rank + 1)]
    assert torch.equal(split.block(x), mine)
    assert split.block(mine) is mine
    assert split.gather(x) is x
    labels = x[..., 0]
    assert torch.equal(split.block(labels),
                       labels[:, 8 * rank:8 * (rank + 1)])
    for bad in (x[:, :5], x[:, :12], x[:, :1]):
        with pytest.raises(ValueError, match="neither the whole"):
            split.block(bad)
        with pytest.raises(ValueError, match="neither the whole"):
            split.gather(bad)
    whole = Split(S=16, n=1, rank=0, model=None, data=None, n_data=1)
    for t in (x, x[:, :5]):
        assert whole.block(t) is t and whole.gather(t) is t


# ---------------------------------------------------------------------------
# Hint calls by name, in both packages, without a policy
# ---------------------------------------------------------------------------

# every family at one layer (one encoder layer, one hybrid group): the
# reference's scan traces its body once, where the port loops over layers
COUNT_ARCHS = {
    "qwen2_7b": dict(n_layers=1),
    "gemma3_12b": dict(n_layers=1),
    "olmoe_1b_7b": dict(n_layers=1),
    "mamba2_370m": dict(n_layers=1),
    "zamba2_2_7b": dict(n_layers=2),
    "whisper_base": dict(n_layers=1, n_encoder_layers=1),
}
REF_HINT_MODULES = ("repro.models.transformer", "repro.models.moe",
                    "repro.models.ssm", "repro.models.hybrid",
                    "repro.models.encdec", "repro.parallel.hints")
PORT_HINT_MODULES = ("repro_torch.models.transformer",
                     "repro_torch.models.moe", "repro_torch.models.ssm",
                     "repro_torch.models.hybrid", "repro_torch.models.encdec")


def _counting(monkeypatch, modules, counts, same):
    import importlib

    for mod_name in modules:
        mod = importlib.import_module(mod_name)
        real = mod.hint

        def counted(x, name, real=real):
            counts[name] = counts.get(name, 0) + 1
            y = real(x, name)
            same.append(y is x)
            return y

        monkeypatch.setattr(mod, "hint", counted)


def _hint_counts(model, params, batch, to, counts):
    """The hint calls by name of the loss, the prefill and one decode
    step, each alone."""
    inputs = {k: to(v) for k, v in batch.items()}
    out = {}
    counts.clear()
    model.loss(params, inputs)
    out["loss"] = dict(counts)
    counts.clear()
    _, cache = model.prefill(
        params, {k: v for k, v in inputs.items() if k in ("tokens", "frames")},
        16)
    out["prefill"] = dict(counts)
    counts.clear()
    model.decode(params, cache, inputs["tokens"][:, :1])
    out["decode"] = dict(counts)
    return out


@pytest.mark.parametrize("arch", list(COUNT_ARCHS))
def test_hint_calls_by_name_equal_the_reference(arch, monkeypatch):
    import jax.numpy as jnp

    from repro_torch.configs import get_arch
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import get_model

    replace = COUNT_ARCHS[arch]
    ref_cfg = dataclasses.replace(ref_get_arch(arch).reduced(), **replace)
    cfg = dataclasses.replace(get_arch(arch).reduced(), **replace)
    ref_model, model = ref_get_model(ref_cfg), get_model(cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_params),
                               device="cpu")
    batch = batch_for(cfg, 1, B=2, S=8)
    ref_counts, port_counts, same = {}, {}, []
    _counting(monkeypatch, REF_HINT_MODULES, ref_counts, same)
    _counting(monkeypatch, PORT_HINT_MODULES, port_counts, same)
    want = _hint_counts(ref_model, ref_params, batch, jnp.asarray, ref_counts)
    got = _hint_counts(model, params, batch, torch.as_tensor, port_counts)
    assert got == want, arch
    assert want["loss"], arch                       # every loss hints
    assert same and all(same)       # no policy: each call returns x itself


def test_the_reference_sites_in_the_port():
    """The reference's 16 ``hint`` sites, file by file, and no others;
    the two ``"block_in"`` sites of the reference's MoE forward are
    ``transformer.dense_layer``'s in the port, whose MoE forward runs that
    layer (the call counts above hold it)."""
    import re

    def sites(pkg):
        out = {}
        for f in ("transformer", "moe", "ssm", "hybrid", "encdec"):
            with open(os.path.join(ROOT, "src", pkg, "models", f + ".py")) as h:
                out[f] = len(re.findall(r"\bhint\(", h.read()))
        return out

    ref, port = sites("repro"), sites("repro_torch")
    assert sum(ref.values()) == 16
    assert port == {**ref, "moe": ref["moe"] - 2}
