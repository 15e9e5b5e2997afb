"""The multi-device side in worlds of CPU ``gloo`` processes, against the
JAX package on XLA host devices.

Two worlds run once for the module (``tests/torch_worlds.py``, one process
a rank, a file rendezvous under ``tmp_path``): four ranks for the GPipe
pipeline, the placements of a 2x2 ``DeviceMesh`` and a hint's
redistribution; two ranks for the int8 error-feedback gradient mean, the
expert-parallel MoE layer over a ``model`` axis of 2 and the elastic
restore onto meshes of 1 and 2.  The JAX package's counterparts run once
in a subprocess with 4 XLA host devices (as its own
``tests/test_distribution.py`` runs its pipeline).  Tolerances: 1e-5 for
the float32 pipeline (the JAX package's own test), bit for bit for the
compressed mean and its residual (the same float32 operations), bf16 2e-2
of max(1, |ref|) for the MoE layer, bit for bit for the restore.
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import moe as RM

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.convert import for_ranks, params_from_numpy
from repro_torch.models import moe
from repro_torch.parallel.collectives import (dequantize_int8,
                                              quantize_int8)
from test_torch_attention import ROUTE_MARGIN
from torch_parity import BF16_TOL, assert_same
from torch_worlds import python_rank, run_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S_PIPE, L_PER, M, MB, D_PIPE = 4, 2, 8, 4, 16
MOE_B, MOE_S = 2, 8


def _moe_inputs():
    """Layer 0 of the reduced olmoe from the JAX package's init, and the
    first hidden states from seed 0, 1, ... that keep the routing margin
    (ROADMAP F9)."""
    cfg = ref_get_arch("olmoe_1b_7b").reduced()
    params = RM.init_moe_params(cfg, jax.random.PRNGKey(0))
    lp = {k: np.asarray(v[0], np.float32) for k, v in params["layers"].items()
          if k == "router" or k.startswith("we_")}
    import jax.numpy as jnp
    for seed in range(50):
        h = np.random.default_rng(seed).normal(
            size=(MOE_B, MOE_S, cfg.d_model)).astype(np.float32)
        h = np.asarray(jnp.asarray(h, jnp.bfloat16), np.float32)
        probs = jax.nn.softmax(jnp.asarray(h, jnp.bfloat16).reshape(
            -1, cfg.d_model).astype(jnp.float32) @ lp["router"], axis=-1)
        top = np.sort(np.asarray(probs), axis=-1)[:, ::-1]
        if (top[:, cfg.top_k - 1] - top[:, cfg.top_k]).min() >= ROUTE_MARGIN:
            return lp, h
    raise AssertionError("no hidden states without a routing near-tie")


REFERENCE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.parallel.pipeline import pipeline_apply
from repro.parallel.collectives import compressed_grad_mean
from repro.parallel.hints import sharding_policy
from repro.configs import get_arch
from repro.models import moe as RM

out = {OUT!r}
inp = dict(np.load(out + "/inputs.npz"))
res = {}

def stage_fn(params, x):
    def body(h, w):
        return jnp.tanh(h @ w), None
    h, _ = jax.lax.scan(body, x, params)
    return h

mesh = jax.make_mesh((4,), ("stage",))
res["pipe"] = np.asarray(pipeline_apply(stage_fn, jnp.asarray(inp["pipe_w"]),
                                        jnp.asarray(inp["pipe_x"]), mesh,
                                        axis="stage"))

mesh2 = jax.make_mesh((2,), ("data",), devices=jax.devices()[:2])
g = {"a": jnp.asarray(inp["g0_a"]), "b": {"c": jnp.asarray(inp["g0_c"])}}
z = jax.tree.map(jnp.zeros_like, g)
m, r = compressed_grad_mean(g, z, mesh2, axis="data")
res.update(same_mean_a=np.asarray(m["a"]), same_mean_c=np.asarray(m["b"]["c"]),
           same_res_a=np.asarray(r["a"]), same_res_c=np.asarray(r["b"]["c"]))

cfg = get_arch("olmoe_1b_7b").reduced()
lp = {k[3:]: jnp.asarray(v, jnp.float32 if k == "lp_router" else jnp.bfloat16)
      for k, v in inp.items() if k.startswith("lp_")}
h = jnp.asarray(inp["moe_h"], jnp.bfloat16)
mesh12 = jax.make_mesh((1, 2), ("data", "model"), devices=jax.devices()[:2])
with sharding_policy({"__mesh__": mesh12}):
    y, aux = RM.moe_ffn_a2a(cfg, lp, h)
res["moe_out"] = np.asarray(y, np.float32)
res["moe_aux"] = np.asarray(aux)
mesh21 = jax.make_mesh((2, 1), ("data", "model"), devices=jax.devices()[:2])
with sharding_policy({"__mesh__": mesh21, "__fsdp__": True}):
    y, aux = RM.moe_ffn_a2a(cfg, lp, h)
res["fsdp_out"] = np.asarray(y, np.float32)
res["fsdp_aux"] = np.asarray(aux)

mesh22 = jax.make_mesh((2, 2), ("data", "model"))
full = jax.device_put(jnp.arange(16.0).reshape(4, 4),
                      NamedSharding(mesh22, P(("data", "model"), None)))
by_id = {s.device.id: np.asarray(s.data) for s in full.addressable_shards}
res["joint"] = np.stack([by_id[mesh22.devices[d, m].id]
                         for d in range(2) for m in range(2)])
np.savez(out + "/ref.npz", **res)
print("REF-OK")
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Inputs, the two worlds of the port and the JAX package's run."""
    tmp = tmp_path_factory.mktemp("worlds")
    rng = np.random.default_rng(0)
    lp, h = _moe_inputs()
    inputs = {
        "pipe_w": (rng.normal(size=(S_PIPE, L_PER, D_PIPE, D_PIPE)) * 0.2
                   ).astype(np.float32),
        "pipe_x": rng.normal(size=(M, MB, D_PIPE)).astype(np.float32),
        "moe_h": h,
        **{f"lp_{k}": v for k, v in lp.items()},
    }
    for r in range(2):
        inputs[f"g{r}_a"] = rng.normal(size=(64,)).astype(np.float32)
        inputs[f"g{r}_c"] = (rng.normal(size=(8, 16)) * 10 ** (r - 2)
                             ).astype(np.float32)
    np.savez(tmp / "inputs.npz", **inputs)
    state = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
             "b": torch.randn(4, 6, generator=torch.Generator().manual_seed(1)
                              ).to(torch.bfloat16)}
    CheckpointManager(str(tmp / "ckpt")).save(1, state)

    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE.replace(
            "{OUT!r}", repr(str(tmp))))],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    run_world(python_rank("pipeline", 4, tmp), 4)
    run_world(python_rank("pair", 2, tmp), 2)
    out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0 and "REF-OK" in out, err[-3000:]

    def load(name):
        with np.load(tmp / name) as z:
            return {k: z[k] for k in z.files}

    return {"inputs": inputs, "state": state, "ref": load("ref.npz"),
            "pipeline": [load(f"pipeline_{r}.npz") for r in range(4)],
            "pair": [load(f"pair_{r}.npz") for r in range(2)]}


def test_pipeline_matches_sequential_and_the_reference(worlds):
    x, Ws = worlds["inputs"]["pipe_x"], worlds["inputs"]["pipe_w"]
    h = torch.from_numpy(x)
    for s in range(S_PIPE):
        for w in torch.from_numpy(Ws[s]):
            h = torch.tanh(h @ w)
    for r, got in enumerate(worlds["pipeline"]):    # every rank has outs
        np.testing.assert_allclose(got["got"], h.numpy(), atol=1e-5)
        np.testing.assert_allclose(got["got"], worlds["ref"]["pipe"],
                                   atol=1e-5)


def test_joint_axes_land_on_the_reference_ranks(worlds):
    """P(("data", "model"), None) on a 2x2 mesh: DTensor's Shard on both
    mesh dims puts block d * 2 + m on coordinate (d, m), as JAX does."""
    ref = worlds["ref"]["joint"]
    for r, got in enumerate(worlds["pipeline"]):
        d, m = got["coord"]
        assert d * 2 + m == r
        np.testing.assert_array_equal(got["joint"], ref[d * 2 + m])
        np.testing.assert_array_equal(got["joint"],
                                      np.arange(16.0).reshape(4, 4)[r:r + 1])


def test_hint_redistributes_a_dtensor_and_passes_a_tensor(worlds):
    full = np.arange(16.0).reshape(4, 4)
    for got in worlds["pipeline"]:
        d, _ = got["coord"]
        np.testing.assert_array_equal(got["moved"], full[2 * d:2 * d + 2])
        np.testing.assert_array_equal(got["moved_full"], full)
        assert bool(got["plain_is_same"])


def test_compressed_mean_of_equal_grads_equals_the_reference(worlds):
    ref = worlds["ref"]
    for got in worlds["pair"]:
        for k in ("same_mean_a", "same_mean_c", "same_res_a", "same_res_c"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _np_quant(x):
    scale = np.float32(max(np.abs(x).max(), np.float32(1e-12))
                       / np.float32(127.0))
    q = np.clip(np.rint(x / scale), -127, 127)
    return q, scale, (q.astype(np.float32) * scale).astype(np.float32)


def test_compressed_mean_of_own_grads_is_the_mean_of_dequantized(worlds):
    """Each rank's own gradients: the mean is the numpy mean of both
    ranks' dequantized tensors, and each residual is ``x - deq`` exactly;
    the second step adds the residual back before quantizing."""
    inp = worlds["inputs"]
    pair = worlds["pair"]
    for leaf in ("a", "c"):
        xs = [inp[f"g{r}_{leaf}"] for r in range(2)]
        res = [np.zeros_like(x) for x in xs]
        for step in (1, 2):
            xt = [x + e for x, e in zip(xs, res)]
            deq = [_np_quant(x)[2] for x in xt]
            want = (deq[0] + deq[1]) / np.float32(2.0)
            res = [x - d for x, d in zip(xt, deq)]
            for r in range(2):
                np.testing.assert_array_equal(
                    pair[r][f"own_mean{step}_{leaf}"], want)
                np.testing.assert_array_equal(
                    pair[r][f"own_res{step}_{leaf}"], res[r])
    # the two ranks end on the same mean
    for k in pair[0]:
        if k.startswith("own_mean"):
            np.testing.assert_array_equal(pair[0][k], pair[1][k])


def test_compressed_psum_error_feedback():
    """int8 EF-compression: accumulated mean error stays bounded and the
    residual carries exactly the quantization error (the JAX package's
    ``tests/test_runtime.py`` test, re-pointed)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(256,)).astype(np.float32)
    residual = np.zeros_like(x)
    drift = []
    for _ in range(20):
        xt = x + residual
        q, s = quantize_int8(torch.from_numpy(xt))
        deq = dequantize_int8(q, s).numpy()
        residual = xt - deq
        drift.append(np.abs(residual).max())
        assert q.dtype == torch.int8 and int(q.abs().max()) <= 127
    # error feedback keeps the residual bounded by one quantization step
    assert drift[-1] <= float(np.abs(x).max() / 127.0 * 2)


def test_quantize_matches_the_reference_bit_for_bit():
    from repro.parallel.collectives import quantize_int8 as ref_quant

    rng = np.random.default_rng(3)
    for x in (rng.normal(size=(300,)).astype(np.float32) * 3,
              np.zeros(5, np.float32),
              np.array([0.5, -0.5, 1.5, 127.0, -254.0], np.float32)):
        q_ref, s_ref = ref_quant(jax.numpy.asarray(x))
        q, s = quantize_int8(torch.from_numpy(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
        assert float(s) == float(s_ref)


def test_moe_a2a_matches_sorted_and_the_reference(worlds):
    inp = worlds["inputs"]
    cfg = get_arch("olmoe_1b_7b").reduced()
    lp = params_from_numpy({k[3:]: v for k, v in inp.items()
                            if k.startswith("lp_")}, device="cpu")
    lp = {k: v.to(torch.bfloat16) if k.startswith("we_") else v
          for k, v in lp.items()}
    h = torch.from_numpy(inp["moe_h"]).to(torch.bfloat16)
    want, aux = moe.moe_ffn_sorted(cfg, lp, h)
    got = np.concatenate([p["moe_out"] for p in worlds["pair"]], axis=1)
    assert got.shape == (MOE_B, MOE_S, cfg.d_model)
    assert_same(want.float().numpy(), got, tol=BF16_TOL, what="vs sorted")
    assert_same(worlds["ref"]["moe_out"], got, tol=BF16_TOL,
                what="vs the reference's a2a")
    for p in worlds["pair"]:
        assert float(p["moe_aux"]) == pytest.approx(float(aux), rel=1e-6)
        assert float(p["moe_aux"]) == pytest.approx(
            float(worlds["ref"]["moe_aux"]), rel=1e-5)


def test_moe_a2a_gathers_fsdp_cut_experts(worlds):
    """FSDP on a (data 2, model 1) mesh: each rank holds every expert
    cut in half on F, declared by ``"__params__"`` (the reference's
    ``"__fsdp__"`` cut), gathers them for the layer
    (``hints.layer_blocks``) and routes its own row: equal to
    ``moe_ffn_sorted`` on that row and to the reference's row."""
    inp = worlds["inputs"]
    cfg = get_arch("olmoe_1b_7b").reduced()
    lp = params_from_numpy({k[3:]: v for k, v in inp.items()
                            if k.startswith("lp_")}, device="cpu")
    lp = {k: v.to(torch.bfloat16) if k.startswith("we_") else v
          for k, v in lp.items()}
    h = torch.from_numpy(inp["moe_h"]).to(torch.bfloat16)
    for r, got in enumerate(worlds["pair"]):
        want, aux = moe.moe_ffn_sorted(cfg, lp, h[r:r + 1])
        assert got["fsdp_out"].shape == (1, MOE_S, cfg.d_model)
        assert_same(want.float().numpy(), got["fsdp_out"], tol=BF16_TOL,
                    what=f"rank {r} vs sorted")
        assert_same(worlds["ref"]["fsdp_out"][r:r + 1], got["fsdp_out"],
                    tol=BF16_TOL, what=f"rank {r} vs the reference")
        assert float(got["fsdp_aux"]) == pytest.approx(float(aux), rel=1e-6)
    assert float(worlds["pair"][0]["fsdp_aux"]) == pytest.approx(
        float(worlds["ref"]["fsdp_aux"]), rel=1e-5)


def test_moe_a2a_without_a_mesh_is_sorted():
    cfg = get_arch("olmoe_1b_7b").reduced()
    params = moe.init_moe_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    lp = {k: v[0] for k, v in params["layers"].items()}
    h = torch.randn(2, 6, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2)).to(torch.bfloat16)
    a, aux_a = moe.moe_ffn_a2a(cfg, lp, h)
    b, aux_b = moe.moe_ffn_sorted(cfg, lp, h)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


@pytest.mark.parametrize("mesh", ["one", "two"])
def test_elastic_restore_is_bit_for_bit(worlds, mesh):
    """The checkpoint restored onto a ``DeviceMesh`` of 1 and of 2:
    ``full_tensor()`` equals the saved leaf bit for bit, and each rank
    holds its shard (rows of ``w``, columns of ``b``)."""
    w = worlds["state"]["w"].numpy()
    b = worlds["state"]["b"].view(torch.int16).numpy()
    n = 1 if mesh == "one" else 2
    for r, got in enumerate(worlds["pair"]):
        np.testing.assert_array_equal(got[f"{mesh}_w_full"], w)
        np.testing.assert_array_equal(got[f"{mesh}_b_full"], b)
        i = 0 if n == 1 else r
        np.testing.assert_array_equal(got[f"{mesh}_w_local"],
                                      w[i * 8 // n:(i + 1) * 8 // n])
        np.testing.assert_array_equal(got[f"{mesh}_b_local"],
                                      b[:, i * 6 // n:(i + 1) * 6 // n])


def test_for_ranks_cuts_stages_and_experts():
    rng = np.random.default_rng(5)
    tree = {"layers": {"wq": rng.normal(size=(8, 3, 4)),
                       "we_up": rng.normal(size=(8, 6, 3, 2))},
            "embed": rng.normal(size=(8, 5))}
    staged = for_ranks(tree["layers"], stages=4)
    assert staged["wq"].shape == (4, 2, 3, 4)
    np.testing.assert_array_equal(staged["wq"][2, 1], tree["layers"]["wq"][5])
    experts = for_ranks({k: torch.from_numpy(v)
                         for k, v in tree["layers"].items()},
                        experts=(1, 3))
    assert torch.equal(experts["we_up"], torch.from_numpy(
        tree["layers"]["we_up"][:, 2:4]))
    assert experts["wq"].shape == (8, 3, 4)        # not an expert stack
    with pytest.raises(ValueError, match="stages"):
        for_ranks(tree["layers"], stages=3)
    with pytest.raises(ValueError, match="experts over 4"):
        for_ranks(tree["layers"], experts=(0, 4))
