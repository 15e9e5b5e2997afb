"""Training of the port against the reference, on the CPU: the loss and its
gradient with respect to every parameter for each architecture's reduced
config (the grid of ``tests/test_models_smoke.py::test_smoke_train_step``)
against ``jax.value_and_grad(model.loss)`` of the JAX package, from its
``init(PRNGKey(0))`` weights carried over through ``params_from_numpy``;
then ``make_train_step`` for three steps in both packages on the same
batches.  The MoE family is in ``tests/test_torch_train_moe.py``, the SSM
and hybrid families in ``tests/test_torch_train_ssm.py``.

Tolerance: the parity harness's bf16 bound, 2e-2 of max(1, the largest
magnitude) per leaf.  Most gradient leaves are far below 1, where that
bound is absolute, so each leaf is also held to point the way the
reference's does (cosine similarity above 0.999).  Both packages train in
bfloat16 and round at different places: the gradients of the bf16 leaves
that the reference reduces over batch and time (norm gains, biases,
``conv_w``) are sums that XLA rounds to bf16 after every add, where torch
adds in float32 and rounds once (ROADMAP F20); elsewhere the two differ by
1-2 % of a leaf's largest value.  MoE data is drawn so that no token sits
within ``ROUTE_MARGIN`` of a routing tie (F9)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.launch import steps as ref_steps
from repro.models import get_model as ref_get_model
from repro.optim import adamw as RA
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.launch.steps import make_train_step, value_and_grad
from repro_torch.models import get_model
from repro_torch.optim import adamw as PA

from test_torch_attention import ROUTE_MARGIN, _routing_margin
from torch_parity import BF16_TOL, assert_same, to_numpy

# the data seed per architecture; an MoE seed is one whose tokens keep the
# routing margin (the test fails on the margin first if that changes)
SEEDS = {"olmoe_1b_7b": 7, "llama4_maverick": 11}
B, S = 2, 32
COSINE = 0.999


def batch_for(cfg, seed, B=B, S=S):
    """Tokens and labels drawn from ``seed``; the encoder-decoder also gets
    frames (B, S, d_model) as the data pipeline makes them (normal x
    0.02)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(2, cfg.vocab - 1, size=(B, S)).astype(
        np.int32),
        "labels": rng.integers(2, cfg.vocab - 1, size=(B, S)).astype(
        np.int32)}
    if cfg.family in ("encdec", "audio"):
        batch["frames"] = (rng.standard_normal((B, S, cfg.d_model))
                           * 0.02).astype(np.float32)
    return batch


def carried_over(arch, **replace):
    """The reference's reduced model and its ``init(PRNGKey(0))`` weights,
    and the port's model with the same weights on the CPU."""
    ref_cfg = dataclasses.replace(ref_get_arch(arch).reduced(), **replace)
    cfg = dataclasses.replace(get_arch(arch).reduced(), **replace)
    ref_model = ref_get_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    return ref_model, ref_params, get_model(cfg), params


def guarded_batch(arch, ref_model, ref_params):
    batch = batch_for(ref_model.cfg, SEEDS.get(arch, 1))
    if ref_model.cfg.family == "moe":
        gap = _routing_margin(ref_model.cfg, ref_params, batch["tokens"])
        assert gap >= ROUTE_MARGIN, f"a routing near-tie ({gap})"
    return batch


def drawn_batch(ref_model, ref_params, seed, draws=50):
    """The first batch from ``seed``, ``seed + 1``, ... whose tokens keep
    the routing margin under ``ref_params`` (any batch for a model
    without experts)."""
    for s in range(seed, seed + draws):
        batch = batch_for(ref_model.cfg, s)
        if (ref_model.cfg.family != "moe" or _routing_margin(
                ref_model.cfg, ref_params, batch["tokens"]) >= ROUTE_MARGIN):
            return batch
    raise AssertionError(f"no batch without a routing near-tie in {draws}")


def assert_gradients_match(want, got, what=""):
    """Every leaf within the bf16 bound, pointing the reference's way."""
    assert want.keys() == got.keys(), what
    for k in want:
        if isinstance(want[k], dict):
            assert_gradients_match(want[k], got[k], f"{what}/{k}")
            continue
        assert got[k].dtype == params_dtype(want[k]), (what, k)
        w, g = to_numpy(want[k]).ravel(), to_numpy(got[k]).ravel()
        assert_same(w, g, tol=BF16_TOL, what=f"{what}/{k}")
        cos = float(w @ g / (np.linalg.norm(w) * np.linalg.norm(g)))
        assert cos > COSINE, (f"{what}/{k}", cos)


def params_dtype(ref_leaf):
    return {"bfloat16": torch.bfloat16,
            "float32": torch.float32}[str(ref_leaf.dtype)]


def check_loss_and_gradients(arch):
    ref_model, ref_params, model, params = carried_over(arch)
    batch = guarded_batch(arch, ref_model, ref_params)
    want_loss, want_grads = jax.jit(jax.value_and_grad(ref_model.loss))(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = value_and_grad(model, params, batch)
    assert loss.dtype == torch.float32 and loss.ndim == 0
    assert_same(want_loss, loss, tol=BF16_TOL, what="loss")
    assert abs(float(want_loss) - float(loss)) < 1e-3
    assert_gradients_match(want_grads, grads, arch)


def check_three_train_steps(arch):
    """``make_train_step`` in both packages, three steps on the same
    batches from the same weights: every loss, and the parameters and the
    master copy after the last step, within the bf16 bound."""
    ref_model, ref_params, model, params = carried_over(arch)
    opt_kw = dict(lr_peak=1e-3, warmup_steps=1, total_steps=3)
    ref_step = jax.jit(ref_steps.make_train_step(ref_model,
                                                 RA.AdamWConfig(**opt_kw)))
    step = make_train_step(model, PA.AdamWConfig(**opt_kw))
    ref_opt, opt = RA.init(ref_params), PA.init(params)
    for i in range(3):
        batch = drawn_batch(ref_model, ref_params,
                            SEEDS.get(arch, 1) + 100 * i)
        want, ref_params, ref_opt = ref_step(
            ref_params, ref_opt, {k: jnp.asarray(v) for k, v in batch.items()})
        loss, params, opt = step(params, opt, batch)
        assert loss.dtype == torch.float32 and loss.ndim == 0
        assert_same(want, loss, tol=BF16_TOL, what=f"loss, step {i}")
    assert int(opt.step) == 3
    assert_same(jax.tree_util.tree_map(np.asarray, ref_params), params,
                tol=BF16_TOL, what="params")
    assert_same(ref_opt.master, opt.master, tol=BF16_TOL, what="master")


# the dense and VLM families and the encoder-decoder here; the MoE family
# and the SSM and hybrid families in files of their own (xdist spreads the
# suite by file)
LOSS_ARCHS = ["gemma3_12b", "deepseek_67b", "qwen2_7b", "internlm2_20b",
              "chameleon_34b", "whisper_base"]


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_gradients_match_the_reference(arch):
    check_loss_and_gradients(arch)


@pytest.mark.parametrize("arch", ["qwen2_7b", "whisper_base"])
def test_three_train_steps_match_the_reference(arch):
    check_three_train_steps(arch)


def test_every_architecture_is_held_somewhere():
    from test_torch_train_moe import LOSS_ARCHS as MOE
    from test_torch_train_ssm import LOSS_ARCHS as SSM

    assert sorted(LOSS_ARCHS + MOE + SSM) == sorted(ARCH_IDS)
    assert all(get_model(get_arch(a).reduced()).loss is not None
               for a in ARCH_IDS)
