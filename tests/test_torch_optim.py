"""The port's hand-written AdamW against the JAX package's ``optim/adamw.py``
on the same gradients: the schedule, the global norm, and the state after
N updates -- ``step``, ``m``, ``v`` and ``master`` within 2e-5 of max(1,
the largest magnitude), bfloat16 parameters within one bfloat16 ulp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as RA
from repro_torch.convert import params_from_numpy
from repro_torch.optim import adamw as PA

from torch_parity import FP32_TOL, assert_same, to_numpy

CFG = dict(lr_peak=3e-3, lr_min=3e-4, warmup_steps=3, total_steps=12,
           weight_decay=0.1, clip_norm=1.0)


def _tree(rng):
    """A parameter tree with bf16 and float32 leaves, nested as a model's."""
    def bf16(*shape):
        return jnp.asarray(rng.normal(size=shape) * 0.5, jnp.bfloat16)

    return {"embed": bf16(16, 8), "ln_f": bf16(8),
            "layers": {"w": bf16(2, 8, 8),
                       "A_log": jnp.asarray(rng.normal(size=(2, 4)),
                                            jnp.float32)}}


def _grads(rng, params, scale):
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(size=p.shape) * scale, p.dtype),
        params)


def _port(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                             device="cpu")


@pytest.mark.parametrize("step", [0, 1, 2, 3, 4, 7, 12, 20])
def test_cosine_lr_at_warm_up_peak_and_end(step):
    ref_cfg, cfg = RA.AdamWConfig(**CFG), PA.AdamWConfig(**CFG)
    want = RA.cosine_lr(ref_cfg, jnp.asarray(step, jnp.int32))
    got = PA.cosine_lr(cfg, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert_same(want, got, tol=1e-7)
    if step == CFG["warmup_steps"]:
        assert float(got) == pytest.approx(CFG["lr_peak"])
    if step >= CFG["total_steps"]:
        assert float(got) == pytest.approx(CFG["lr_min"])


def test_global_norm():
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    assert_same(RA.global_norm(tree), PA.global_norm(_port(tree)),
                tol=FP32_TOL)


def test_init_matches_the_reference_state():
    tree = _tree(np.random.default_rng(1))
    want, got = RA.init(tree), PA.init(_port(tree))
    assert type(got).__name__ == "AdamWState"
    assert got._fields == want._fields == ("step", "m", "v", "master")
    assert got.step.dtype == torch.int32 and int(got.step) == 0
    for field in ("m", "v", "master"):
        assert_same(getattr(want, field), getattr(got, field), tol=0.0,
                    what=field)
    assert all(t.dtype == torch.float32 for t in
               PA.tree_leaves(got.master))


@pytest.mark.parametrize("grad_scale", [0.01, 10.0],
                         ids=["unclipped", "clipped"])
def test_n_updates_match_the_reference(grad_scale):
    """Eight updates from the same gradients (clipped by the global norm or
    not): the state within 2e-5 of max(1, |ref|), the bf16 parameters
    within one bf16 ulp of the reference's, the float32 ones within 2e-5.
    The port updates its tensors in place and returns them."""
    rng = np.random.default_rng(2)
    params = _tree(rng)
    ref_cfg, cfg = RA.AdamWConfig(**CFG), PA.AdamWConfig(**CFG)
    ref_state, ref_params = RA.init(params), params
    port_params = _port(params)
    state = PA.init(port_params)
    update = jax.jit(lambda g, s, p: RA.update(ref_cfg, g, s, p))
    for _ in range(8):
        grads = _grads(rng, params, grad_scale)
        ref_params, ref_state = update(grads, ref_state, ref_params)
        same_params = port_params
        port_params, state = PA.update(cfg, _port(grads), state, port_params)
        assert port_params is not None and all(
            a is b for a, b in zip(PA.tree_leaves(port_params),
                                   PA.tree_leaves(same_params)))
    assert int(state.step) == int(ref_state.step) == 8
    for field in ("m", "v", "master"):
        assert_same(getattr(ref_state, field), getattr(state, field),
                    tol=FP32_TOL, what=field)
    flat_ref = jax.tree_util.tree_leaves_with_path(ref_params)
    for path, want in flat_ref:
        got = port_params
        for key in path:
            got = got[key.key]
        want = np.asarray(want.astype(jnp.float32))
        got_np = to_numpy(got)
        if got.dtype == torch.bfloat16:
            # one bf16 ulp of the value: 2^(exponent - 7)
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want),
                                                      1e-30))) - 7)
            assert (np.abs(got_np - want) <= ulp).all(), path
        else:
            assert_same(want, got_np, tol=FP32_TOL, what=str(path))


def test_bf16_moments_keep_a_float32_master():
    tree = _port(_tree(np.random.default_rng(3)))
    state = PA.init(tree, moment_dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in PA.tree_leaves(state.m))
    assert all(t.dtype == torch.float32 for t in
               PA.tree_leaves(state.master))
    grads = PA.tree_map(torch.ones_like, tree)
    _, state = PA.update(PA.AdamWConfig(**CFG), grads, state, tree)
    assert all(t.dtype == torch.bfloat16 for t in PA.tree_leaves(state.v))
