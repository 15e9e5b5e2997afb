"""The dense transformer's two decode variants in the port: the ring-banked
local caches (``grouped_decode_step``) and the int8 cache
(``decode_step_quant``).  Each is held against the port's own full-buffer
decode with the bounds of the JAX package's ``tests/test_perf_variants.py``
(ring: atol 0.05, rtol 0.02 on the logits, past the ring's wrap; int8:
softmax within 0.05), and against the reference's variant on the same
weights converted from the reference (2e-2 of the largest logit, the
harness's bf16 tolerance); ``_quant_rows`` against the reference's, int8
values exactly and scales within float32's 2e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs.base import ArchConfig as RefArchConfig
from repro.models import transformer as RT
from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import params_from_numpy
from repro_torch.models import transformer as PT

from torch_parity import BF16_TOL, FP32_TOL, assert_same, to_numpy

GEMMA_LIKE = dict(name="g-mini", family="dense", n_layers=6, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
                  sliding_window=8, local_global_ratio=2)  # 2 local : 1 global


def _gemma_like():
    return ArchConfig(**GEMMA_LIKE), RefArchConfig(**GEMMA_LIKE)


def _port_params(cfg, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return PT.init_dense_params(cfg, gen, device="cpu")


def _converted(ref_cfg, seed=0):
    ref_params = RT.init_dense_params(ref_cfg, jax.random.PRNGKey(seed))
    return ref_params, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")


def _argmax(logits):
    return logits.float().argmax(-1).to(torch.int32)[:, None]


# ---------------------------------------------------------------------------
# Against the port's own full-buffer decode (the reference's own bounds)
# ---------------------------------------------------------------------------


def test_grouped_ring_decode_matches_dense_decode():
    """Ring-banked local caches track the full-buffer decode (window
    masking == ring retention), including past wrap-around."""
    cfg, _ = _gemma_like()
    params = _port_params(cfg)
    B, steps, max_len = 2, 14, 32        # 14 > window (8): the ring wraps
    cache_full = PT.init_cache(cfg, B, max_len, device="cpu")
    cache_ring = PT.init_grouped_cache(cfg, B, max_len, device="cpu")
    tok = torch.full((B, 1), 3, dtype=torch.int32)
    for step in range(steps):
        lf, cache_full = PT.decode_step(cfg, params, cache_full, tok)
        lr, cache_ring = PT.grouped_decode_step(cfg, params, cache_ring, tok)
        np.testing.assert_allclose(lf.float().numpy(), lr.float().numpy(),
                                   atol=0.05, rtol=0.02, err_msg=str(step))
        tok = _argmax(lf)
    assert cache_ring.pos == steps == cache_full.pos


def test_int8_kv_decode_close_to_exact():
    """Quantized-cache decode tracks the exact decode closely."""
    cfg = get_arch("qwen2_7b").reduced()
    params = _port_params(cfg)
    B, steps, max_len = 2, 6, 16
    cache = PT.init_cache(cfg, B, max_len, device="cpu")
    cache_q = PT.init_quant_cache(cfg, B, max_len, device="cpu")
    tok = torch.full((B, 1), 3, dtype=torch.int32)
    for _ in range(steps):
        lf, cache = PT.decode_step(cfg, params, cache, tok)
        lq, cache_q = PT.decode_step_quant(cfg, params, cache_q, tok)
        pf = torch.softmax(lf.float(), -1)
        pq = torch.softmax(lq.float(), -1)
        assert float((pf - pq).abs().max()) < 0.05
        tok = _argmax(lf)
    assert cache_q.k_q.dtype == torch.int8 and cache_q.pos == steps


@pytest.mark.parametrize("pos,window", [(0, 8), (7, 8), (8, 8), (1099, 1024),
                                        (2047, 1024), (13, 6), (25, 6)])
def test_ring_slot_is_pos_mod_window(pos, window):
    """The slot is what the reference's ``jax.lax.rem(pos, W)`` gives, an
    AND where W is a power of two, a remainder otherwise."""
    assert PT.ring_slot(pos, window) == int(jax.lax.rem(pos, window))


def test_grouped_layout_and_params_are_views_of_the_layer_stack():
    cfg, _ = _gemma_like()
    params = _port_params(cfg)
    assert PT.grouped_layout(cfg) == (2, 2)
    local, glob = PT._grouped_params(cfg, params)
    wq = params["layers"]["wq"]
    assert torch.equal(local["wq"][1, 0], wq[3])
    assert torch.equal(glob["wq"][1], wq[5])
    assert local["wq"].data_ptr() == wq.data_ptr()        # no copy
    with pytest.raises(ValueError, match="local:global"):
        PT.grouped_layout(get_arch("qwen2_7b").reduced())


# ---------------------------------------------------------------------------
# Against the reference's variants, weights converted from the reference
# ---------------------------------------------------------------------------


def test_grouped_decode_matches_reference():
    cfg, ref_cfg = _gemma_like()
    ref_params, params = _converted(ref_cfg, seed=1)
    B, steps, max_len = 2, 12, 16
    toks = np.random.default_rng(1).integers(
        2, cfg.vocab - 1, size=(steps, B, 1)).astype(np.int32)
    ref_cache = RT.init_grouped_cache(ref_cfg, B, max_len)
    cache = PT.init_grouped_cache(cfg, B, max_len, device="cpu")
    ref_step = jax.jit(lambda p, c, t: RT.grouped_decode_step(ref_cfg, p,
                                                              c, t))
    for s in range(steps):
        want, ref_cache = ref_step(ref_params, ref_cache,
                                   jnp.asarray(toks[s]))
        got, cache = PT.grouped_decode_step(cfg, params, cache,
                                            torch.from_numpy(toks[s]))
        assert got.dtype == torch.bfloat16
        assert_same(want, got, tol=BF16_TOL, what=f"logits, step {s}")
        assert cache.pos == int(ref_cache.pos) == s + 1
        for name in ("k_local", "v_local", "k_global", "v_global"):
            assert_same(getattr(ref_cache, name), getattr(cache, name),
                        tol=BF16_TOL, what=f"{name}, step {s}")
    assert np.asarray(to_numpy(want)).std() > BF16_TOL


def test_quant_decode_matches_reference():
    ref_cfg = ref_get_arch("qwen2_7b").reduced()
    cfg = get_arch("qwen2_7b").reduced()
    ref_params, params = _converted(ref_cfg, seed=2)
    B, steps, max_len = 2, 6, 8
    toks = np.random.default_rng(2).integers(
        2, cfg.vocab - 1, size=(steps, B, 1)).astype(np.int32)
    ref_cache = RT.init_quant_cache(ref_cfg, B, max_len)
    cache = PT.init_quant_cache(cfg, B, max_len, device="cpu")
    ref_step = jax.jit(lambda p, c, t: RT.decode_step_quant(ref_cfg, p, c,
                                                            t))
    for s in range(steps):
        want, ref_cache = ref_step(ref_params, ref_cache,
                                   jnp.asarray(toks[s]))
        got, cache = PT.decode_step_quant(cfg, params, cache,
                                          torch.from_numpy(toks[s]))
        assert_same(want, got, tol=BF16_TOL, what=f"logits, step {s}")
        assert cache.pos == int(ref_cache.pos) == s + 1
        # the rows attention reads, dequantized: K/V of the two frameworks
        # round apart in bf16, which moves an int8 value by a step or two
        for q, sc in (("k_q", "k_s"), ("v_q", "v_s")):
            assert_same(
                np.asarray(getattr(ref_cache, q), np.float32)
                * np.asarray(getattr(ref_cache, sc))[..., None],
                getattr(cache, q).float() * getattr(cache, sc)[..., None],
                tol=BF16_TOL, what=f"dequantized {q}, step {s}")


def test_quant_decode_past_max_len_clamps_the_write_like_the_reference():
    ref_cfg = dataclasses.replace(ref_get_arch("qwen2_7b").reduced(),
                                  n_layers=2)
    cfg = dataclasses.replace(get_arch("qwen2_7b").reduced(), n_layers=2)
    ref_params, params = _converted(ref_cfg, seed=3)
    B, steps, max_len = 2, 6, 4
    toks = np.random.default_rng(3).integers(
        2, cfg.vocab - 1, size=(steps, B, 1)).astype(np.int32)
    ref_cache = RT.init_quant_cache(ref_cfg, B, max_len)
    cache = PT.init_quant_cache(cfg, B, max_len, device="cpu")
    for s in range(steps):
        want, ref_cache = RT.decode_step_quant(ref_cfg, ref_params,
                                               ref_cache,
                                               jnp.asarray(toks[s]))
        got, cache = PT.decode_step_quant(cfg, params, cache,
                                          torch.from_numpy(toks[s]))
        assert_same(want, got, tol=BF16_TOL, what=f"logits, step {s}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["normal", "zero rows", "large"])
def test_quant_rows_match_reference(dtype, case):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    if case == "zero rows":
        x[0, 1] = 0.0
        x[1, :, 2] = 0.0
    elif case == "large":
        x *= 1e4
    xj = jnp.asarray(x, dtype=getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want_q, want_s = RT._quant_rows(xj)
    got_q, got_s = PT._quant_rows(xt)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    assert_same(want_s, got_s, tol=FP32_TOL, what="scales")
