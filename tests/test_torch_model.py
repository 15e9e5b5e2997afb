"""Model code of the port against the reference: every ``layers.py``
function in float32 (tolerance 2e-5), the decode step with carried-over
bfloat16 weights (2e-2 of the largest logit; the frameworks round bf16 at
different places) for the dense and the MoE families (llama4-maverick's
reduced config carries the shared expert), the write clamp past
``max_len``, and the entry points' contracts."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import get_model as ref_get_model
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch.configs import ARCH_IDS, all_archs, get_arch
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import get_model
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT

from torch_parity import BF16_TOL, FP32_TOL, assert_same, run_both, to_numpy


def _both(ref_fn, port_fn, inputs, tol=FP32_TOL, **kw):
    return run_both(lambda **a: ref_fn(**a, **kw),
                    lambda **a: port_fn(**a, **kw), inputs,
                    to_ref=jnp.asarray, to_port=torch.from_numpy, tol=tol)


def _rng(seed=0):
    return np.random.default_rng(seed)


def f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# layers.py, function by function, float32
# ---------------------------------------------------------------------------


def test_rms_norm_has_the_one_plus_w_gain():
    rng = _rng()
    x, w = f32(rng, 3, 5, 64), f32(rng, 64, scale=0.1)
    _both(RL.rms_norm, PL.rms_norm, {"x": x, "w": w}, eps=1e-6)
    out = PL.rms_norm(torch.from_numpy(x), torch.zeros(64))
    np.testing.assert_allclose(out.pow(2).mean(-1).numpy(), 1.0, atol=1e-3)


def test_swiglu():
    rng = _rng(1)
    _both(RL.swiglu, PL.swiglu,
          {"x": f32(rng, 2, 3, 32), "w_gate": f32(rng, 32, 48, scale=0.2),
           "w_up": f32(rng, 32, 48, scale=0.2),
           "w_down": f32(rng, 48, 32, scale=0.2)})


@pytest.mark.parametrize("head_dim,theta", [(32, 10_000.0), (128, 1e6)])
def test_rope_freqs(head_dim, theta):
    assert_same(RL.rope_freqs(head_dim, theta),
                PL.rope_freqs(head_dim, theta), tol=1e-7)


@pytest.mark.parametrize("pos_shape", ["(S,)", "(B, S)"])
def test_apply_rope_split_halves(pos_shape):
    rng = _rng(2)
    x = f32(rng, 2, 6, 4, 32)
    pos = (np.arange(6) + 100 if pos_shape == "(S,)" else
           rng.integers(0, 2000, size=(2, 6))).astype(np.int32)
    _both(RL.apply_rope, PL.apply_rope, {"x": x, "positions": pos},
          theta=10_000.0)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 3), (False, 0),
                                           (False, 2)])
def test_block_mask(causal, window):
    q, k = np.arange(5) + 4, np.arange(12)
    want = RL._block_mask(jnp.asarray(q), jnp.asarray(k), causal, window)
    got = PL._block_mask(torch.from_numpy(q), torch.from_numpy(k), causal,
                         window)
    assert_same(want, got)


def _qkv(rng, B, Sq, Sk, H, Hkv, Dh):
    return {"q": f32(rng, B, Sq, H, Dh), "k": f32(rng, B, Sk, Hkv, Dh),
            "v": f32(rng, B, Sk, Hkv, Dh)}


@pytest.mark.parametrize("window,kv_len,q_offset", [
    (0, None, 0), (0, 9, 8), (4, 20, 19), (0, 1, 0)])
def test_decode_attention(window, kv_len, q_offset):
    _both(RL.decode_attention, PL.decode_attention,
          _qkv(_rng(3), 2, 1, 24, 4, 2, 16), window=window, kv_len=kv_len,
          q_offset=q_offset)


@pytest.mark.parametrize("name,Sq,Sk,kw", [
    ("one block", 1, 16, dict(q_offset=7, kv_len=8, block_k=1024)),
    ("padded blocks", 5, 20, dict(block_k=8)),
    ("decode dispatch", 2, 40, dict(q_offset=30, kv_len=32, block_k=16)),
    ("window", 6, 24, dict(window=5, q_offset=18, kv_len=24, block_k=8)),
    ("q blocks", 8, 8, dict(block_q=4, block_k=4)),
    ("nothing visible", 1, 8, dict(kv_len=0, block_k=4)),
])
def test_chunked_attention(name, Sq, Sk, kw):
    inputs = _qkv(_rng(4), 2, Sq, Sk, 4, 2, 16)
    _both(RL.chunked_attention, PL.chunked_attention, inputs, **kw)
    if name != "nothing visible":
        _both(RL.naive_attention, PL.naive_attention, inputs,
              **{k: v for k, v in kw.items()
                 if k in ("window", "q_offset", "kv_len")})
        got = PL.chunked_attention(
            **{k: torch.from_numpy(v) for k, v in inputs.items()}, **kw)
        want = PL.naive_attention(
            **{k: torch.from_numpy(v) for k, v in inputs.items()},
            **{k: v for k, v in kw.items()
               if k in ("window", "q_offset", "kv_len")})
        assert_same(want, got, tol=FP32_TOL)


def test_dense_init_is_seeded_scaled_and_typed():
    g = torch.Generator(device="cpu").manual_seed(5)
    a = PL.dense_init(g, (256, 64))
    b = PL.dense_init(torch.Generator(device="cpu").manual_seed(5), (256, 64))
    assert a.dtype == torch.float32 and torch.equal(a, b)
    assert abs(float(a.std()) - 1 / 16) < 0.01         # 1 / sqrt(fan_in)
    c = PL.dense_init(g, (64, 8), scale=0.02, dtype=torch.bfloat16)
    assert c.dtype == torch.bfloat16 and float(c.float().std()) < 0.03


# ---------------------------------------------------------------------------
# configs, parameters, conversion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_reference(arch):
    ref, port = ref_get_arch(arch), get_arch(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert get_arch(port.name).name == port.name or port.name not in ARCH_IDS
    np.testing.assert_array_equal(PT.layer_windows(port),
                                  RT.layer_windows(ref))


def test_all_archs_lists_ten():
    assert sorted(all_archs()) == sorted(ARCH_IDS) and len(ARCH_IDS) == 10


@pytest.mark.parametrize("arch", ["qwen2_7b", "gemma3_12b", "chameleon_34b"])
def test_init_params_tree_matches_reference(arch):
    cfg = get_arch(arch).reduced()
    ref = RT.init_dense_params(ref_get_arch(arch).reduced(),
                               jax.random.PRNGKey(0))
    g = torch.Generator(device="cpu").manual_seed(0)
    port = get_model(cfg).init(g, device="cpu")

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict)
                else (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in tree.items()}

    assert shapes(port) == shapes(ref)
    assert float(port["layers"]["ln1"].abs().max()) == 0.0
    assert 0.015 < float(port["embed"].float().std()) < 0.025


def test_params_from_numpy_is_exact_for_bfloat16():
    ref = RT.init_dense_params(ref_get_arch("qwen2_7b").reduced(),
                               jax.random.PRNGKey(1))
    tree = jax.tree_util.tree_map(np.asarray, ref)
    port = params_from_numpy(tree, device="cpu")
    assert port["layers"]["wq"].dtype == torch.bfloat16
    assert_same(ref, port)                     # bit for bit, through float32
    as32 = params_from_numpy(tree, device="cpu", dtype=torch.float32)
    assert as32["embed"].dtype == torch.float32
    assert_same(ref, as32)
    ints = tensor_from_numpy(np.arange(4, dtype=np.int32), device="cpu")
    assert ints.dtype == torch.int32


@pytest.mark.parametrize("arch", ["whisper_base"])
def test_families_not_ported_yet_say_so(arch):
    """No family is left unported: whisper, the last one, builds a reduced
    prefill over frames and tokens and decodes on from its cache."""
    cfg = get_arch(arch).reduced()
    model = get_model(cfg)
    assert model.cfg.family == "encdec" and model.init_cache is None
    params = model.init(torch.Generator(device="cpu").manual_seed(0),
                        device="cpu")
    frames = torch.randn((2, 12, cfg.d_model),
                         generator=torch.Generator().manual_seed(1))
    logits, cache = model.prefill(
        params, {"frames": frames,
                 "tokens": torch.full((2, 5), 3, dtype=torch.int32)}, 8)
    assert tuple(logits.shape) == (2, cfg.vocab) and cache.pos == 5
    assert tuple(cache.k_cross.shape) == (cfg.n_layers, 2, 12,
                                          cfg.n_kv_heads, cfg.hd)
    logits, cache = model.decode(params, cache,
                                 torch.full((2, 1), 3, dtype=torch.int32))
    assert tuple(logits.shape) == (2, cfg.vocab) and cache.pos == 6
    assert bool(torch.isfinite(logits.float()).all())


@pytest.mark.parametrize("arch", ["mamba2_370m", "zamba2_2_7b"])
def test_ssm_families_build_a_reduced_prefill_and_decode(arch):
    cfg = get_arch(arch).reduced()
    model = get_model(cfg)
    assert model.cfg.family in ("ssm", "hybrid") and model.loss is None
    params = model.init(torch.Generator(device="cpu").manual_seed(0),
                        device="cpu")
    logits, cache = model.prefill(
        params, {"tokens": torch.full((2, 5), 3, dtype=torch.int32)}, 8)
    assert tuple(logits.shape) == (2, cfg.vocab) and cache.pos == 5
    logits, cache = model.decode(params, cache,
                                 torch.full((2, 1), 3, dtype=torch.int32))
    assert tuple(logits.shape) == (2, cfg.vocab) and cache.pos == 6
    assert bool(torch.isfinite(logits.float()).all())
    fresh = model.init_cache(2, 8, device="cpu")
    assert fresh.pos == 0 and fresh.state.dtype == torch.float32


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "llama4_maverick"])
def test_moe_families_build_a_reduced_decode(arch):
    cfg = get_arch(arch).reduced()
    model = get_model(cfg)
    assert model.cfg.family == "moe" and model.loss is None
    params = model.init(torch.Generator(device="cpu").manual_seed(0),
                        device="cpu")
    cache = model.init_cache(2, 8, device="cpu")
    logits, cache = model.decode(params, cache,
                                 torch.full((2, 1), 3, dtype=torch.int32))
    assert tuple(logits.shape) == (2, cfg.vocab) and cache.pos == 1
    assert bool(torch.isfinite(logits.float()).all())


# ---------------------------------------------------------------------------
# decode_step with carried-over bfloat16 weights
# ---------------------------------------------------------------------------


def _carried_over(arch, seed=0, **replace):
    ref_cfg = dataclasses.replace(ref_get_arch(arch).reduced(), **replace)
    cfg = dataclasses.replace(get_arch(arch).reduced(), **replace)
    ref_model = ref_get_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(seed))
    params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    return ref_model, ref_params, get_model(cfg), params


def _decode_both(arch, steps, batch, max_len, seed=0):
    ref_model, ref_params, model, params = _carried_over(arch, seed)
    rng = _rng(seed)
    toks = rng.integers(2, model.cfg.vocab - 1,
                        size=(steps, batch, 1)).astype(np.int32)
    ref_cache = ref_model.init_cache(batch, max_len)
    cache = model.init_cache(batch, max_len, device="cpu")
    ref_decode = jax.jit(ref_model.decode)
    for s in range(steps):
        want, ref_cache = ref_decode(ref_params, ref_cache,
                                     jnp.asarray(toks[s]))
        got, cache = model.decode(params, cache, torch.from_numpy(toks[s]))
        assert got.dtype == torch.bfloat16
        assert tuple(got.shape) == (batch, model.cfg.vocab)
        assert_same(want, got, tol=BF16_TOL, what=f"logits, step {s}")
        assert cache.pos == int(ref_cache.pos) == s + 1
        assert_same(ref_cache.k, cache.k, tol=BF16_TOL, what=f"k, step {s}")
        assert_same(ref_cache.v, cache.v, tol=BF16_TOL, what=f"v, step {s}")
    return to_numpy(want), to_numpy(got)


@pytest.mark.parametrize("arch", ["qwen2_7b", "gemma3_12b", "olmoe_1b_7b",
                                  "llama4_maverick"])
def test_three_decode_steps_match_reference(arch):
    want, got = _decode_both(arch, steps=3, batch=2, max_len=8)
    # the logits are not flat: the tolerance is below their spread
    assert want.std() > BF16_TOL * max(1.0, np.abs(want).max())
    assert got.std() > BF16_TOL * max(1.0, np.abs(want).max())


def test_decode_past_max_len_clamps_the_write_like_the_reference():
    """Past ``max_len`` the reference's dynamic_update_slice clamps the
    start index: the last cache row is overwritten while RoPE and the mask
    go on with the unclamped position."""
    _decode_both("qwen2_7b", steps=6, batch=2, max_len=4, seed=3)


@pytest.mark.parametrize("ffn", [None, "override"])
def test_dense_layer_without_a_cache_matches_reference(ffn):
    """The self-attention form of the layer (no cache), float32 weights.
    It attends from position 0 (the flash attention kernel has no query
    offset), as every caller of the JAX package's form does; another
    ``pos`` is refused."""
    cfg, ref_cfg = get_arch("qwen2_7b").reduced(), \
        ref_get_arch("qwen2_7b").reduced()
    ref_params = RT.init_dense_params(ref_cfg, jax.random.PRNGKey(2),
                                      dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, ref_params)
    lp_ref = {k: v[1] for k, v in ref_params["layers"].items()}
    lp = {k: v[1] for k, v in
          params_from_numpy(tree, device="cpu")["layers"].items()}
    x = f32(_rng(6), 2, 5, cfg.d_model)
    kw = {} if ffn is None else {"ffn": lambda lp_, h: h * 0.5}
    want, (wk, wv) = jax.jit(lambda lp_, x_: RT.dense_layer(
        ref_cfg, lp_, x_, 3, pos=0, **kw))(lp_ref, jnp.asarray(x))
    got, (gk, gv) = PT.dense_layer(cfg, lp, torch.from_numpy(x), 3, pos=0,
                                   **kw)
    assert_same(want, got, tol=FP32_TOL)
    assert_same((wk, wv), (gk, gv), tol=FP32_TOL)
    with pytest.raises(ValueError, match="position 0"):
        PT.dense_layer(cfg, lp, torch.from_numpy(x), 3, pos=2, **kw)


def test_decode_updates_the_cache_in_place():
    _, _, model, params = _carried_over("qwen2_7b")
    cache = model.init_cache(2, 8, device="cpu")
    toks = torch.full((2, 1), 5, dtype=torch.int32)
    _, new = model.decode(params, cache, toks)
    assert new.k is cache.k and new.v is cache.v and new.pos == 1
    assert float(cache.k[:, :, 0].abs().max()) > 0      # row 0 was written
    assert float(cache.k[:, :, 1:].abs().max()) == 0


def test_serve_step_returns_argmax_tokens():
    _, _, model, params = _carried_over("qwen2_7b")
    step = make_serve_step(model)
    cache = model.init_cache(2, 8, device="cpu")
    nxt, logits, cache = step(params, cache,
                              torch.full((2, 1), 7, dtype=torch.int32))
    assert nxt.dtype == torch.int32 and tuple(nxt.shape) == (2, 1)
    assert torch.equal(nxt[:, 0].long(), logits.float().argmax(-1))
