"""Attention over a whole prompt in the port against the JAX package's, on the
CPU: the flash attention kernel's plain version against the JAX oracle
``ref.mha_reference`` over ``test_flash_attention_sweep``'s grid and more
(head sizes 80 and 240, ``kv_len < Sk``, ``Sq != Sk``) and against the JAX
kernel in interpret mode (float32 within 2e-5, bfloat16 within 2e-2 of the
largest magnitude: the bounds of ``tests/test_kernels.py``), the argument
checks, the route (a layer without a cache goes through ``ops.mha``, one
with a cache does not), the prefill and three decode steps of the reduced
qwen2-7b, gemma3-12b (also with a global layer), olmoe-1b-7b and
whisper-base with carried-over bfloat16 weights (2e-2 of the largest
magnitude; the frameworks round bf16 at different places), and ``forward``
against ``prefill`` + one decode step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.kernels import flash_attention as RF
from repro.kernels import ref as RR
from repro.models import get_model as ref_get_model
from repro.models import moe as RM
from repro.models import transformer as RT
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as PO
from repro_torch.kernels import ref as PR
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import get_model
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT

from torch_parity import BF16_TOL, FP32_TOL, assert_same, to_numpy

TOL = {"float32": FP32_TOL, "bfloat16": BF16_TOL}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rng(seed=0):
    return np.random.default_rng(seed)


def _qkv(seed, B, Sq, Sk, H, Hkv, D, dtype):
    """q (B, Sq, H, D), k and v (B, Sk, Hkv, D) as numpy float32, already
    rounded to ``dtype`` so that both packages start from the same
    numbers."""
    rng = _rng(seed)
    out = []
    for shape in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)):
        x = jnp.asarray(rng.normal(size=shape).astype(np.float32),
                        DTYPES[dtype][0])
        out.append(np.asarray(x.astype(jnp.float32)))
    return out


def _to(dtype, framework, *arrays):
    if framework == "jax":
        return [jnp.asarray(a, DTYPES[dtype][0]) for a in arrays]
    return [torch.from_numpy(np.array(a)).to(DTYPES[dtype][1])
            for a in arrays]


def _fold(x, rep):
    """(B, S, Hk, D) -> (B * Hk * rep, S, D), each head repeated ``rep``
    times: the JAX wrapper's GQA fold."""
    B, S, Hk, D = x.shape
    return np.repeat(x.transpose(0, 2, 1, 3), rep, axis=1).reshape(
        B * Hk * rep, S, D)


# test_flash_attention_sweep's grid (tests/test_kernels.py:19-27), then head
# sizes 80 and 240, kv_len < Sk and Sq != Sk
SHAPES = [
    (1, 128, 128, 2, 2, 64, None),
    (2, 256, 256, 4, 2, 64, None),
    (1, 128, 384, 4, 1, 128, None),     # GQA rep 4, rectangular
    (2, 64, 64, 2, 2, 32, None),
    (1, 100, 100, 4, 2, 80, None),      # zamba2's head size, ragged tiles
    (1, 70, 70, 2, 1, 240, None),       # gemma3's head size
    (2, 96, 96, 4, 2, 64, 80),          # kv_len < Sk
    (1, 40, 150, 6, 3, 64, 120),        # Sq != Sk and kv_len < Sk
]
MASKS = [(True, 0), (True, 32), (False, 0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,kv_len", SHAPES)
def test_plain_version_and_mha_match_reference(B, Sq, Sk, H, Hkv, D, kv_len,
                                               causal, window, dtype):
    q, k, v = _qkv(Sq * D + Sk, B, Sq, Sk, H, Hkv, D, dtype)
    rep = H // Hkv
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    folded = [_fold(q, 1), _fold(k, rep), _fold(v, rep)]
    want = RR.mha_reference(*_to(dtype, "jax", *folded), **kw)
    got = fa.flash_attention_plain(*_to(dtype, "torch", *folded), **kw)
    assert got.dtype == DTYPES[dtype][1]
    assert_same(want, got, tol=TOL[dtype], what="flash_attention_plain")
    # ops.mha over (B, S, H, D), grouped by index, against the same oracle
    want4 = np.asarray(jnp.asarray(want, jnp.float32)).reshape(
        B, H, Sq, D).transpose(0, 2, 1, 3)
    got4 = PO.mha(*_to(dtype, "torch", q, k, v), **kw)
    assert tuple(got4.shape) == (B, Sq, H, D)
    assert_same(want4, got4, tol=TOL[dtype], what="ops.mha")
    # ref.mha_reference and the wrappers are that function on the CPU
    t = _to(dtype, "torch", *folded)
    assert torch.equal(PR.mha_reference(*t, **kw), got)
    assert torch.equal(fa.flash_attention(*t, **kw), got)


@pytest.mark.parametrize("case", [
    ("float32", 4, 128, 128, 64, True, 0, None),
    ("float32", 2, 128, 128, 80, True, 32, None),
    ("bfloat16", 2, 64, 192, 32, False, 0, 150),
])
def test_plain_version_matches_the_interpret_mode_kernel(case):
    """The Pallas kernel itself, in interpret mode as the JAX package's own
    tests run it, with 64-row blocks.  Its lengths are multiples of the
    block: the Pallas kernel reads past the end of a ragged last block (NaN
    in interpret mode), so the ragged lengths are held to the oracle
    above."""
    dtype, BH, Sq, Sk, D, causal, window, kv_len = case
    q, k, v = (x[:, :, 0] for x in _qkv(D, BH, Sq, Sk, 1, 1, D, dtype))
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    want = RF.flash_attention(*_to(dtype, "jax", q, k, v), **kw,
                              block_q=64, block_k=64, interpret=True)
    got = fa.flash_attention(*_to(dtype, "torch", q, k, v), **kw)
    assert_same(want, got, tol=TOL[dtype])


BLIND = [dict(kv_len=0), dict(causal=False, window=2, kv_len=4),
         dict(causal=True, window=3, kv_len=2)]


def _blind_rows_match_reference(dtype, B, Sq, Sk, H, Hkv, D, kw):
    """``ops.mha``, ``attention`` and ``flash_attention`` (CPU tensors: the
    plain version) against ``ref.mha_reference`` where some rows see no key:
    the oracle masks all their scores to -1e30, so they are the mean of v
    over all Sk rows; returns the first such row."""
    q, k, v = _qkv(Sq + 7 * D, B, Sq, Sk, H, Hkv, D, dtype)
    rep = H // Hkv
    folded = [_fold(q, 1), _fold(k, rep), _fold(v, rep)]
    want = RR.mha_reference(*_to(dtype, "jax", *folded), **kw)
    want4 = np.asarray(jnp.asarray(want, jnp.float32)).reshape(
        B, H, Sq, D).transpose(0, 2, 1, 3)
    t = _to(dtype, "torch", q, k, v)
    assert_same(want4, PO.mha(*t, **kw), tol=TOL[dtype], what="ops.mha")
    assert_same(want4, fa.attention(*t, **kw), tol=TOL[dtype],
                what="attention")
    assert_same(want, fa.flash_attention(*_to(dtype, "torch", *folded), **kw),
                tol=TOL[dtype], what="flash_attention")
    seen = Sk if kw.get("kv_len") is None else min(kw["kv_len"], Sk)
    row0 = fa.first_blind_row(Sq, seen, kw.get("window", 0))
    mean = v.mean(axis=1)                      # (B, Hkv, D), float32
    np.testing.assert_allclose(
        want4[:, row0:], np.broadcast_to(
            np.repeat(mean, rep, axis=1)[:, None], want4[:, row0:].shape),
        atol=TOL[dtype] * max(1.0, float(np.abs(mean).max())))
    return row0


def test_rows_without_a_key_are_refused():
    """The argument sets that were once refused (``kv_len`` 0, and windows
    that leave the last rows without a key) now give the oracle's rows in
    both dtypes, the blind rows the mean of v over all keys; the edge where
    every row still sees a key has no blind row."""
    for dtype in ("float32", "bfloat16"):
        for kw, row0 in zip(BLIND, (0, 5, 4)):
            assert _blind_rows_match_reference(
                dtype, 1, 8, 8, 2, 2, 16, kw) == row0
    assert fa.first_blind_row(8, 6, 3) == 8
    q, k, v = _qkv(3, 1, 8, 8, 2, 2, 16, "float32")
    PO.mha(*_to("float32", "torch", q, k, v), causal=True, window=3,
           kv_len=6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", BLIND + [dict(causal=True, window=8,
                                             kv_len=-3)],
                         ids=["kv_len0", "window-full", "window-causal",
                              "kv_len-negative"])
def test_blind_rows_of_grouped_heads_match_reference(kw, dtype):
    """The same over 4 query heads on 2 kv heads, Sq != Sk, D 32."""
    _blind_rows_match_reference(dtype, 2, 12, 10, 4, 2, 32, kw)


def test_arguments_are_checked():
    q, k, v = _to("float32", "torch", *_qkv(4, 2, 8, 8, 4, 2, 16, "float32"))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        PO.mha(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="q is torch.float32"):
        PO.mha(q, k.bfloat16(), v)
    with pytest.raises(TypeError, match="torch.Tensor"):
        PO.mha(q, k.numpy(), v)
    with pytest.raises(ValueError, match="k and v"):
        PO.mha(q, k, v[:, :7])
    with pytest.raises(ValueError, match="group"):
        PO.mha(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="window"):
        PO.mha(q, k, v, window=-1)
    with pytest.raises(ValueError, match=r"\(BH, S, D\)"):
        fa.flash_attention(q, k, v)
    before = fa.LAUNCHES["flash_attention"]
    PO.mha(q, k, v)                              # the plain version
    assert fa.LAUNCHES["flash_attention"] == before


def _offset_view(x):
    """``x`` as a view one element past an aligned base: TMA cannot read
    it as it lies."""
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype)
    flat[1:] = x.reshape(-1)
    return flat[1:].view(x.shape)


@pytest.mark.parametrize("case", ["D=72", "offset view"])
def test_the_aligned_copy_keeps_the_function(case):
    """The bf16 kernel's aligned copy (``tma_operands``), pure torch on the
    CPU: padded, through the plain version with the scale of the original
    D and sliced back, it equals the plain version of the unpadded inputs
    and the JAX package's ``mha_reference``, within the float32 bound."""
    D = 72 if case == "D=72" else 64
    B, Sq, Sk, H, Hkv = 2, 40, 56, 4, 2
    q, k, v = _qkv(D, B, Sq, Sk, H, Hkv, D, "float32")
    t = _to("float32", "torch", q, k, v)
    if case == "offset view":
        t[0] = _offset_view(t[0])
        assert t[0].data_ptr() % 16 and not fa._tma_ready(t[0])
    qp, kp, vp, copied = fa.tma_operands(*t)
    assert copied
    Dp = -(-D // 16) * 16
    for got, x in zip((qp, kp, vp), t):
        assert got.shape[-1] == Dp and fa._tma_ready(got)
        assert torch.equal(got[..., :D], x)
        assert not bool(got[..., D:].any())
    kw = dict(causal=True, window=16, kv_len=50)
    got = fa.mha_plain(qp, kp, vp, scale=1.0 / np.sqrt(D), **kw)[..., :D]
    assert torch.allclose(got, fa.mha_plain(*t, **kw), atol=FP32_TOL, rtol=0)
    rep = H // Hkv
    want = RR.mha_reference(*_to("float32", "jax", _fold(q, 1), _fold(k, rep),
                                 _fold(v, rep)), **kw)
    want4 = np.asarray(want).reshape(B, H, Sq, D).transpose(0, 2, 1, 3)
    assert_same(want4, got, tol=FP32_TOL, what="padded plain version")
    if case == "D=72":
        # the scale of the padded D would be another function
        other = fa.mha_plain(qp, kp, vp, **kw)[..., :D]
        assert float((other - got).abs().max()) > 1e-3


@pytest.mark.parametrize("D", [64, 80, 128, 240])
def test_the_models_inputs_need_no_copy(D):
    """The models hand over contiguous (B, S, H, D) tensors at head sizes
    64, 80, 128 and 240, and views of them: TMA reads them as they lie."""
    q, k, v = _to("bfloat16", "torch",
                  *_qkv(D, 2, 24, 24, 4, 2, D, "bfloat16"))
    got = fa.tma_operands(q, k, v)
    assert got[3] is False and all(a is b for a, b in zip(got, (q, k, v)))
    assert fa.tma_operands(q[:, :8], k[:, 8:], v[:, :, :1])[3] is False
    odd = _offset_view(q)
    qp, kp, vp, copied = fa.tma_operands(odd, k, v)
    assert copied and kp is k and vp is v and torch.equal(qp, odd)


# ---------------------------------------------------------------------------
# the route: which layers reach the kernel's wrapper
# ---------------------------------------------------------------------------


def test_a_layer_without_a_cache_goes_through_ops_mha(monkeypatch):
    cfg = get_arch("gemma3_12b").reduced()
    model = get_model(cfg)
    params = model.init(torch.Generator(device="cpu").manual_seed(0),
                        device="cpu")
    calls = []
    real = PO.mha

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(PO, "mha", spy)
    toks = torch.full((2, 20), 3, dtype=torch.int32)
    _, cache = model.prefill(params, {"tokens": toks}, 24)
    assert calls == [((2, 20, 4, 32), (2, 20, 2, 32),
                      dict(causal=True, window=16))] * cfg.n_layers
    calls.clear()
    model.decode(params, cache, toks[:, :1])     # a layer with a cache
    assert calls == []


# ---------------------------------------------------------------------------
# reduced models with carried-over bfloat16 weights
# ---------------------------------------------------------------------------

# An MoE comparison holds only where no token sits on a near-tie of its
# routing: bf16 rounding that differs between the frameworks flips such a
# token to another expert (ROADMAP F9).  Each MoE test first checks that the
# reference's gap between its top_k-th and next router probability is at
# least this, in every layer, for every token of its data.
ROUTE_MARGIN = 1e-3


def _routing_margin(ref_cfg, ref_params, toks):
    """The smallest gap between the ``top_k``-th and the next router
    probability over every token and layer of the reference's forward
    pass over ``toks``."""
    gaps = []

    def ffn(lp, h):
        p = jax.nn.softmax(h.reshape(-1, h.shape[-1]).astype(jnp.float32)
                           @ lp["router"], axis=-1)
        top = jnp.sort(p, axis=-1)[:, ::-1]
        gaps.append(float((top[:, ref_cfg.top_k - 1]
                           - top[:, ref_cfg.top_k]).min()))
        return RM.moe_ffn_sorted(ref_cfg, lp, h)[0]

    x = ref_params["embed"].astype(jnp.bfloat16)[jnp.asarray(toks)]
    windows = RT.layer_windows(ref_cfg)
    for i in range(ref_cfg.n_layers):
        lp = {k: v[i] for k, v in ref_params["layers"].items()}
        x, _ = RT.dense_layer(ref_cfg, lp, x, int(windows[i]), ffn=ffn)
    return min(gaps)


def _no_near_ties(ref_model, ref_params, toks):
    if ref_model.cfg.family == "moe":
        gap = _routing_margin(ref_model.cfg, ref_params, toks)
        assert gap >= ROUTE_MARGIN, f"a routing near-tie ({gap})"


def _carried_over(arch, seed=0, **replace):
    ref_cfg = dataclasses.replace(ref_get_arch(arch).reduced(), **replace)
    cfg = dataclasses.replace(get_arch(arch).reduced(), **replace)
    ref_model = ref_get_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(seed))
    params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    return ref_model, ref_params, get_model(cfg), params


def _caches_match(ref_cache, cache, what):
    assert int(ref_cache.pos) == cache.pos, what
    assert ref_cache._fields == cache._fields
    for name in ref_cache._fields[:-1]:
        got = getattr(cache, name)
        assert got.dtype == torch.bfloat16, (what, name)
        assert_same(getattr(ref_cache, name), got, tol=BF16_TOL,
                    what=f"{what}: {name}")


def _prefill_then_decode(ref_model, ref_params, model, params, batch, toks,
                         max_len, steps=3):
    """Prefill ``batch`` in both packages, then decode ``toks`` one column
    at a time; logits and caches held to each other after every call."""
    want, ref_cache = jax.jit(lambda p, b: ref_model.prefill(
        p, b, max_len))(ref_params, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    got, cache = make_prefill_step(model, max_len)(params, batch)
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == (toks.shape[0], model.cfg.vocab)
    assert_same(want, got, tol=BF16_TOL, what="prefill logits")
    _caches_match(ref_cache, cache, "prefill")
    # the logits are not flat: the tolerance is below their spread
    assert to_numpy(want).std() > BF16_TOL * np.abs(to_numpy(want)).max()
    ref_decode = jax.jit(ref_model.decode)
    for s in range(steps):
        step = toks[:, s:s + 1]
        want, ref_cache = ref_decode(ref_params, ref_cache, jnp.asarray(step))
        got, cache = model.decode(params, cache, torch.from_numpy(step))
        assert_same(want, got, tol=BF16_TOL, what=f"logits, step {s}")
        _caches_match(ref_cache, cache, f"step {s}")


@pytest.mark.parametrize("arch,replace", [
    ("qwen2_7b", {}),
    ("gemma3_12b", {}),                   # two local layers, window 16
    ("gemma3_12b", {"n_layers": 6}),      # five local and one global
    ("olmoe_1b_7b", {}),
], ids=["qwen2_7b", "gemma3_12b", "gemma3_12b-6-layers", "olmoe_1b_7b"])
def test_prefill_and_three_decode_steps_match_reference(arch, replace):
    ref_model, ref_params, model, params = _carried_over(arch, **replace)
    if replace:
        windows = PT.layer_windows(model.cfg)
        assert (windows == 0).sum() == 1 and (windows == 16).sum() == 5
    B, S, max_len = 2, 24, 32                    # S > the window of 16
    toks = _rng(0).integers(2, model.cfg.vocab - 1,
                            size=(B, S + 3)).astype(np.int32)
    _no_near_ties(ref_model, ref_params, toks)
    _prefill_then_decode(ref_model, ref_params, model, params,
                         {"tokens": toks[:, :S]}, toks[:, S:], max_len)


def test_whisper_prefill_and_three_decode_steps_match_reference():
    ref_model, ref_params, model, params = _carried_over("whisper_base")
    cfg = model.cfg
    B, S_enc, S, max_len = 2, 40, 8, 16
    rng = _rng(6)
    frames = rng.normal(size=(B, S_enc, cfg.d_model)).astype(np.float32)
    toks = rng.integers(2, cfg.vocab - 1, size=(B, S + 3)).astype(np.int32)
    _prefill_then_decode(ref_model, ref_params, model, params,
                         {"frames": frames, "tokens": toks[:, :S]},
                         toks[:, S:], max_len)


def test_params_from_numpy_keeps_the_whisper_tree():
    ref = ref_get_model(ref_get_arch("whisper_base").reduced()).init(
        jax.random.PRNGKey(1))
    port = params_from_numpy(jax.tree_util.tree_map(np.asarray, ref),
                             device="cpu")
    assert_same(ref, port)                       # bit for bit, nested
    mine = get_model(get_arch("whisper_base").reduced()).init(
        torch.Generator(device="cpu").manual_seed(0), device="cpu")

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict)
                else (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in tree.items()}

    assert shapes(mine) == shapes(port)


@pytest.mark.parametrize("arch", ["qwen2_7b", "gemma3_12b"])
def test_forward_matches_reference(arch):
    ref_model, ref_params, model, params = _carried_over(arch)
    toks = _rng(7).integers(2, 500, size=(2, 20)).astype(np.int32)
    want = jax.jit(lambda p, t: RT.forward(ref_model.cfg, p, t))(
        ref_params, jnp.asarray(toks))
    got = PT.forward(model.cfg, params, torch.from_numpy(toks))
    assert_same(want, got, tol=BF16_TOL)


def test_moe_forward_matches_reference():
    ref_model, ref_params, model, params = _carried_over("olmoe_1b_7b")
    toks = _rng(1).integers(2, 500, size=(2, 20)).astype(np.int32)
    _no_near_ties(ref_model, ref_params, toks)
    want_h, want_aux = jax.jit(lambda p, t: RM.forward(ref_model.cfg, p, t))(
        ref_params, jnp.asarray(toks))
    got_h, got_aux = PM.forward(model.cfg, params, torch.from_numpy(toks))
    assert_same(want_h, got_h, tol=BF16_TOL)
    assert_same(want_aux, got_aux, tol=1e-5)


@pytest.mark.parametrize("arch", ["qwen2_7b", "gemma3_12b", "olmoe_1b_7b"])
def test_forward_equals_prefill_then_one_decode_step(arch):
    """``forward`` over S + 1 tokens against ``prefill(S)`` and one decode
    step, at the last position, in the port (bf16 2e-2): the kernel's
    attention over the prompt and the eager attention against the cache
    are the same sums.  S = 20 > gemma3's reduced window of 16."""
    ref_model, ref_params, model, params = _carried_over(arch)
    cfg = model.cfg
    toks = _rng(1).integers(2, 500, size=(1, 21)).astype(np.int32)
    _no_near_ties(ref_model, ref_params, toks)
    toks = torch.from_numpy(toks)
    _, cache = model.prefill(params, {"tokens": toks[:, :20]}, 32)
    stepped, _ = model.decode(params, cache, toks[:, 20:])
    fwd = PM.forward if cfg.family == "moe" else PT.forward
    h = fwd(cfg, params, toks)
    h = h[0] if isinstance(h, tuple) else h
    whole = PT.logits_fn(cfg, params, h)[:, -1]
    assert_same(whole, stepped, tol=BF16_TOL)
