"""The SSM and hybrid families of the port against the JAX package's, on the
CPU: the SSD chunk's plain version against the JAX oracle and the JAX
kernel in interpret mode (float32, atol 1e-4, the bound of
``tests/test_kernels.py``), the chunked scan (float32, atol 2e-4), the
causal conv and the Mamba2 block with carried-over float32 weights (2e-4),
prefill and three decode steps of the reduced mamba2 and zamba2 with
carried-over bfloat16 weights (2e-2 of the largest magnitude; the
frameworks round bf16 at different places), and the entry points."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.kernels import ops as RO
from repro.kernels import ref as RR
from repro.models import get_model as ref_get_model
from repro.models import hybrid as RH
from repro.models import ssm as RS
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops as PO
from repro_torch.kernels import ref as PR
from repro_torch.kernels import ssd_chunk as sc
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import get_model
from repro_torch.models import hybrid as PH
from repro_torch.models import ssm as PS

from torch_parity import BF16_TOL, assert_same, chunk_views, to_numpy

CHUNK_TOL = 1e-4      # one chunk, float32: tests/test_kernels.py's bound
SCAN_TOL = 2e-4       # the scan over chunks and the block around it


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(ref, port, atol, what=""):
    """Absolute tolerance, as tests/test_kernels.py states it; tuples are
    compared element by element."""
    ref, port = to_numpy(ref), to_numpy(port)
    if isinstance(ref, tuple):
        assert len(ref) == len(port), what
        for i, (r, p) in enumerate(zip(ref, port)):
            _close(r, p, atol, f"{what}[{i}]")
        return
    assert ref.shape == port.shape, (what, ref.shape, port.shape)
    np.testing.assert_allclose(port, ref, rtol=0, atol=atol, err_msg=what)


def _torch(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _jnp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def chunk_inputs(rng, B, H, Q, P, N, dt_range=(0.01, 0.3)):
    """One chunk's inputs as ``tests/test_kernels.py`` draws them."""
    f32 = np.float32
    dt = rng.uniform(*dt_range, size=(B, H, Q)).astype(f32)
    A = -rng.uniform(0.5, 2.0, size=(H,)).astype(f32)
    return {"x": rng.normal(size=(B, H, Q, P)).astype(f32), "dt": dt,
            "bm": rng.normal(size=(B, Q, N)).astype(f32),
            "cm": rng.normal(size=(B, Q, N)).astype(f32),
            "cum": np.cumsum(dt * A[None, :, None], axis=-1).astype(f32),
            "s_prev": rng.normal(size=(B, H, P, N)).astype(f32)}


# ---------------------------------------------------------------------------
# one chunk: the kernel's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,H,Q,P,N", [
    (1, 2, 32, 16, 8),
    (2, 4, 64, 32, 16),
    (1, 8, 128, 64, 32),
])
def test_ssd_chunk_plain_matches_reference_and_interpret_kernel(B, H, Q, P,
                                                                N):
    inputs = chunk_inputs(_rng(B * Q + N), B, H, Q, P, N)
    got = sc.ssd_chunk_plain(**_torch(inputs))
    _close(RR.ssd_chunk_reference(**_jnp(inputs)), got, CHUNK_TOL, "oracle")
    _close(RO.ssd(**_jnp(inputs), interpret=True), got, CHUNK_TOL,
           "interpret-mode kernel")
    # the wrapper, ops.ssd and ref.ssd_chunk_reference are that function
    for other in (sc.ssd_chunk, PO.ssd, PR.ssd_chunk_reference):
        assert_same(got, other(**_torch(inputs)))


@pytest.mark.parametrize("case", ["dt near 0", "dt large", "Q = 1"])
def test_ssd_chunk_plain_masks_before_exp(case):
    """A decay of 1000 nats over the chunk: exp of the masked entries
    (cum_i - cum_j > 0 above the diagonal) would be inf, and inf * 0 is
    NaN; dt near 0 leaves the state untouched."""
    dt_range, Q = {"dt near 0": ((0.0, 1e-6), 16), "dt large": ((4.0, 8.0), 16),
                   "Q = 1": ((0.01, 0.3), 1)}[case]
    inputs = chunk_inputs(_rng(7), 2, 3, Q, 16, 8, dt_range=dt_range)
    y, s = sc.ssd_chunk_plain(**_torch(inputs))
    assert bool(torch.isfinite(y).all() and torch.isfinite(s).all())
    yw, sw = RR.ssd_chunk_reference(**_jnp(inputs))
    _close(yw, y, CHUNK_TOL)
    _close(sw, s, CHUNK_TOL)
    if case == "dt near 0":
        _close(inputs["s_prev"], s, 1e-4)


def test_ssd_chunk_checks_its_arguments():
    inputs = _torch(chunk_inputs(_rng(1), 1, 2, 8, 4, 4))
    with pytest.raises(TypeError, match="float32"):
        sc.ssd_chunk(**{**inputs, "x": inputs["x"].double()})
    with pytest.raises(ValueError, match="s_prev"):
        sc.ssd_chunk(**{**inputs, "s_prev": inputs["s_prev"][:, :, :3]})
    with pytest.raises(ValueError, match="bm"):
        sc.ssd_chunk(**{**inputs, "bm": inputs["bm"][:, :7]})
    with pytest.raises(TypeError, match="torch.Tensor"):
        sc.ssd_chunk(**{**inputs, "cum": inputs["cum"].numpy()})
    before = sc.LAUNCHES["ssd_chunk"]
    sc.ssd_chunk(**inputs)                     # the plain version: no launch
    assert sc.LAUNCHES["ssd_chunk"] == before


def _views(inputs, layout):
    """The chunk's numpy inputs as torch tensors laid out as ``layout``
    says (``torch_parity.chunk_views``), in the kernel's argument order."""
    v = chunk_views(_torch(inputs), layout)
    return [v[k] for k in ("x", "dt", "bm", "cm", "cum", "s_prev")]


@pytest.mark.parametrize("layout", ["chunk loop", "longer sequence",
                                    "offset view"])
def test_ssd_chunk_reads_strided_views(layout):
    """The views the chunk loop passes (and an offset view, which the
    kernel's operand rule copies) give the same chunk as contiguous copies,
    the JAX oracle and the interpret-mode Pallas kernel (CHUNK_TOL); the
    rule copies only the view whose rows are off 16 bytes."""
    inputs = chunk_inputs(_rng(11), 2, 3, 32, 16, 8)
    views = _views(inputs, layout)
    assert any(not v.is_contiguous() for v in views) or layout == "offset view"
    _, copied = sc.kernel_operands(*views)
    assert copied == (layout == "offset view")
    got = sc.ssd_chunk(*views)
    _close(sc.ssd_chunk(*(v.contiguous() for v in views)), got, CHUNK_TOL,
           "contiguous copies")
    _close(RR.ssd_chunk_reference(**_jnp(inputs)), got, CHUNK_TOL, "oracle")
    _close(RO.ssd(**_jnp(inputs), interpret=True), got, CHUNK_TOL,
           "interpret-mode kernel")


@pytest.mark.parametrize("layout", ["chunk loop", "longer sequence"])
def test_ssd_chunk_writes_y_into_a_given_view(layout):
    """``out``: y lands in a strided view of a larger buffer (as the chunk
    loop passes the scan's output), and nothing else of it is written."""
    inputs = chunk_inputs(_rng(12), 2, 3, 16, 16, 8)
    views = _views(inputs, layout)
    buf = torch.full((2, 20, 3, 16), 7.0)
    out = buf[:, 2:18].transpose(1, 2)
    y, s_new = sc.ssd_chunk(*views, out)
    assert y is out
    want = sc.ssd_chunk(*views)
    assert_same(want[0], buf[:, 2:18].transpose(1, 2))
    assert_same(want[1], s_new)
    assert bool((buf[:, :2] == 7).all() and (buf[:, 18:] == 7).all())
    with pytest.raises(ValueError, match="out"):
        sc.ssd_chunk(*views, buf[:, 2:17].transpose(1, 2))


@pytest.mark.parametrize("arch", ["mamba2_370m", "zamba2_2_7b"])
def test_the_chunk_loop_copies_nothing_at_the_models_shapes(arch,
                                                            monkeypatch):
    """One Mamba2 block at the model's width (its P, N and chunk of 256;
    300 tokens: a whole chunk and a padded one), bf16 as the models run:
    every chunk call's inputs are views the kernel reads as they lie
    (``kernel_operands`` copies nothing, ``COPIES`` stays 0) and y goes
    into one buffer for the scan."""
    cfg = get_arch(arch)
    lp = PS.layer(PS.init_ssm_layers(
        cfg, torch.Generator(device="cpu").manual_seed(0), (1,),
        device="cpu"), 0)
    calls = []

    def checked(*a):
        args, copied = sc.kernel_operands(*a[:6])
        assert not copied, [tuple(t.stride()) for t in a[:6]]
        assert len(a) == 7 and a[6].stride(-1) == 1
        calls.append(tuple(a[0].shape))
        return sc.ssd_chunk(*a)

    monkeypatch.setattr(PS, "ssd_chunk", checked)
    sc.reset_launch_counts()
    x = torch.from_numpy(_rng(13).normal(size=(1, 300, cfg.d_model)).astype(
        np.float32)).to(torch.bfloat16)
    out, _ = PS.ssm_block(cfg, lp, x)
    _, H, P, _ = PS.dims(cfg)
    assert calls == [(1, H, 256, P)] * 2
    assert sc.COPIES["ssd_chunk"] == 0
    assert bool(torch.isfinite(out.float()).all())


def _tf32(a):
    """float32 rounded to TF32 (10 stored mantissa bits), to nearest, ties
    away from zero: what ``cvt.rna.tf32.f32`` does."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _products(a, b, parts):
    """a @ b as the kernel takes it on the tensor cores: with ``parts`` 3,
    each operand split into TF32 hi and lo, a_lo b_hi + a_hi b_lo +
    a_hi b_hi with float32 sums (3xTF32); with 1, TF32 alone."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if parts == 1:
        return _tf32(a) @ _tf32(b)
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _emulated_chunk(inp, parts):
    """The kernel's arithmetic on the CPU: C B^T once per batch row, W =
    (C B^T) o L o dt (masked before exp), y = W x + (exp(cum) o C)
    S_prev^T, S_new = exp(cum_last) S_prev + u^T B, each product in
    ``_products``, the rest float32."""
    f32 = np.float32
    x, dt, bm, cm, cum, s = (inp[k] for k in ("x", "dt", "bm", "cm", "cum",
                                              "s_prev"))
    B, H, Q, _ = x.shape
    causal = np.tril(np.ones((Q, Q), bool))
    y, s_new = np.zeros_like(x), np.zeros_like(s)
    for b in range(B):
        g = _products(cm[b], bm[b].T, parts)
        for h in range(H):
            c = cum[b, h]
            L = np.exp(np.where(causal, c[:, None] - c[None, :], -np.inf))
            w = (g * L.astype(f32) * dt[b, h][None, :]).astype(f32)
            y[b, h] = _products(w, x[b, h], parts) + _products(
                cm[b] * np.exp(c)[:, None].astype(f32), s[b, h].T, parts)
            u = x[b, h] * dt[b, h][:, None] * np.exp(c[-1] - c)[:, None]
            s_new[b, h] = np.exp(c[-1]).astype(f32) * s[b, h] + _products(
                u.astype(f32).T, bm[b], parts)
    return y, s_new


@pytest.mark.parametrize("dt_range", [(0.01, 0.3), (0.0, 1e-6), (4.0, 8.0)],
                         ids=["dt typical", "dt near 0", "dt large"])
@pytest.mark.parametrize("P,N", [(64, 128), (64, 64)],
                         ids=["mamba2 chunk", "zamba2 chunk"])
def test_the_split_precision_scheme_meets_the_bound(P, N, dt_range):
    """3xTF32, emulated with TF32 rounding of hi and lo, three products and
    float32 sums, at the models' chunk shapes (Q 256) with small B and H:
    within 1e-4 of the largest magnitude (CHUNK_TOL's bound, as a share)
    of a float64 evaluation (the plain version on float64 tensors), for y
    and S_new.  TF32 alone is not: its y is off by more than that."""
    inputs = chunk_inputs(_rng(P + N), 1, 2, 256, P, N, dt_range=dt_range)
    want = tuple(t.numpy() for t in sc.ssd_chunk_plain(
        **{k: torch.from_numpy(v).double() for k, v in inputs.items()}))
    for parts in (3, 1):
        got = _emulated_chunk(inputs, parts)
        share = [float(np.abs(g - w).max() / np.abs(w).max())
                 for g, w in zip(got, want)]
        if parts == 3:
            assert max(share) <= 1e-4, share
        else:
            assert share[0] > 1e-4, share


# ---------------------------------------------------------------------------
# the scan over chunks, the conv, the block (float32)
# ---------------------------------------------------------------------------


def scan_inputs(rng, B, S, H, P, N):
    f32 = np.float32
    return {"x": rng.normal(size=(B, S, H, P)).astype(f32),
            "dt": rng.uniform(0.01, 0.3, size=(B, S, H)).astype(f32),
            "A": -rng.uniform(0.5, 2.0, size=(H,)).astype(f32),
            "Bm": rng.normal(size=(B, S, N)).astype(f32),
            "Cm": rng.normal(size=(B, S, N)).astype(f32)}


@pytest.mark.parametrize("S", [128, 100, 20], ids=["4 chunks", "pad", "S<Q"])
@pytest.mark.parametrize("init_state", [False, True])
def test_ssd_chunked_matches_reference(S, init_state, monkeypatch):
    B, H, P, N, Q = 2, 4, 16, 8, 32
    rng = _rng(S)
    inputs = scan_inputs(rng, B, S, H, P, N)
    if init_state:
        inputs["init_state"] = rng.normal(size=(B, H, P, N)).astype(np.float32)
    calls = []

    def counted(*a):
        calls.append(a[0].shape)
        return sc.ssd_chunk(*a)

    monkeypatch.setattr(PS, "ssd_chunk", counted)
    want = RS.ssd_chunked(**_jnp(inputs), chunk=Q)
    got = PS.ssd_chunked(**_torch(inputs), chunk=Q)
    _close(want[0], got[0], SCAN_TOL, "y")
    _close(want[1], got[1], SCAN_TOL, "final state")
    Qc = min(Q, S)
    assert calls == [(B, H, Qc, P)] * (-(-S // Qc))   # one call per chunk


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = _rng(3)
    inputs = {"x": rng.normal(size=(2, 7, 24)).astype(np.float32),
              "w": (rng.normal(size=(4, 24)) * 0.2).astype(np.float32),
              "b": (rng.normal(size=(24,)) * 0.1).astype(np.float32)}
    if with_state:
        inputs["state"] = rng.normal(size=(2, 3, 24)).astype(np.float32)
    want = RS._causal_conv(**_jnp(inputs))
    got = PS._causal_conv(**_torch(inputs))
    _close(want[0], got[0], 2e-5, "out")
    _close(want[1], got[1], 0.0, "tail")


def _layer0(arch, dtype, seed=0):
    ref_cfg = ref_get_arch(arch).reduced()
    lp_ref = RS.init_ssm_layer(ref_cfg, jax.random.PRNGKey(seed), dtype=dtype)
    lp = params_from_numpy(jax.tree_util.tree_map(np.asarray, lp_ref),
                           device="cpu")
    return ref_cfg, get_arch(arch).reduced(), lp_ref, lp


@pytest.mark.parametrize("mode", ["prefill", "decode", "streaming chunk"])
def test_ssm_block_matches_reference(mode):
    ref_cfg, cfg, lp_ref, lp = _layer0("mamba2_370m", jnp.float32)
    d_inner, H, P, N = PS.dims(cfg)
    rng = _rng(4)
    S = {"prefill": 40, "decode": 1, "streaming chunk": 20}[mode]
    inputs = {"x": rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)}
    kw = {}
    if mode != "prefill":
        inputs["conv_state"] = rng.normal(
            size=(2, cfg.ssm_conv - 1, d_inner + 2 * N)).astype(np.float32)
        inputs["ssm_state"] = rng.normal(size=(2, H, P, N)).astype(np.float32)
        kw["streaming"] = True
    want_x, (want_conv, want_state) = RS.ssm_block(ref_cfg, lp_ref,
                                                   **_jnp(inputs), **kw)
    got_x, (got_conv, got_state) = PS.ssm_block(cfg, lp, **_torch(inputs),
                                                **kw)
    assert got_x.dtype == torch.float32 and got_state.dtype == torch.float32
    for what, want, got in (("x", want_x, got_x), ("conv", want_conv, got_conv),
                            ("state", want_state, got_state)):
        assert_same(want, got, tol=SCAN_TOL, what=what)


# ---------------------------------------------------------------------------
# the models: prefill, cache, decode with carried-over bfloat16 weights
# ---------------------------------------------------------------------------


def _carried_over(arch, seed=0):
    ref_model = ref_get_model(ref_get_arch(arch).reduced())
    ref_params = ref_model.init(jax.random.PRNGKey(seed))
    params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    return ref_model, ref_params, get_model(get_arch(arch).reduced()), params


def _caches_match(ref_cache, cache, what):
    assert int(ref_cache.pos) == cache.pos, what
    assert ref_cache._fields == cache._fields
    for name in ref_cache._fields[:-1]:
        got = getattr(cache, name)
        assert got.dtype == (torch.float32 if name == "state"
                             else torch.bfloat16), (what, name)
        assert_same(getattr(ref_cache, name), got, tol=BF16_TOL,
                    what=f"{what}: {name}")


@pytest.mark.parametrize("arch", ["mamba2_370m", "zamba2_2_7b"])
def test_prefill_and_three_decode_steps_match_reference(arch):
    ref_model, ref_params, model, params = _carried_over(arch)
    B, S, max_len = 2, 20, 32                  # 20 = one chunk of 16 + pad
    toks = _rng(5).integers(2, model.cfg.vocab - 1,
                            size=(B, S + 3)).astype(np.int32)
    want, ref_cache = jax.jit(lambda p, t: ref_model.prefill(
        p, {"tokens": t}, max_len))(ref_params, jnp.asarray(toks[:, :S]))
    got, cache = make_prefill_step(model, max_len)(
        params, {"tokens": toks[:, :S]})
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, 512)
    assert_same(want, got, tol=BF16_TOL, what="prefill logits")
    _caches_match(ref_cache, cache, "prefill")
    assert to_numpy(want).std() > BF16_TOL * np.abs(to_numpy(want)).max()
    ref_decode = jax.jit(ref_model.decode)
    for s in range(3):
        step = toks[:, S + s:S + s + 1]
        want, ref_cache = ref_decode(ref_params, ref_cache, jnp.asarray(step))
        got, cache = model.decode(params, cache, torch.from_numpy(step))
        assert_same(want, got, tol=BF16_TOL, what=f"logits, step {s}")
        _caches_match(ref_cache, cache, f"step {s}")


@pytest.mark.parametrize("arch", ["mamba2_370m", "zamba2_2_7b"])
def test_prefill_then_decode_equals_a_longer_prefill(arch):
    """prefill(S) + decode(1) against prefill(S + 1) in the port: the
    recurrence and the chunked scan are the same sums (bf16 2e-2)."""
    *_, model, params = _carried_over(arch)
    toks = torch.from_numpy((np.arange(17) % 13 + 2).astype(np.int32))[None]
    _, cache = model.prefill(params, {"tokens": toks[:, :16]}, 32)
    stepped, _ = model.decode(params, cache, toks[:, 16:])
    whole, _ = model.prefill(params, {"tokens": toks}, 32)
    assert_same(whole, stepped, tol=BF16_TOL)


def test_params_from_numpy_keeps_the_hybrid_tree_and_its_float32_leaves():
    ref = RH.init_params(ref_get_arch("zamba2_2_7b").reduced(),
                         jax.random.PRNGKey(1))
    port = params_from_numpy(jax.tree_util.tree_map(np.asarray, ref),
                             device="cpu")
    assert_same(ref, port)                     # bit for bit, nested
    for leaf in ("A_log", "D_skip", "dt_bias"):
        assert port["ssm"][leaf].dtype == torch.float32, leaf
    assert port["ssm"]["in_proj"].dtype == torch.bfloat16
    assert port["shared_attn"]["wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["mamba2_370m", "zamba2_2_7b"])
def test_init_params_tree_matches_reference(arch):
    ref = ref_get_model(ref_get_arch(arch).reduced()).init(
        jax.random.PRNGKey(0))
    port = get_model(get_arch(arch).reduced()).init(
        torch.Generator(device="cpu").manual_seed(0), device="cpu")

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict)
                else (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in tree.items()}

    assert shapes(port) == shapes(ref)
    layers = port["layers"] if "layers" in port else port["ssm"]
    ref_layers = ref["layers"] if "layers" in ref else ref["ssm"]
    for leaf in ("A_log", "D_skip", "dt_bias"):   # deterministic leaves
        assert_same(ref_layers[leaf], layers[leaf], tol=1e-6, what=leaf)


def test_hybrid_sites_and_prefill_cache_length():
    cfg = get_arch("zamba2_2_7b")
    assert PH.n_sites(cfg) == RH.n_sites(ref_get_arch("zamba2_2_7b")) == 9
    small = cfg.reduced()
    model = get_model(small)
    params = model.init(torch.Generator(device="cpu").manual_seed(0),
                        device="cpu")
    toks = torch.full((1, 5), 3, dtype=torch.int32)
    _, cache = model.prefill(params, {"tokens": toks}, 12)
    assert tuple(cache.k.shape) == (2, 1, 12, small.n_kv_heads, small.hd)
    assert float(cache.k[:, :, 5:].abs().max()) == 0 and cache.pos == 5
    with pytest.raises(ValueError, match="max_len"):
        model.prefill(params, {"tokens": toks}, 4)


def test_decode_updates_the_ssm_cache_in_place():
    *_, model, params = _carried_over("mamba2_370m")
    cache = model.init_cache(2, 8, device="cpu")
    nxt, logits, new = make_serve_step(model)(
        params, cache, torch.full((2, 1), 5, dtype=torch.int32))
    assert new.conv is cache.conv and new.state is cache.state
    assert new.pos == 1 and float(cache.state.abs().max()) > 0
    assert torch.equal(nxt[:, 0].long(), logits.float().argmax(-1))


def test_prefill_step_needs_a_prefill():
    """Every family has a prefill now; a ``Model`` made without one is
    refused when its prefill step is made, not when it is called."""
    model = dataclasses.replace(get_model(get_arch("qwen2_7b").reduced()),
                                prefill=None)
    with pytest.raises(NotImplementedError, match="prefill"):
        make_prefill_step(model, 8)

