"""The backwards of the port's kernels B4, B5 and B6 against ``jax.grad`` of
the JAX package's oracles in ``repro/kernels/ref.py``, float32, within
2e-5 of max(1, the largest magnitude of the reference's gradient).

Each kernel's ``torch.autograd.Function`` runs its wrapper forward (the
plain version here, on the CPU; the kernel on the card) and its backward
in torch ops; these tests reach the same backward the card runs.  The
backwards call no plain version: every test runs them with the plain
versions patched to fail."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.models import ssm as RS
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_dispatch as md
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_chunk as sc
from repro_torch.models import ssm as PS

from torch_parity import FP32_TOL, assert_same


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _ref_vjp(fn, inputs, cotangents):
    """The reference's outputs and ``jax.vjp`` gradients, in one jit."""
    def both(args, cts):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(cts if isinstance(out, tuple) else cts[0])

    return jax.jit(both)(tuple(jnp.asarray(a) for a in inputs),
                         tuple(jnp.asarray(c) for c in cotangents))


def _grads(fn, inputs, cotangents):
    """torch.autograd gradients of ``fn(*inputs)`` for ``cotangents``."""
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out = fn(*ts)
    out = out if isinstance(out, tuple) else (out,)
    return out, torch.autograd.grad(
        out, ts, tuple(torch.from_numpy(c) for c in cotangents))


@pytest.fixture
def no_plain(monkeypatch):
    """The backwards must not reach a plain version: only the forward
    (which runs the wrapper, and so the plain version on the CPU) may."""
    state = {"backward": False}
    for mod, name in ((fa, "mha_plain"), (sc, "ssd_chunk_plain"),
                      (md, "moe_dispatch_plain")):
        real = getattr(mod, name)

        def guarded(*a, _real=real, _name=name, **k):
            assert not state["backward"], f"{_name} reached from a backward"
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, guarded)
    for fn_cls in (fa.AttentionFn, sc.SsdChunkFn, md.DispatchFn):
        real = fn_cls.backward

        def backward(ctx, *g, _real=real):
            state["backward"] = True
            try:
                return _real(ctx, *g)
            finally:
                state["backward"] = False

        monkeypatch.setattr(fn_cls, "backward", staticmethod(backward))
    return state


# ---------------------------------------------------------------------------
# B4: flash attention
# ---------------------------------------------------------------------------

ATTN_CASES = {
    # B, Sq, Sk, H, Hkv, D, causal, window, kv_len
    "causal": (2, 24, 24, 4, 4, 32, True, 0, None),
    "window": (1, 40, 40, 2, 2, 32, True, 8, None),
    "kv_len": (2, 16, 24, 2, 2, 32, False, 0, 11),
    "gqa2": (1, 20, 20, 4, 2, 32, True, 0, None),
    "gqa4-ragged": (2, 9, 17, 8, 2, 32, False, 0, None),
    "ragged-causal": (1, 13, 21, 4, 2, 32, True, 0, None),
    "d72": (1, 12, 12, 4, 2, 72, True, 0, None),
    "d240": (1, 10, 10, 2, 1, 240, True, 5, None),
    "no-key-kv_len0": (1, 6, 6, 2, 2, 16, True, 0, 0),
    "no-key-window": (1, 12, 12, 2, 1, 16, True, 3, 4),
}


def _mha_ref(B, Sq, Sk, H, Hkv, D, **mask):
    """The reference oracle over the models' (B, S, heads, D) layout: heads
    folded into the leading axis, each kv head repeated for its group."""
    rep = H // Hkv

    def f(q, k, v):
        def fold(t, S, n):
            return jnp.repeat(t, n, axis=2).transpose(0, 2, 1, 3).reshape(
                B * H, S, D)

        o = ref.mha_reference(fold(q, Sq, 1), fold(k, Sk, rep),
                              fold(v, Sk, rep), **mask)
        return o.reshape(B, H, Sq, D).transpose(0, 2, 1, 3)

    return f


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_backward_matches_jax_grad_of_the_oracle(case, no_plain):
    B, Sq, Sk, H, Hkv, D, causal, window, kv_len = ATTN_CASES[case]
    rng = _rng(len(case))
    q, do = _f32(rng, B, Sq, H, D), _f32(rng, B, Sq, H, D)
    k, v = _f32(rng, B, Sk, Hkv, D), _f32(rng, B, Sk, Hkv, D)
    mask = dict(causal=causal, window=window, kv_len=kv_len)
    want_out, want = _ref_vjp(_mha_ref(B, Sq, Sk, H, Hkv, D, **mask),
                              (q, k, v), (do,))
    (out,), got = _grads(lambda q, k, v: ops.mha(q, k, v, **mask),
                         (q, k, v), (do,))
    assert_same(want_out, out, tol=FP32_TOL, what="out")
    for name, w, g in zip("qkv", want, got):
        assert_same(w, g, tol=FP32_TOL, what=f"d{name}")
    if case.startswith("no-key"):
        # rows that see no key: their output is the mean of v, so they
        # send nothing to q (and k) and dO / Sk to every key's v
        row0 = fa.first_blind_row(Sq, min(kv_len, Sk), window)
        assert row0 < Sq
        assert float(got[0][:, row0:].abs().max()) == 0.0


def test_attention_backward_blocks_the_query_rows(monkeypatch):
    """A block of a few query rows gives what one block of all rows gives
    (the block size only bounds the backward's memory)."""
    rng = _rng(3)
    q, k, v, do = (_f32(rng, 2, 30, 4, 16) for _ in range(4))
    args = [torch.from_numpy(a) for a in (q, k, v, do)]
    whole = fa.attention_backward(*args, causal=True, window=7)
    monkeypatch.setattr(fa, "BWD_TENSOR_BYTES", 2 * 4 * 30 * 4 * 3)
    assert max(1, fa.BWD_TENSOR_BYTES // (2 * 4 * 30 * 4)) == 3
    blocked = fa.attention_backward(*args, causal=True, window=7)
    for w, g in zip(whole, blocked):
        assert_same(w, g, tol=1e-6)


def test_attention_backward_keeps_the_input_dtypes():
    rng = _rng(4)
    q, k, v = (torch.from_numpy(_f32(rng, 1, 8, 2, 16)).to(torch.bfloat16)
               .requires_grad_() for _ in range(3))
    out = ops.mha(q, k, v)
    out.float().square().sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 for t in (q, k, v))
    assert all(t.grad.shape == t.shape for t in (q, k, v))


# ---------------------------------------------------------------------------
# B6: one SSD chunk, and the scan over chunks
# ---------------------------------------------------------------------------


def _chunk_inputs(rng, B, H, Q, P, N):
    dt = rng.uniform(0.01, 0.5, size=(B, H, Q)).astype(np.float32)
    a = rng.uniform(0.5, 2.0, size=(1, H, 1)).astype(np.float32)
    return [_f32(rng, B, H, Q, P), dt, _f32(rng, B, Q, N), _f32(rng, B, Q, N),
            np.cumsum(-dt * a, axis=-1).astype(np.float32),
            _f32(rng, B, H, P, N)]


@pytest.mark.parametrize("Q", [1, 16, 33])
def test_ssd_chunk_backward_matches_jax_grad_of_the_oracle(Q, no_plain):
    rng = _rng(Q)
    B, H, P, N = 2, 3, 8, 4
    args = _chunk_inputs(rng, B, H, Q, P, N)
    dy, ds = _f32(rng, B, H, Q, P), _f32(rng, B, H, P, N)
    (want_y, want_s), want = _ref_vjp(ref.ssd_chunk_reference, args,
                                      (dy, ds))
    (y, s_new), got = _grads(ops.ssd, args, (dy, ds))
    assert_same(want_y, y, tol=FP32_TOL, what="y")
    assert_same(want_s, s_new, tol=FP32_TOL, what="s_new")
    for name, w, g in zip(("x", "dt", "bm", "cm", "cum", "s_prev"), want,
                          got):
        assert_same(w, g, tol=FP32_TOL, what=f"d{name}")


@pytest.mark.parametrize("S", [64, 50], ids=["whole chunks", "padded tail"])
def test_the_chunked_scan_backward_matches_jax_grad(S, no_plain,
                                                   monkeypatch):
    """The scan over chunks of 16 with a carried-in state: S handed from
    chunk to chunk, and the padded tail chunk, differentiated end to end
    against ``jax.grad`` of the JAX package's ``ssd_chunked``."""
    rng = _rng(S)
    B, H, P, N, Q = 2, 3, 8, 4, 16
    inputs = {"x": _f32(rng, B, S, H, P),
              "dt": rng.uniform(0.01, 0.5, size=(B, S, H)).astype(np.float32),
              "A": -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32),
              "Bm": _f32(rng, B, S, N), "Cm": _f32(rng, B, S, N),
              "init_state": _f32(rng, B, H, P, N)}
    dy, ds = _f32(rng, B, S, H, P), _f32(rng, B, H, P, N)
    names = list(inputs)

    def ref_fn(*a):
        return RS.ssd_chunked(**dict(zip(names, a)), chunk=Q)

    want_out, want = _ref_vjp(ref_fn, list(inputs.values()), (dy, ds))
    calls = []
    real = sc.SsdChunkFn.apply

    def counted(*a):
        calls.append(tuple(a[0].shape))
        return real(*a)

    monkeypatch.setattr(sc.SsdChunkFn, "apply", counted)
    out, got = _grads(lambda *a: PS.ssd_chunked(
        **dict(zip(names, a)), chunk=Q), list(inputs.values()), (dy, ds))
    assert calls == [(B, H, Q, P)] * (-(-S // Q))    # the autograd path
    assert_same(want_out[0], out[0], tol=FP32_TOL, what="y")
    for name, w, g in zip(names, want, got):
        assert_same(w, g, tol=FP32_TOL, what=f"d{name}")


def test_the_scan_takes_the_copy_free_path_without_gradients(monkeypatch):
    """With no input that needs a gradient the scan writes every chunk's y
    into one buffer (``out=``), as the prefill has since the kernel was
    redesigned; both paths give the same y and state."""
    rng = _rng(9)
    B, S, H, P, N = 1, 40, 2, 8, 4
    x, Bm, Cm = (torch.from_numpy(_f32(rng, *s)) for s in
                 ((B, S, H, P), (B, S, N), (B, S, N)))
    dt = torch.from_numpy(rng.uniform(0.01, 0.5, size=(B, S, H)).astype(
        np.float32))
    A = -torch.ones(H)
    seen = []
    real = sc.ssd_chunk

    def spy(*a):
        seen.append(len(a))
        return real(*a)

    monkeypatch.setattr(PS, "ssd_chunk", spy)
    y0, s0 = PS.ssd_chunked(x, dt, A, Bm, Cm, 16)
    assert seen == [7] * 3                       # every call with out=
    y1, s1 = PS.ssd_chunked(x.requires_grad_(), dt, A, Bm, Cm, 16)
    assert y1.requires_grad
    assert_same(y0, y1, tol=0.0)
    assert_same(s0, s1, tol=0.0)


# ---------------------------------------------------------------------------
# B5: MoE dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,S,dtype", [(7, 20, np.float32),
                                       (5, 64, np.float32),
                                       (1, 9, np.float32), (16, 24, "bf16")])
def test_dispatch_backward_matches_jax_grad_of_the_oracle(T, S, dtype,
                                                          no_plain):
    """Empty slots (the zeros row ``T``), tokens in several slots and
    tokens in none, against ``jax.grad`` of ``moe_dispatch_reference``."""
    rng = _rng(T * S)
    xp = _f32(rng, T + 1, 12)
    xp[T] = 0
    st = rng.integers(0, T + 1, size=S).astype(np.int32)
    st[:3] = T                                   # at least three empty slots
    st[3:5] = 0                                  # token 0 in two slots
    do = _f32(rng, S, 12)
    _, (want,) = _ref_vjp(lambda a: ref.moe_dispatch_reference(
        a, jnp.asarray(st)), (xp,), (do,))
    x = torch.from_numpy(xp)
    if dtype == "bf16":
        x = x.to(torch.bfloat16)
    x.requires_grad_()
    out = md.DispatchFn.apply(x, torch.from_numpy(st))
    got, = torch.autograd.grad(out, x, torch.from_numpy(do).to(x.dtype))
    assert got.dtype == x.dtype
    assert_same(want, got.float(), tol=FP32_TOL if dtype != "bf16" else 2e-2)
    counts = np.bincount(st, minlength=T + 1)
    assert float(got[counts == 0].abs().max() if (counts == 0).any()
                 else 0.0) == 0.0


def test_dispatch_backward_is_one_fixed_order_sum():
    """Every row's gradient is the sum of its slots' in one fixed order, so
    two runs are equal bit for bit; ``ops.dispatch`` drops the zeros row's
    gradient (the backward of the pad that appended it)."""
    rng = _rng(11)
    T, D = 40, 8
    st = torch.from_numpy(rng.integers(0, T + 1, size=300).astype(np.int32))
    do = torch.from_numpy(_f32(rng, 300, D))
    a = md.moe_dispatch_backward(do, st, T + 1)
    b = md.moe_dispatch_backward(do.clone(), st.clone(), T + 1)
    assert torch.equal(a, b)
    want = torch.zeros(T + 1, D, dtype=torch.float64)
    want.index_add_(0, st.long(), do.double())
    assert_same(want.numpy(), a, tol=FP32_TOL)
    x = torch.from_numpy(_f32(rng, T, D)).requires_grad_()
    ops.dispatch(x, st).backward(do)
    assert_same(a[:T], x.grad, tol=0.0)
