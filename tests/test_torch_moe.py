"""The MoE family of the port against the JAX package's: routing, capacity,
the dense oracle and the sorted serving path in float32 (tolerance 2e-5,
with and without capacity drops), the ``moe_dispatch`` kernel's plain
version and ``ops.dispatch`` against the JAX ``ops.dispatch`` in interpret
mode (exactly), ``moe_combine``, and the MoE model's entry points."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.kernels import moe_dispatch as RMD
from repro.kernels import ops as RO
from repro.models import moe as RM
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import moe_dispatch as md
from repro_torch.kernels import ops as PO
from repro_torch.kernels import ref as PR
from repro_torch.models import get_model
from repro_torch.models import moe as PM

from torch_parity import FP32_TOL, assert_same, to_numpy


def _rng(seed=0):
    return np.random.default_rng(seed)


def _cfgs(arch="olmoe_1b_7b", **replace):
    return (dataclasses.replace(ref_get_arch(arch).reduced(), **replace),
            dataclasses.replace(get_arch(arch).reduced(), **replace))


def _layer(ref_cfg, seed=0):
    """Layer 0 of the JAX package's float32 MoE parameters, in both
    packages."""
    params = RM.init_moe_params(ref_cfg, jax.random.PRNGKey(seed),
                                dtype=jnp.float32)
    lp_ref = jax.tree_util.tree_map(lambda x: x[0], params["layers"])
    lp = params_from_numpy(jax.tree_util.tree_map(np.asarray, lp_ref),
                           device="cpu")
    return lp_ref, lp


def _hidden(rng, B, S, D):
    return rng.normal(size=(B, S, D)).astype(np.float32)


# ---------------------------------------------------------------------------
# routing, capacity, the two expert paths (float32)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "llama4_maverick"])
def test_capacity_equals_reference(arch):
    for cf in (1.0, 1.25, 8.0):
        ref_cfg = dataclasses.replace(ref_get_arch(arch), capacity_factor=cf)
        cfg = dataclasses.replace(get_arch(arch), capacity_factor=cf)
        for T in (1, 8, 64, 80, 100, 4096):
            assert PM.capacity(cfg, T) == RM.capacity(ref_cfg, T)
            assert PM.capacity(cfg.reduced(), T) == \
                RM.capacity(ref_cfg.reduced(), T)
    assert PM.capacity(get_arch("olmoe_1b_7b"), 8) == 8
    assert PM.capacity(get_arch("olmoe_1b_7b"), 4096) == 640


@pytest.mark.parametrize("T", [1, 37])
def test_route_matches_reference(T):
    ref_cfg, cfg = _cfgs()
    lp_ref, lp = _layer(ref_cfg)
    xt = _rng(T).normal(size=(T, cfg.d_model)).astype(np.float32)
    want = RM._route(ref_cfg, lp_ref["router"], jnp.asarray(xt))
    got = PM._route(cfg, lp["router"], torch.from_numpy(xt))
    assert_same(want[1], got[1], what="top_i")
    assert_same(want[0], got[0], tol=FP32_TOL, what="top_p")
    assert_same(want[2], got[2], tol=FP32_TOL, what="aux")


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "llama4_maverick"])
def test_moe_ffn_dense_matches_reference(arch):
    ref_cfg, cfg = _cfgs(arch)
    lp_ref, lp = _layer(ref_cfg, seed=1)
    h = _hidden(_rng(1), 2, 9, cfg.d_model)
    want = RM.moe_ffn_dense(ref_cfg, lp_ref, jnp.asarray(h))
    got = PM.moe_ffn_dense(cfg, lp, torch.from_numpy(h))
    assert_same(want, got, tol=FP32_TOL)


@pytest.mark.parametrize("cf", [1.0, 8.0],
                         ids=["capacity drops", "no drops"])
def test_moe_ffn_sorted_matches_reference(cf):
    ref_cfg, cfg = _cfgs(capacity_factor=cf)
    lp_ref, lp = _layer(ref_cfg, seed=2)
    h = _hidden(_rng(2), 2, 40, cfg.d_model)          # T = 80 tokens
    want = RM.moe_ffn_sorted(ref_cfg, lp_ref, jnp.asarray(h))
    got = PM.moe_ffn_sorted(cfg, lp, torch.from_numpy(h))
    assert_same(want, got, tol=FP32_TOL)

    _, top_i, _ = PM._route(cfg, lp["router"],
                            torch.from_numpy(h).reshape(80, -1))
    C = PM.capacity(cfg, 80)
    *_, keep = PM.dispatch_slots(top_i, C, cfg.n_experts)
    dense, _ = PM.moe_ffn_dense(cfg, lp, torch.from_numpy(h))
    if cf == 1.0:       # some pairs fall past capacity, so sorted != dense
        assert C == 40 and not bool(keep.all())
        assert float((got[0] - dense).abs().max()) > 1e-3
    else:               # the twin of the JAX package's sorted-vs-dense test
        assert bool(keep.all())
        assert_same(dense, got[0], tol=FP32_TOL)


@pytest.mark.parametrize("cf", [1.0, 8.0],
                         ids=["capacity drops", "no drops"])
def test_expert_buffer_equals_the_reference_scatter(cf):
    """``dispatch_slots`` + ``ops.dispatch`` build exactly the (E, C, D)
    buffer that the JAX package's ``moe_ffn_sorted`` scatters."""
    ref_cfg, cfg = _cfgs(capacity_factor=cf)
    T, K, E, D = 80, cfg.top_k, cfg.n_experts, cfg.d_model
    C = RM.capacity(ref_cfg, T)
    rng = _rng(3)
    xt = rng.normal(size=(T, D)).astype(np.float32)
    # a skewed routing: expert 0 is every token's first choice
    top_i = np.stack([np.concatenate([[0], rng.permutation(
        np.arange(1, E))[:K - 1]]) for _ in range(T)]).astype(np.int32)

    flat_e = jnp.asarray(top_i).reshape(-1)
    order = jnp.argsort(flat_e)
    sorted_e = flat_e[order]
    first = jnp.searchsorted(sorted_e, sorted_e, side="left")
    rank = jnp.arange(T * K) - first
    slot = jnp.where(rank < C, rank, C)
    want = jnp.zeros((E, C + 1, D), jnp.float32).at[sorted_e, slot].set(
        jnp.asarray(xt)[order // K], mode="drop")[:, :C]

    slot_token, p_order, p_sorted, p_rank, keep = PM.dispatch_slots(
        torch.from_numpy(top_i).long(), C, E)
    assert slot_token.dtype == torch.int32
    assert tuple(slot_token.shape) == (E * C,)
    assert_same(order, p_order)
    assert_same(rank, p_rank)
    assert bool(keep.all()) == (cf == 8.0)
    got = PO.dispatch(torch.from_numpy(xt), slot_token).view(E, C, D)
    assert_same(want, got)


# ---------------------------------------------------------------------------
# B5: moe_dispatch, and moe_combine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("port", ["moe_dispatch_plain", "ops.dispatch"])
@pytest.mark.parametrize("T,D,EC", [(32, 16, 48), (128, 64, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_dispatch_matches_reference_exactly(T, D, EC, dtype, port):
    rng = _rng(T + D)
    x = rng.normal(size=(T, D)).astype(np.float32)
    slot = rng.integers(0, T + 1, size=(EC,)).astype(np.int32)
    want = RO.dispatch(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(slot))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    x_padded = torch.cat([xt, xt.new_zeros((1, D))])
    if port == "ops.dispatch":
        got = PO.dispatch(xt, torch.from_numpy(slot))
    else:
        got = md.moe_dispatch_plain(x_padded, torch.from_numpy(slot))
    assert got.dtype == xt.dtype
    assert_same(want, got)
    assert_same(want, md.moe_dispatch(x_padded, slot))
    assert_same(want, PR.moe_dispatch_reference(x_padded,
                                                torch.from_numpy(slot)))


def test_moe_dispatch_checks_its_arguments_on_the_host():
    x = torch.ones((4, 8))
    before = dict(md.LAUNCHES)
    with pytest.raises(IndexError, match="slot_token"):
        md.moe_dispatch(x, np.array([0, 4]))          # padded: rows 0..3
    with pytest.raises(IndexError, match="slot_token"):
        md.moe_dispatch(x, np.array([-1, 2]))
    with pytest.raises(IndexError, match="slot_token"):
        PO.dispatch(x, np.array([5]))                 # T = 4 is the zero row
    assert torch.equal(PO.dispatch(x, np.array([4, 0])),
                       torch.tensor([[0.0] * 8, [1.0] * 8]))
    with pytest.raises(TypeError):
        md.moe_dispatch(x, np.array([0.5]))
    with pytest.raises(ValueError, match="slot_token"):
        md.moe_dispatch(x, np.zeros((2, 2), np.int32))
    with pytest.raises(ValueError, match="x_padded"):
        md.moe_dispatch(torch.ones(4), np.array([0]))
    assert md.LAUNCHES == before          # a CPU tensor launches nothing


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_combine_matches_reference(dtype):
    rng = _rng(4)
    T, EC, D = 10, 48, 16
    y = rng.normal(size=(EC, D)).astype(np.float32)
    slot = rng.integers(0, T + 1, size=(EC,)).astype(np.int32)
    w = rng.random(EC).astype(np.float32)
    want = RMD.moe_combine(jnp.asarray(y, getattr(jnp, dtype)),
                           jnp.asarray(slot), jnp.asarray(w), T)
    got = PO.moe_combine(torch.from_numpy(y).to(getattr(torch, dtype)),
                         torch.from_numpy(slot), torch.from_numpy(w), T)
    assert got.dtype == torch.float32 and tuple(got.shape) == (T, D)
    assert_same(want, got, tol=FP32_TOL)


# ---------------------------------------------------------------------------
# the model around the kernel
# ---------------------------------------------------------------------------


def _cpu_model(arch="olmoe_1b_7b", seed=0, **kw):
    model = get_model(get_arch(arch).reduced(), **kw)
    params = model.init(torch.Generator(device="cpu").manual_seed(seed),
                        device="cpu")
    return model, params


def test_the_expert_buffer_goes_through_the_kernel_wrapper(monkeypatch):
    """``moe_ffn_sorted`` fills its expert buffer only through
    ``kernels/moe_dispatch.moe_dispatch``: once per MoE layer and step."""
    calls = []
    real = md.moe_dispatch

    def counted(x_padded, slot_token):
        calls.append((tuple(x_padded.shape), tuple(slot_token.shape)))
        return real(x_padded, slot_token)

    monkeypatch.setattr(md, "moe_dispatch", counted)
    model, params = _cpu_model()
    cfg = model.cfg
    cache = model.init_cache(3, 8, device="cpu")
    for step in range(2):
        _, cache = model.decode(params, cache,
                                torch.full((3, 1), 5 + step,
                                           dtype=torch.int32))
        assert len(calls) == cfg.n_layers * (step + 1)
    C = PM.capacity(cfg, 3)
    assert calls[0] == ((3 + 1, cfg.d_model), (cfg.n_experts * C,))


def test_dense_and_sorted_decode_agree_without_drops():
    model, params = _cpu_model()
    dense = get_model(model.cfg, moe_impl="dense")
    toks = torch.tensor([[7], [9]], dtype=torch.int32)
    a, _ = model.decode(params, model.init_cache(2, 8, device="cpu"), toks)
    b, _ = dense.decode(params, dense.init_cache(2, 8, device="cpu"), toks)
    assert_same(to_numpy(b), a, tol=2e-2)


def test_moe_impl_a2a_waits_for_a_mesh_and_unknown_impls_raise():
    """Without a mesh in the sharding policy ``a2a`` is ``sorted``, as in
    the JAX package (the mesh path: ``test_torch_distributed.py``)."""
    model, params = _cpu_model(moe_impl="a2a")
    sorted_model = get_model(model.cfg)
    toks = torch.ones((1, 1), dtype=torch.int32)
    a, _ = model.decode(params, model.init_cache(1, 4, device="cpu"), toks)
    b, _ = sorted_model.decode(params, sorted_model.init_cache(
        1, 4, device="cpu"), toks)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="moe_impl"):
        get_model(get_arch("olmoe_1b_7b"), moe_impl="sharded")


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "llama4_maverick"])
def test_init_moe_params_tree_matches_reference(arch):
    ref_cfg, cfg = _cfgs(arch)
    ref = RM.init_moe_params(ref_cfg, jax.random.PRNGKey(0))
    _, port = _cpu_model(arch)

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict)
                else (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in tree.items()}

    assert shapes(port) == shapes(ref)
    assert port["layers"]["router"].dtype == torch.float32
    assert port["layers"]["we_gate"].dtype == torch.bfloat16
    assert ("w_gate" in port["layers"]) == cfg.shared_expert
    std = float(port["layers"]["we_gate"].float().std())
    assert abs(std - cfg.d_model ** -0.5) < 0.2 * cfg.d_model ** -0.5


def test_params_from_numpy_carries_the_moe_tree_over_exactly():
    ref_cfg, _ = _cfgs()
    ref = RM.init_moe_params(ref_cfg, jax.random.PRNGKey(3))
    port = params_from_numpy(jax.tree_util.tree_map(np.asarray, ref),
                             device="cpu")
    assert port["layers"]["router"].dtype == torch.float32
    assert port["layers"]["we_down"].dtype == torch.bfloat16
    assert_same(ref, port)


@pytest.mark.parametrize("entry", ["init", "init_cache", "Server"])
def test_moe_entry_points_raise_without_a_card_unless_asked_for_cpu(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the default works here")
    from repro_torch.runtime.server import Server

    model = get_model(get_arch("olmoe_1b_7b").reduced())
    gen = torch.Generator(device="cpu").manual_seed(0)
    calls = {
        "init": lambda **kw: model.init(gen, **kw),
        "init_cache": lambda **kw: model.init_cache(1, 8, **kw),
        "Server": lambda **kw: Server(model, max_batch=1, max_len=8, **kw),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    assert calls[entry](device="cpu") is not None


def test_launcher_serves_reduced_olmoe_on_the_cpu(capsys, monkeypatch,
                                                 tmp_path):
    from repro_torch.launch import serve
    from test_torch_server import gate_first_solve

    gate_first_solve(monkeypatch)
    srv = serve.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
                      "--requests", "3", "--max-batch", "2", "--max-new", "3",
                      "--max-len", "32", "--seed", "2",
                      "--plan-store", str(tmp_path)])
    out = capsys.readouterr().out
    assert srv.swaps == 1 and not srv.queue and not srv.active
    assert "hot-swapped to solved layout" in out
    assert "served 3 requests (9 tokens)" in out
    assert srv.cfg.family == "moe"
