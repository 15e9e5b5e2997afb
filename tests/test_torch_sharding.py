"""The banking bridge to partition specs, against the JAX package.

The JAX package's own ``tests/test_distribution.py`` sharding tests,
re-pointed at ``repro_torch.parallel.sharding``, then cross-package parity
on mesh descriptions (16x16, 2x16x16, 2x4, 1x1) with and without FSDP:
``param_specs`` for every architecture at full width (shapes on the
``meta`` device here, ``jax.eval_shape`` there), ``batch_specs``,
``cache_specs`` and ``logits_spec`` for every architecture and shape,
``to_partition_spec`` of lane artifacts and of every tested layout, and
``zero1_specs`` -- entry by entry.  The placements of a spec on a live
``DeviceMesh`` are in ``test_torch_distributed.py``.
"""

import dataclasses

import jax
import pytest

import repro.core as ref_core
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_arch as ref_get_arch
from repro.models import get_model as ref_get_model
from repro.optim import adamw as ref_adamw
from repro.parallel import sharding as ref_shd

import repro_torch.core as core
from repro_torch.configs import ARCH_IDS, SHAPES, get_arch
from repro_torch.launch.mesh import MeshShape, make_production_mesh
from repro_torch.models import get_model, param_shapes
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shd
from torch_parity import LAYOUT_CASES, build_artifact, layout_id


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


MESHES = {
    "16x16": make_production_mesh(),
    "2x16x16": make_production_mesh(multi_pod=True),
    "2x4": MeshShape(("data", "model"), (2, 4)),
    "1x1": MeshShape(("data", "model"), (1, 1)),
}


def _ref_mesh(mesh):
    """The same axes as the object the JAX package's rules read."""
    return type("RefMesh", (), {"axis_names": mesh.axis_names,
                                "shape": dict(mesh.shape)})()


def _entries(spec):
    return tuple(spec)


def _same_specs(ref, port, what=""):
    if isinstance(ref, dict):
        assert ref.keys() == port.keys(), what
        for k in ref:
            _same_specs(ref[k], port[k], f"{what}/{k}")
    elif hasattr(ref, "_fields"):
        assert ref._fields == port._fields, what
        for k in ref._fields:
            _same_specs(getattr(ref, k), getattr(port, k), f"{what}/{k}")
    else:
        assert isinstance(port, shd.PartitionSpec), (what, port)
        assert _entries(ref) == _entries(port), (what, ref, port)


# ---------------------------------------------------------------------------
# The JAX package's sharding tests, re-pointed
# ---------------------------------------------------------------------------


def test_bankable_bridge():
    assert shd.bankable(8192, 16)
    assert shd.bankable(102400, 16)
    assert shd.bankable(64, 16)
    assert not shd.bankable(8, 16)        # fewer heads than lanes
    assert not shd.bankable(51865, 16)    # non-divisible vocab
    assert shd.bankable(240, 16)


@pytest.mark.parametrize("entries", [(), (None, "model"),
                                     (("data", "pod"), None, "model")],
                         ids=str)
def test_a_spec_survives_pickling(entries):
    """A spec crosses processes (the spec trees solved in a process of
    their own): unpickled, it is the spec it was, entry for entry."""
    import pickle

    spec = shd.P(*entries)
    back = pickle.loads(pickle.dumps(spec))
    assert type(back) is shd.PartitionSpec and back == spec
    assert tuple(back) == tuple(spec)


def test_param_specs_roles():
    cfg = dataclasses.replace(get_arch("deepseek_67b"), n_layers=2)
    specs = shd.param_specs(param_shapes(get_model(cfg)), FakeMesh(),
                            fsdp=False)
    assert specs["embed"] == shd.P("model", None)
    assert specs["layers"]["wq"][-1] == "model"
    assert specs["layers"]["wo"][1] == "model"
    assert specs["layers"]["w_down"][1] == "model"


def test_logical_axis_cache_specs():
    specs = shd.cache_specs(get_arch("zamba2_2_7b"), SHAPES["decode_32k"],
                            FakeMesh())
    assert specs.k[3] == "model"  # 32 kv heads shard over 16
    specs_long = shd.cache_specs(get_arch("gemma3_12b"), SHAPES["long_500k"],
                                 FakeMesh())
    assert specs_long.k[2] == ("data", "model")  # seq spread over all axes


def test_catalogs_match():
    assert list(ARCH_IDS) == list(REF_ARCH_IDS)
    assert list(SHAPES) == list(REF_SHAPES)


# ---------------------------------------------------------------------------
# Parity with the JAX package, entry by entry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch, mesh_name, fsdp):
    mesh = MESHES[mesh_name]
    ref_model = ref_get_model(ref_get_arch(arch))
    ref_shapes = jax.eval_shape(lambda: ref_model.init(jax.random.PRNGKey(0)))
    ref = ref_shd.param_specs(ref_shapes, _ref_mesh(mesh), fsdp=fsdp)
    port = shd.param_specs(param_shapes(get_model(get_arch(arch))), mesh,
                           fsdp=fsdp)
    _same_specs(ref, port, arch)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_cache_and_logits_specs_equal_the_reference(arch, mesh_name):
    mesh = MESHES[mesh_name]
    ref_mesh = _ref_mesh(mesh)
    cfg, ref_cfg = get_arch(arch), ref_get_arch(arch)
    for name, shape in SHAPES.items():
        ref_shape = REF_SHAPES[name]
        _same_specs(ref_shd.batch_specs(ref_cfg, ref_shape, ref_mesh),
                    shd.batch_specs(cfg, shape, mesh), f"{arch}/{name}")
        _same_specs(ref_shd.cache_specs(ref_cfg, ref_shape, ref_mesh),
                    shd.cache_specs(cfg, shape, mesh), f"{arch}/{name}")
    for sharded in (True, False):
        _same_specs(ref_shd.logits_spec(ref_mesh, sharded),
                    shd.logits_spec(mesh, sharded))
    assert shd.dp_axes(mesh) == ref_shd.dp_axes(ref_mesh)


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_zero1_specs_equal_the_reference(arch, mesh_name):
    mesh = MESHES[mesh_name]
    ref_model = ref_get_model(ref_get_arch(arch))
    ref_shapes = jax.eval_shape(lambda: ref_model.init(jax.random.PRNGKey(0)))
    ref = ref_adamw.zero1_specs(
        ref_shd.param_specs(ref_shapes, _ref_mesh(mesh), fsdp=True))
    port = adamw.zero1_specs(shd.param_specs(
        param_shapes(get_model(get_arch(arch))), mesh, fsdp=True))
    assert type(port) is adamw.AdamWState
    _same_specs(ref._asdict(), port._asdict(), arch)


LANES = [(8192, 16), (102400, 16), (64, 16), (240, 16), (3584, 4),
         (28, 2), (2048, 8)]
AXES = ["model", ("data", "model"), ("pod", "data")]


@pytest.mark.parametrize("axes", AXES, ids=str)
@pytest.mark.parametrize("dim,lanes", LANES)
def test_lane_artifact_partition_spec_equals_the_reference(dim, lanes, axes):
    ref = ref_shd.lane_artifact(dim, lanes)
    port = shd.lane_artifact(dim, lanes)
    assert port is not None and ref is not None
    assert port.banked_dims() == ref.banked_dims()
    _same_specs(ref.to_partition_spec(axes), port.to_partition_spec(axes))


@pytest.mark.parametrize("case", LAYOUT_CASES, ids=layout_id)
def test_to_partition_spec_of_every_layout_equals_the_reference(case):
    """Single and joint axes, and the ``ValueError`` of a diagonal flat
    scheme or of a mismatched count of axes, as the JAX package gives."""
    ref = build_artifact(ref_core, case, backend="numpy")
    port = build_artifact(core, case, backend="numpy")
    for axes in ("model", ("data", "model"), ["data", "model", "pod"]):
        try:
            want = ref.to_partition_spec(axes)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                port.to_partition_spec(axes)
            assert str(got.value) == str(e)
            continue
        _same_specs(want, port.to_partition_spec(axes), str(axes))


def test_partition_spec_entries():
    spec = shd.P(("data",), None, ("pod", "data"), "model")
    assert tuple(spec) == ("data", None, ("pod", "data"), "model")
    assert spec == tuple(jax.sharding.PartitionSpec(
        ("data",), None, ("pod", "data"), "model"))
    assert shd.P() == () and isinstance(shd.P(), tuple)


class _NamedMesh:
    mesh_dim_names = ("data", "model")
    shape = (2, 2)


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _NamedMesh()
    assert shd.mesh_axes(mesh) == {"data": 2, "model": 2}
    assert shd.placements(shd.P(("data", "model"), None), mesh) == (
        Shard(0), Shard(0))
    assert shd.placements(shd.P(None, "model"), mesh) == (Replicate(),
                                                          Shard(1))
    assert shd.placements(shd.P("data", "model"), mesh) == (Shard(0),
                                                            Shard(1))
    assert shd.placements(shd.P(), mesh) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="major to minor"):
        shd.placements(shd.P(("model", "data")), mesh)


def test_production_meshes_are_the_references():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.axis_names == ("data", "model")
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.axis_names == ("pod", "data", "model")
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512
    assert shd.mesh_axes(multi) == multi.shape
    assert shd.dp_axes(multi) == ("pod", "data")


def test_hints_are_identity_without_a_policy_and_per_thread():
    import threading

    import torch

    from repro_torch.parallel.hints import hint, policy_value, sharding_policy

    x = torch.ones(2, 3)
    assert hint(x, "residual") is x and policy_value("__mesh__") is None
    seen = {}
    with sharding_policy({"residual": shd.P("data", None), "__fsdp__": 1}):
        assert hint(x, "residual") is x          # a plain tensor passes
        assert hint(x, "unknown") is x
        assert policy_value("__fsdp__") == 1
        with sharding_policy({"__fsdp__": 2}):
            assert policy_value("__fsdp__") == 2
        assert policy_value("__fsdp__") == 1
        t = threading.Thread(target=lambda: seen.update(
            other=policy_value("__fsdp__", "none")))
        t.start()
        t.join(10)
        assert not t.is_alive()
    assert seen["other"] == "none" and policy_value("__fsdp__") is None
