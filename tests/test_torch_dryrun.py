"""The dry-run and the roofline of the port against the JAX package.

The analytic models (parameter counts on the ``meta`` device, executed and
useful FLOPs, per-device HBM and collective bytes) equal the JAX package's
for every architecture and shape, relative 1e-12.  The roofline's terms
are the same bytes and FLOPs over the H100's measured rates instead of the
TPU's.  The port's ``lower_cell`` runs the JAX package's mini multi-pod
cell (its ``tests/test_distribution.py::test_mini_dryrun_multipod``, which
compiles there) and its per-device bytes equal a numpy sum over the specs.
"""

import dataclasses
import json

import numpy as np
import pytest

from repro.configs import get_arch as ref_get_arch
from repro.launch import roofline as ref_roofline

from repro_torch.configs import ARCH_IDS, SHAPES, get_arch
from repro_torch.core import telemetry
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import MeshShape, make_production_mesh
from repro_torch.models import get_model, param_shapes
from repro_torch.parallel import sharding as shd

REL = 1e-12


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_equal_the_reference(arch):
    want = ref_roofline.param_counts(ref_get_arch(arch))
    got = roofline.param_counts(get_arch(arch))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=REL), k


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_flops_and_traffic_equal_the_reference(arch, shape,
                                                        monkeypatch):
    # both sides count parameters once per architecture here
    counts = {"ref": ref_roofline.param_counts(ref_get_arch(arch)),
              "port": roofline.param_counts(get_arch(arch))}
    monkeypatch.setattr(ref_roofline, "param_counts",
                        lambda cfg: counts["ref"])
    monkeypatch.setattr(roofline, "param_counts", lambda cfg: counts["port"])
    cfg, ref_cfg = get_arch(arch), ref_get_arch(arch)
    sh, ref_sh = SHAPES[shape], ref_roofline.SHAPES[shape]
    want = ref_roofline.analytic_flops(ref_cfg, ref_sh)
    got = roofline.analytic_flops(cfg, sh)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=REL), k
    for chips, n_model, n_data in ((256, 16, 16), (512, 16, 16), (8, 2, 2)):
        for fsdp in (False, True):
            a = ref_roofline.analytic_traffic(ref_cfg, ref_sh, chips,
                                              n_model, n_data, fsdp)
            b = roofline.analytic_traffic(cfg, sh, chips, n_model, n_data,
                                          fsdp)
            for k in a:
                assert b[k] == pytest.approx(a[k], rel=REL), (k, chips, fsdp)
    for windowed in (True, False):
        assert roofline._cache_bytes(cfg, sh, windowed) == pytest.approx(
            ref_roofline._cache_bytes(ref_cfg, ref_sh, windowed), rel=REL)


def test_the_rates_are_the_h100s_and_no_tpu_constant_is_left():
    """``PEAK_FLOPS`` and ``HBM_BW`` are what ``chip_smoke.py``'s
    ``roofline_probe`` measured on the H100 (below the data sheet's 989
    TFLOP/s and 3.35 TB/s); the link is NVLink's 450 GB/s each way."""
    assert 0 < roofline.PEAK_FLOPS < 989e12
    assert 0 < roofline.HBM_BW < 3.35e12
    assert roofline.LINK_BW == 450e9 and roofline.HBM_BYTES == 80e9
    for tpu in (197e12, 819e9, 50e9):
        assert tpu not in (roofline.PEAK_FLOPS, roofline.HBM_BW,
                           roofline.LINK_BW)
    assert not hasattr(roofline, "ICI_BW")
    assert not hasattr(roofline, "extrapolated_census")
    assert roofline.BOTTLENECK_NOTES == ref_roofline.BOTTLENECK_NOTES


def test_telemetry_prior_reads_the_measured_bandwidth():
    assert telemetry.roofline_bandwidth() == roofline.HBM_BW


CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES
         if (a, s) not in dryrun.SKIPS]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_analyze_cell_is_the_reference_terms_over_h100_rates(arch, shape):
    """The same FLOPs and bytes as the JAX package's roofline; only the
    rates they are divided by differ."""
    mesh = make_production_mesh()
    entry = dryrun.lower_cell(arch, shape, mesh)
    got = roofline.analyze_cell(entry, mesh, 256)
    ref_entry = {"arch": arch, "shape": shape, "flops": 0.0,
                 "bytes_accessed": 0.0, "collective_bytes": {},
                 "memory": {"bytes_per_device_peak": 0}}
    want = ref_roofline.analyze_cell(ref_entry, mesh, 256)
    assert got["fsdp"] == want["fsdp"] == entry["fsdp"]
    for term, rate, ref_rate in (
            ("compute_s", roofline.PEAK_FLOPS, ref_roofline.PEAK_FLOPS),
            ("memory_s", roofline.HBM_BW, ref_roofline.HBM_BW),
            ("collective_s", roofline.LINK_BW, ref_roofline.ICI_BW)):
        assert got[term] * rate == pytest.approx(want[term] * ref_rate,
                                                 rel=1e-9), term
    for k in ("model_flops", "executed_flops", "analytic_hbm_bytes_per_chip",
              "analytic_coll_bytes_per_chip",
              "useful_ratio_model_over_executed"):
        assert got[k] == pytest.approx(want[k], rel=REL), k
    terms = {k: got[k + "_s"] for k in ("compute", "memory", "collective")}
    assert got["dominant"] == max(terms, key=terms.get)
    assert got["note"] == roofline.BOTTLENECK_NOTES[got["dominant"]]
    assert (got["peak_flops"], got["hbm_bw"]) == (roofline.PEAK_FLOPS,
                                                  roofline.HBM_BW)
    assert not any(k.startswith("hlo_") for k in got)
    assert entry["flops"] == pytest.approx(
        want["executed_flops"] / 256, rel=REL)


def _np_local_bytes(shape, spec, axes, itemsize):
    n = 1
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        n *= int(np.ceil(size / np.prod([axes[a] for a in names] or [1])))
    return n * itemsize


def _np_tree_bytes(shapes, specs, axes):
    if isinstance(shapes, dict):
        return sum(_np_tree_bytes(v, specs[k], axes)
                   for k, v in shapes.items())
    return _np_local_bytes(tuple(shapes.shape), specs, axes,
                           shapes.dtype.itemsize)


def test_mini_dryrun_multipod(monkeypatch):
    """The JAX package's mini multi-pod cell, a (2, 2, 2) mesh of
    ("pod", "data", "model") and whisper at 4/2 heads training on 8 x 64
    tokens: flops > 0 and every per-device byte count equal to a numpy
    sum over the shard shapes the specs give."""
    mesh = MeshShape(("pod", "data", "model"), (2, 2, 2))
    cfg = dataclasses.replace(get_arch("whisper_base").reduced(), n_heads=4,
                              n_kv_heads=2)
    monkeypatch.setattr(dryrun, "get_arch", lambda name: cfg)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64,
                                global_batch=8)
    monkeypatch.setattr(dryrun, "SHAPES", {**SHAPES, "train_4k": shape})
    r = dryrun.lower_cell("whisper_base", "train_4k", mesh)
    assert r["flops"] > 0 and r["fits_hbm"]
    axes = {"pod": 2, "data": 2, "model": 2}
    shapes = param_shapes(get_model(cfg))
    specs = shd.param_specs(shapes, mesh, fsdp=r["fsdp"])
    mem = r["memory"]
    assert mem["bytes_per_device_params"] == _np_tree_bytes(shapes, specs,
                                                           axes)
    opt = 0
    for _ in range(3):     # m, v, master: float32, ZeRO over data and pod
        opt += _np_tree_bytes(
            {k: v.float() for k, v in _flat(shapes).items()},
            _flat(shd.param_specs(shapes, mesh, fsdp=True,
                                  fsdp_axes=("data", "pod"))), axes)
    assert mem["bytes_per_device_optimizer"] == opt + 4      # + step
    batch = 0
    for name in ("tokens", "labels"):
        batch += _np_local_bytes((8, 64), shd.P(("pod", "data"), None),
                                 axes, 4)
    batch += _np_local_bytes((8, 64, cfg.d_model),
                             shd.P(("pod", "data"), None, None), axes, 2)
    assert mem["bytes_per_device_batch"] == batch
    assert mem["bytes_per_device_cache"] == 0
    assert mem["bytes_per_device_argument"] == (
        mem["bytes_per_device_params"] + opt + 4 + batch)
    json.dumps(r)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("variant,arch,shape", [
    ("moe_a2a", "olmoe_1b_7b", "train_4k"),
    ("ring_cache", "gemma3_12b", "decode_32k"),
    ("int8_kv", "qwen2_7b", "decode_32k"),
    ("baseline", "zamba2_2_7b", "long_500k")])
def test_variants_lower(variant, arch, shape):
    mesh = make_production_mesh(multi_pod=True)
    base = dryrun.lower_cell(arch, shape, mesh)
    r = dryrun.lower_cell(arch, shape, mesh, variant=variant)
    assert r["variant"] == variant and r["flops"] == base["flops"]
    if variant == "int8_kv":     # int8 rows + float32 scales a (token, head)
        assert r["memory"]["bytes_per_device_cache"] < \
            base["memory"]["bytes_per_device_cache"]
    if variant == "ring_cache":
        assert 0 < r["memory"]["bytes_per_device_cache"] < \
            base["memory"]["bytes_per_device_cache"]


# the variant cells' cache bytes a device, as the dry-run counted them when
# it laid the caches out inline: ring_cache_specs and quant_cache_specs
# give the same layouts
VARIANT_CACHE_BYTES = {
    (False, "ring_cache", "gemma3_12b", "decode_32k"): 3_523_215_364,
    (False, "ring_cache", "gemma3_12b", "long_500k"): 145_489_924,
    (False, "int8_kv", "qwen2_7b", "decode_32k"): 484_442_116,
    (False, "int8_kv", "qwen2_7b", "long_500k"): 60_555_268,
    (True, "ring_cache", "gemma3_12b", "decode_32k"): 1_761_607_684,
    (True, "ring_cache", "gemma3_12b", "long_500k"): 82_575_364,
    (True, "int8_kv", "qwen2_7b", "decode_32k"): 242_221_060,
    (True, "int8_kv", "qwen2_7b", "long_500k"): 30_277_636,
}


@pytest.mark.parametrize("cell", list(VARIANT_CACHE_BYTES), ids=str)
def test_variant_cells_keep_their_cache_bytes(cell):
    """The ``ring_cache`` and ``int8_kv`` cells on both production meshes
    take their layouts from ``sharding.ring_cache_specs`` and
    ``quant_cache_specs``, with the bytes a device of the layouts they
    were written inline with."""
    multi_pod, variant, arch, shape = cell
    r = dryrun.lower_cell(arch, shape,
                          make_production_mesh(multi_pod=multi_pod),
                          variant=variant)
    assert r["memory"]["bytes_per_device_cache"] == VARIANT_CACHE_BYTES[cell]


@pytest.mark.parametrize("variant", ["ring", "int8"])
def test_variant_hint_calls_by_name_equal_the_reference(variant,
                                                        monkeypatch):
    """The hint calls by name of one step of ``grouped_decode_step``
    (gemma3 at one group of 6 layers) and ``decode_step_quant`` (qwen2 at
    one layer), without a policy, equal the reference's (its scans trace
    each body once, where the port loops)."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.models import get_model as ref_get_model
    from repro.models import transformer as ref_tfm
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import transformer as tfm
    from test_torch_mesh_model import (PORT_HINT_MODULES, REF_HINT_MODULES,
                                       _counting)

    arch, layers = (("gemma3_12b", 6) if variant == "ring"
                    else ("qwen2_7b", 1))
    ref_cfg = dataclasses.replace(ref_get_arch(arch).reduced(),
                                  n_layers=layers)
    cfg = dataclasses.replace(get_arch(arch).reduced(), n_layers=layers)
    ref_params = ref_get_model(ref_cfg).init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), ref_params), device="cpu")
    params = jax.tree_util.tree_map(lambda t: t.to(torch.bfloat16), params)
    tokens = np.array([[3], [5]], np.int32)
    counts, same = {}, []
    _counting(monkeypatch, REF_HINT_MODULES, counts, same)
    if variant == "ring":
        ref_tfm.grouped_decode_step(
            ref_cfg, ref_params, ref_tfm.init_grouped_cache(ref_cfg, 2, 32),
            jnp.asarray(tokens))
    else:
        ref_tfm.decode_step_quant(
            ref_cfg, ref_params, ref_tfm.init_quant_cache(ref_cfg, 2, 32),
            jnp.asarray(tokens))
    want = dict(counts)
    counts.clear()
    _counting(monkeypatch, PORT_HINT_MODULES, counts, same)
    if variant == "ring":
        tfm.grouped_decode_step(
            cfg, params, tfm.init_grouped_cache(cfg, 2, 32, device="cpu"),
            torch.as_tensor(tokens))
    else:
        tfm.decode_step_quant(
            cfg, params, tfm.init_quant_cache(cfg, 2, 32, device="cpu"),
            torch.as_tensor(tokens))
    assert counts == want and want
    assert all(same)


def test_cli_writes_both_meshes_and_the_roofline_reads_them(tmp_path,
                                                             capsys):
    assert dryrun.main(["--arch", "qwen2-7b", "--shape", "train_4k",
                        "--both-meshes", "--out", str(tmp_path)]) == 0
    single = json.loads((tmp_path / "dryrun_singlepod.json").read_text())
    multi = json.loads((tmp_path / "dryrun_multipod.json").read_text())
    assert single[0]["mesh"] == {"data": 16, "model": 16}
    assert multi[0]["mesh"] == {"pod": 2, "data": 16, "model": 16}
    out = tmp_path / "roofline.json"
    assert roofline.main(["--dryrun-json",
                          str(tmp_path / "dryrun_singlepod.json"),
                          "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert [r["arch"] for r in rows] == ["qwen2_7b"]
    assert "dom=" in capsys.readouterr().out
