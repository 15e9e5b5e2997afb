"""The port stands alone: no module of ``repro_torch`` nor ``chip_smoke.py``
imports ``jax`` or the JAX package, importing builds nothing, and the entry
points refuse to run without a card unless asked for the CPU."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FILES = sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")) \
    + ["chip_smoke.py"]
BANNED = ("jax", "repro", "jaxlib", "flax", "triton")


def _imports(path):
    for node in ast.walk(ast.parse((ROOT / path).read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, 0
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", node.level


@pytest.mark.parametrize("path", FILES)
def test_no_file_imports_jax_or_the_jax_package(path):
    for name, level in _imports(path):
        if level:                          # relative: stays in the package
            continue
        assert name.split(".")[0] not in BANNED, f"{path} imports {name}"


def _run(code, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_importing_every_module_leaves_jax_and_repro_out():
    code = """
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "triton"))
assert not bad, bad
assert "torch" in sys.modules
from repro_torch.kernels import _build, banked_gather
assert banked_gather._lib is None and not _build._LIBS   # nothing was built
print(len(names))
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 25


@pytest.mark.parametrize("module", ["repro_torch.core.fabric",
                                    "repro_torch.launch.solve_worker",
                                    "repro_torch.launch.serve_fleet",
                                    "repro_torch.optim.adamw",
                                    "repro_torch.data.pipeline",
                                    "repro_torch.ckpt.manager",
                                    "repro_torch.runtime.trainer",
                                    "repro_torch.launch.train",
                                    "repro_torch.parallel",
                                    "repro_torch.parallel.sharding",
                                    "repro_torch.parallel.hints",
                                    "repro_torch.parallel.collectives",
                                    "repro_torch.parallel.pipeline",
                                    "repro_torch.launch.mesh",
                                    "repro_torch.launch.roofline",
                                    "repro_torch.launch.dryrun",
                                    "repro_torch.launch.steps",
                                    "repro_torch.convert",
                                    "repro_torch.models",
                                    "repro_torch.models.api",
                                    "repro_torch.models.layers",
                                    "repro_torch.models.transformer",
                                    "repro_torch.models.moe",
                                    "repro_torch.examples.quickstart",
                                    "repro_torch.examples.serve_lm",
                                    "repro_torch.examples.train_lm",
                                    "repro_torch.examples.banking_explorer"])
def test_fabric_worker_and_fleet_import_without_jax(module):
    """The fabric, its worker, the fleet launcher, the training modules
    (optimizer, data pipeline, checkpoints, trainer, its launcher) and the
    multi-device side (sharding, hints, collectives, pipeline, meshes,
    roofline, dry-run), the step functions, the parameter conversion, the
    models whose layers run tensor-parallel and the twins of
    ``examples/``, each imported alone in a fresh interpreter, bring
    in neither JAX nor the JAX package -- nor ``ml_dtypes``, which the JAX
    package's checkpoints need for bfloat16."""
    code = f"""
import importlib, sys
importlib.import_module({module!r})
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "repro", "triton", "ml_dtypes"))
assert not bad, bad
print("ok")
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_package_exports_only_what_it_holds():
    import repro_torch
    import repro_torch.core as core

    for name in core.__all__:
        assert hasattr(core, name), name
    for plan_plane in ("BankingPlanner", "PlanService", "compile_plan",
                       "lane_compile", "DirectoryStore", "JointTicket",
                       "MeasuredScorer", "Tracer", "TenantRegistry"):
        assert plan_plane in core.__all__, plan_plane
    for fabric in ("SolveFabric", "spawn_local_workers"):
        assert fabric in core.__all__ and hasattr(core, fabric), fabric
    assert repro_torch.__all__ == ["convert", "core", "resolve_device"]
    assert not hasattr(core.transforms, "lower_jnp")
    assert hasattr(core.CompiledBankingPlan, "to_partition_spec")


ENTRY_POINTS = ["Server", "init", "init_cache", "pack", "launch.serve",
                "params_from_numpy", "resolve_device", "make_prefill_step",
                "train", "launch.train"]


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_points_raise_without_a_card_unless_asked_for_cpu(entry,
                                                                tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the default works here")
    from repro_torch import convert, resolve_device
    from repro_torch.configs import get_arch
    from repro_torch.core import MemorySpec, compile_trivial
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import get_model
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch import train as train_launcher
    from repro_torch.runtime.server import Server
    from repro_torch.runtime.trainer import TrainConfig, train

    model = get_model(get_arch("qwen2_7b").reduced())
    ssm = get_model(get_arch("mamba2_370m").reduced())
    art = compile_trivial(MemorySpec("m", dims=(8,), word_bits=16, ports=1))
    gen = torch.Generator(device="cpu").manual_seed(0)
    calls = {
        "Server": lambda **kw: Server(model, max_batch=1, max_len=8, **kw),
        "init": lambda **kw: model.init(gen, **kw),
        "init_cache": lambda **kw: model.init_cache(1, 8, **kw),
        "pack": lambda **kw: art.pack(np.zeros((8, 2), np.float32), **kw),
        "launch.serve": lambda **kw: serve.main(
            ["--arch", "qwen2-7b", "--smoke", "--requests", "1", "--max-new",
             "1"] + (["--device", kw["device"]] if kw else [])),
        "params_from_numpy": lambda **kw: convert.params_from_numpy(
            {"w": np.zeros(2, np.float32)}, **kw),
        "resolve_device": lambda **kw: resolve_device(**kw),
        # the prefill runs where the parameters are; numpy tokens follow
        "make_prefill_step": lambda **kw: make_prefill_step(ssm, 8)(
            ssm.init(gen, **kw), {"tokens": np.full((1, 4), 3, np.int32)}),
        "train": lambda **kw: train(
            ssm, DataConfig(vocab=ssm.cfg.vocab, seq_len=8, global_batch=1),
            TrainConfig(total_steps=1, ckpt_dir=str(tmp_path / "t")), **kw),
        "launch.train": lambda **kw: train_launcher.main(
            ["--arch", "mamba2-370m", "--smoke", "--steps", "1", "--seq",
             "8", "--batch", "1", "--ckpt-dir", str(tmp_path / "l")]
            + (["--device", kw["device"]] if kw else [])) == 0,
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    assert calls[entry](device="cpu") is not None


def test_a_cuda_table_never_reaches_the_plain_version(monkeypatch):
    """The wrappers pick the plain version only by ``table.is_cuda``: with
    that forced on, a CPU-only machine must fail in the kernel build, not
    quietly answer from the plain version."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA toolchain")
    from repro_torch.core import MemorySpec, compile_trivial
    from repro_torch.kernels import banked_gather as bg
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_chunk as sc

    art = compile_trivial(MemorySpec("m", dims=(8,), word_bits=16, ports=1))
    table = art.pack(np.zeros((8, 2), np.float32), device="cpu")

    class OnCard(torch.Tensor):
        is_cuda = True

    fake = table.as_subclass(OnCard)
    for mod, plain in ((bg, "banked_gather_plain"),
                       (bg, "banked_scatter_plain"),
                       (bg, "banked_scatter_elems_plain"),
                       (md, "moe_dispatch_plain"),
                       (sc, "ssd_chunk_plain"), (fa, "mha_plain"),
                       (fa, "flash_attention_plain")):
        monkeypatch.setattr(mod, plain, lambda *a, **k: pytest.fail(
            "plain version reached for a CUDA table"))
    idx = torch.zeros(1, dtype=torch.int32)
    monkeypatch.setattr(bg, "as_index", lambda *a, **k: idx)
    monkeypatch.setattr(bg, "_as_values", lambda v, *a, **k: v)
    tokens = torch.zeros((3, 2)).as_subclass(OnCard)
    heads = [torch.zeros(s).as_subclass(OnCard) for s in
             ((1, 4, 2, 8), (1, 4, 1, 8), (1, 4, 1, 8))]
    chunk = [torch.zeros(s).as_subclass(OnCard) for s in
             ((1, 2, 4, 8), (1, 2, 4), (1, 4, 16), (1, 4, 16), (1, 2, 4),
              (1, 2, 8, 16))]
    for call in (lambda: bg.banked_gather(fake, idx, art),
                 lambda: bg.banked_scatter(fake, idx, torch.zeros(1, 2), art),
                 lambda: bg.banked_scatter_elems(fake, idx, idx,
                                                 torch.zeros(1), art),
                 lambda: md.moe_dispatch(tokens, idx),
                 lambda: ops.dispatch(tokens, idx),
                 lambda: sc.ssd_chunk(*chunk),
                 lambda: ops.ssd(*chunk),
                 lambda: ops.mha(*heads),
                 lambda: fa.flash_attention(*(t[:, :, 0] for t in heads))):
        with pytest.raises((RuntimeError, OSError)):
            call()
    assert sum(bg.LAUNCHES.values()) == 0 and md.LAUNCHES["moe_dispatch"] == 0
    assert sc.LAUNCHES["ssd_chunk"] == 0
    assert fa.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("edit", ["header", "new header", "source"])
def test_an_edited_header_renames_the_library(tmp_path, monkeypatch, edit):
    """A library is named by a hash of its source and of every header
    under ``csrc/``, so an edited header is never served by a stale build
    (nothing is compiled here: only the name is computed)."""
    from repro_torch.kernels import _build

    (tmp_path / "flash_attention.cu").write_text('#include "sm90.cuh"\n')
    (tmp_path / "sm90.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._lib_path("flash_attention")
    assert _build._lib_path("flash_attention") == first
    if edit == "header":
        (tmp_path / "sm90.cuh").write_text("// two\n")
    elif edit == "new header":
        (tmp_path / "more.cuh").write_text("// more\n")
    else:
        (tmp_path / "flash_attention.cu").write_text("// edited\n")
    assert _build._lib_path("flash_attention") != first
    assert first.parent == _build.build_dir()


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card_and_without_the_package(
        tmp_path, where):
    if where == "checkout" and torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cwd = ROOT
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and res.stdout.strip() == ""
    assert "FAILED" in res.stderr
