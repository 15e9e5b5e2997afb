"""What the benchmark's processes load: never JAX nor the JAX package;
the reference not even the program.  Each check runs in a fresh
interpreter and compares top-level module names whole."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

LOADED = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(body: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", LOADED.format(root=str(ROOT),
                                             src=str(ROOT / "src"),
                                             body=body)],
        capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("body", [
    "import bench.run",
    "from bench import harness; harness.load_program(); "
    "import bench.drivers.prefill, bench.drivers.generate, bench.control",
])
def test_the_run_loads_no_jax(body):
    assert not _top_level(body) & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_neither_jax_nor_the_program():
    mods = _top_level("import bench.reference.judge, bench.reference.moe, "
                      "bench.reference.ssm")
    assert not mods & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_the_checkout_alone_gives_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder:
    no program to import, so no result line and a code other than 0."""
    import shutil

    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "olmoe-1b-7b.prefill-8x1k-4k", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=240,
        env=env, cwd=tmp_path)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_no_card_gives_no_result():
    """Where the cell's CUDA devices are missing (here: none), no result
    line and a code other than 0."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "olmoe-1b-7b.decode-64x4k", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=240,
        env=env, cwd=ROOT)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
    assert "CUDA device" in out.stderr
