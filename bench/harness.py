"""One run of one cell: set-up, the measured window, the metrics, the
judge, and the result line.

Everything a cell is made of is found by name from ``BENCHMARK.json``: its
configuration file, its traffic mix (``bench/traffic/<traffic>.json``),
the driver that mix names (``bench/drivers/<driver>.py``), the reader of
each per-layer metric (``bench/metrics/<metric>.py``), the limits of its
judged numbers (``bench/limits/<workload>.json``) and the plain reference
of its configuration's family (``bench/reference/<family>.py``).  Adding a
cell, a mix or a metric adds files and entries; it edits none.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(text: str) -> None:
    """A progress line on standard error (before the judged numbers)."""
    print(f"bench: {text}", file=sys.stderr, flush=True)


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_file(path: Path, package: str):
    """The module in ``path``, as a module of ``package`` (names with a dot
    or a dash included)."""
    name = package + "." + path.stem.replace(".", "__").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_program():
    """The system under test: the port's configuration class, models and
    step functions."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import get_model
    from repro_torch.models.api import param_shapes

    return SimpleNamespace(ArchConfig=ArchConfig, get_model=get_model,
                           param_shapes=param_shapes,
                           make_prefill_step=make_prefill_step,
                           make_serve_step=make_serve_step)


class Cell:
    """A workload of ``BENCHMARK.json`` (under ``root``) with a seed."""

    def __init__(self, workload: str, seed: int, seconds: float, *,
                 root: Path = ROOT, device: str = "cuda", program=None,
                 arch: dict | None = None, traffic: dict | None = None):
        spec = load_json(root / "BENCHMARK.json")
        found = [w for w in spec["workloads"] if w["name"] == workload]
        if not found:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        self.name, w = workload, found[0]
        self.chips = w["chips"]
        entry = next(c for c in spec["configs"] if c["name"] == w["config"])
        self.config = load_json(root / entry["file"])
        self.family = self.config["family"]
        self.arch = dict(arch or self.config["arch"])
        # the configuration as the reference and the yardstick read it: the
        # program's keys, and the rules it states that the program's own
        # configuration has no key for
        self.stated = {**self.arch, **self.config.get("rules", {})}
        self.traffic = dict(traffic or load_json(
            root / "bench" / "traffic" / f"{w['traffic']}.json"))
        self.limits = load_json(root / "bench" / "limits" / f"{workload}.json")
        self.end_to_end = [m for m in spec["end_to_end"]
                           if applies(m, workload)]
        self.per_layer = [m for m in spec["per_layer"]
                          if applies(m, workload)]
        self.root, self.seed, self.seconds = root, seed, seconds
        self.device = device
        self.program = program or load_program()

    def driver(self):
        return importlib.import_module(
            f"bench.drivers.{self.traffic['driver']}")

    def model_and_weights(self):
        from . import weights
        p = self.program
        t0 = time.monotonic()
        model = p.get_model(p.ArchConfig(**self.arch))
        params = weights.draw(p.param_shapes(model), self.seed, self.device,
                              ssm=self.config.get("init"))
        _sync(self.device)
        log(f"weights drawn in {time.monotonic() - t0:.3f} s")
        return model, params


def _sync(device: str) -> None:
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


def per_layer(cell: Cell, trace, record: dict, kind: str) -> dict:
    """Each per-layer metric of the cell that its reader finds something
    to read for; ``None`` leaves a metric out."""
    peaks = load_json(cell.root / "bench" / "peaks.json").get(kind)
    ctx = SimpleNamespace(trace=trace, record=record, arch=cell.stated,
                          family=cell.family, peaks=peaks, root=cell.root)
    out = {}
    for m in cell.per_layer:
        reader = load_file(cell.root / "bench" / "metrics" / f"{m['name']}.py",
                           "bench.metrics")
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judged(cell: Cell, numbers: dict):
    """``(correct, checks)``: every number the limits name, beside its
    limit; a number missing or not finite is not correct."""
    checks, correct = {}, True
    for name, lim in cell.limits["numbers"].items():
        value = numbers.get(name)
        ok = value is not None and math.isfinite(value) \
            and value <= lim["limit"]
        correct = correct and ok
        checks[name] = {"value": value if ok or value is None
                        or math.isfinite(value) else str(value),
                        "limit": lim["limit"]}
    return correct, checks


def run(cell: Cell, trace: bool, started: float) -> dict:
    """One run; ``started`` is the process's start on the monotonic
    clock, from which ``setup_s`` counts."""
    import torch

    from .tracing import Tracer

    cuda = cell.device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    drv = cell.driver()
    log(f"{cell.name} seed {cell.seed}: set-up from "
        f"{time.monotonic() - started:.3f} s")
    state = drv.setup(cell)
    _sync(cell.device)
    setup_s = time.monotonic() - started
    log(f"window from {setup_s:.3f} s")
    tracer = Tracer(trace, cell.device)
    with tracer:
        record = drv.window(cell, state, tracer)
        _sync(cell.device)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    device = {"platform": "gpu" if cuda else "cpu", "kind": kind,
              "count": cell.chips, "memory_peak_bytes": peak}
    if trace:
        tr = tracer.read()
        tracer.prof = None
        metrics = per_layer(cell, tr, record, kind)
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
    else:
        e2e = dict(drv.end_to_end(record), setup_s=setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    numbers = drv.judge_numbers(cell, state, record)
    log(f"judged in {time.monotonic() - t0:.3f} s")
    correct, checks = judged(cell, numbers)
    result = {"correct": correct, "attempted": record["attempted"],
              "failed": record["failed"], "metrics": metrics,
              "device": device}
    if trace:
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    return result


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark's process may
    not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def check_lines(checks: dict) -> list:
    return [f"check {name}: {c['value']} (limit {c['limit']})"
            for name, c in checks.items()]
