"""``BENCHMARK.json`` against the rules its readers hold it to, and every
file it names by a name present."""

from __future__ import annotations

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_entries():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert "bench" in SPEC["paths"] and len(SPEC["paths"]) <= 16
    assert all(_one_line(w) for w in SPEC["command"])
    assert 1 <= SPEC["run_seconds"] <= 51
    for kind, keys in ENTRY_KEYS.items():
        names = [e["name"] for e in SPEC[kind]]
        assert len(names) == len(set(names))
        for e in SPEC[kind]:
            assert set(e) - {"workloads"} == keys, e["name"]
            assert NAME.match(e["name"]), e["name"]
            for k in ("why", "layer") + (("source",) if kind == "configs"
                                          else ()):
                if k in e:
                    assert _one_line(e[k]), (e["name"], k)
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                                 "higher")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_files_named_by_the_entries_exist():
    bench = ROOT / "bench"
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("bench/") and cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert (bench / "reference" / f"{cfg['family']}.py").exists()
        assert (bench / "flops" / f"{cfg['family']}.py").exists()
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4)
        mix = json.loads((bench / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        assert (bench / "drivers" / f"{mix['driver']}.py").exists()
        limits = json.loads((bench / "limits" / f"{w['name']}.json")
                            .read_text())["numbers"]
        for name, lim in limits.items():       # set between two readings
            assert lim["lower"] < lim["limit"] < lim["upper"], name
            assert lim["upper"] >= 3 * lim["lower"], name
    for m in SPEC["per_layer"]:
        assert (bench / "metrics" / f"{m['name']}.py").exists()


def test_every_cell_reports_what_its_metrics_move():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        e2e["setup_s"]
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in SPEC["workloads"]}
    for cell in cells:
        reported = {n for n, m in e2e.items()
                    if cell in m.get("workloads", cells)}
        assert "setup_s" in reported and len(reported) >= 2, cell
        assert any(cell in m["workloads"] for m in SPEC["per_layer"]), cell
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved["workloads"]), m["name"]
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
