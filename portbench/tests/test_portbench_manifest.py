"""BENCHMARK.json against the rules a benchmark file keeps, and the harness finding a
new cell, configuration, traffic mix and metric from new files alone."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench import manifest
from portbench.tests import harness_root

REPO = harness_root.REPO
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys_and_limits():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"][:3] == ["python3", "-m", "portbench.run"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    # a full check of 24 cells fits in its 43,200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_texts():
    b = bench()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in b[group]]
        assert len(names) == len(set(names))
        for e in b[group]:
            assert NAME.match(e["name"]), e["name"]
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_cells_and_metrics_agree():
    b = bench()
    cells = {w["name"]: w for w in b["workloads"]}
    configs = {c["name"] for c in b["configs"]}
    assert {w["config"] for w in cells.values()} == configs
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    assert all(w["chips"] == 1 for w in cells.values())
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for name in cells:
        reports = {k for k, m in e2e.items() if name in m.get("workloads", cells)}
        assert "setup_s" in reports and len(reports) >= 2, name
        layer = [m for m in b["per_layer"] if name in m["workloads"]]
        assert layer and all(m["moves"] in reports for m in layer), name
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in b["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert len(layers) >= 5


def test_every_cell_loads_and_its_files_agree():
    for name in (w["name"] for w in bench()["workloads"]):
        cell = manifest.load(name)
        assert cell.end_to_end and cell.per_layer
        runner = manifest.load_file(REPO, "runners", cell.traffic["runner"])
        assert set(cell.check["limits"]) == set(runner.LIMITS), name
    for c in bench()["configs"]:
        assert c["file"].startswith("portbench/")
    assert harness_root.pins_broken(REPO) == []


def test_a_metric_file_that_disagrees_is_refused(tmp_path):
    root, _ = harness_root.make(tmp_path, "fixed")
    p = root / "portbench" / "metrics" / "instances_per_s.json"
    spec = json.loads(p.read_text())
    spec["unit"] = "inst/min"
    p.write_text(json.dumps(spec))
    with pytest.raises(ValueError, match="unit"):
        manifest.load("tsp100.fixed100", root)


def test_new_cell_config_traffic_and_metric_come_from_new_files_only(tmp_path):
    root, name = harness_root.make(tmp_path, "fixed")
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "portbench").rglob("*") if p.is_file()}
    pb = root / "portbench"
    # a new configuration: the same model on another instance source
    cfg = json.loads((pb / "configs" / "tsp100.json").read_text())
    cfg["instances"] = {"kind": "uniform", "n": 50}
    (pb / "configs" / "uniform50.json").write_text(json.dumps(cfg))
    # a new traffic mix and the new cell's own file
    shutil.copy(pb / "traffic" / "tiny_fixed.json", pb / "traffic" / "tiny_again.json")
    shutil.copy(pb / "workloads" / f"{name}.json", pb / "workloads" / "uniform50.tiny_again.json")
    # a new per-layer metric with a reader of its own
    (pb / "readers" / "first_latency.py").write_text(
        "def read(run, scale):\n    return scale * (run.requests[0].end - run.requests[0].start)\n")
    (pb / "metrics" / "first_latency_ms.json").write_text(json.dumps(
        {"reader": "first_latency", "params": {"scale": 1e3}, "unit": "ms",
         "source": "host_clock", "layer": "entry", "moves": "instances_per_s"}))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "uniform50", "source": "https://arxiv.org/abs/2110.05291",
                         "file": "portbench/configs/uniform50.json", "reduced": [],
                         "why": "a test's configuration"})
    b["workloads"].append({"name": "uniform50.tiny_again", "config": "uniform50",
                           "traffic": "tiny_again", "chips": 1, "why": "a test's cell"})
    b["end_to_end"][1]["workloads"].append("uniform50.tiny_again")
    b["per_layer"].append({"name": "first_latency_ms", "unit": "ms", "better": "lower",
                           "source": "host_clock", "layer": "entry",
                           "moves": "instances_per_s", "workloads": ["uniform50.tiny_again"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = manifest.load("uniform50.tiny_again", root)
    assert cell.config["instances"]["n"] == 50 and cell.traffic["request_instances"] == 2
    assert [m.name for m in cell.per_layer] == ["first_latency_ms"]
    assert {m.name for m in cell.end_to_end} == {"setup_s", "instances_per_s"}
    import types
    run = types.SimpleNamespace(requests=[types.SimpleNamespace(start=1.0, end=1.25)])
    assert cell.per_layer[0].read(run) == pytest.approx(250.0)
    after = {p.relative_to(root): p.read_bytes()
             for p in (root / "portbench").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())  # no file that was there changed
