"""A second model architecture enters the benchmark from new files alone.

The stand-in (portbench/tests/second_arch/, laid out as portbench/ is) is
the program's `RegretGNN` at embed 32, FFN 64 and 4 heads with weights drawn
from a seed: a runner that subclasses the evaluate runner and declares its
own LIMITS, PUBLISHED, faults and FLOP count, a reference of its own, a
configuration, a traffic mix and a cell.  They are copied into a
checkout-like root beside the tiny cells, and BENCHMARK.json gains the
configuration, the cell, and the cell's name in the metrics' `workloads`
lists; nothing else changes."""

from __future__ import annotations

import json
import shutil
import time

import pytest

from portbench import faults, manifest, roofline
from portbench import run as harness
from portbench.tests import harness_root

SECOND = harness_root.REPO / "portbench" / "tests" / "second_arch"
NAME, CONFIG, TRAFFIC = "small_gat.small_fixed", "small_gat", "small_fixed"
LIKE = "tsp100.fixed100"  # the cell whose metrics the new cell reports
SEED = 3000000019


def snapshot(root):
    return {p.relative_to(root): p.read_bytes()
            for p in (root / "portbench").rglob("*") if p.is_file()}


def add_second_arch(tmp_path):
    """The tiny fixed root with the stand-in added; (root, the files and
    BENCHMARK.json before it was added)."""
    root, _ = harness_root.make(tmp_path, "fixed")
    before = snapshot(root), json.loads((root / "BENCHMARK.json").read_text())
    for src in SECOND.rglob("*"):
        if src.is_file() and "__pycache__" not in src.parts:
            dst = root / "portbench" / src.relative_to(SECOND)
            assert not dst.exists(), dst
            shutil.copy(src, dst)
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": CONFIG, "source": "https://arxiv.org/abs/2110.05291",
                         "file": f"portbench/configs/{CONFIG}.json", "reduced": [],
                         "why": "a test's stand-in second model"})
    b["workloads"].append({"name": NAME, "config": CONFIG, "traffic": TRAFFIC, "chips": 1,
                           "why": "a test's cell of the stand-in second model"})
    for m in b["end_to_end"] + b["per_layer"]:
        if LIKE in m.get("workloads", []):
            m["workloads"].append(NAME)
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root, before


def only_added(root, before) -> bool:
    """No file that was there changed, and BENCHMARK.json only gained the
    stand-in's entries and its cell's name in `workloads` lists."""
    files, bench = before
    after = snapshot(root)
    if any(after[k] != v for k, v in files.items()):
        return False
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"] = [c for c in b["configs"] if c["name"] != CONFIG]
    b["workloads"] = [w for w in b["workloads"] if w["name"] != NAME]
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w != NAME]
    return b == bench


def run_cell(root, capsys, trace=0):
    rc = harness.main(["--workload", NAME, "--seed", str(SEED), "--seconds", "1",
                       "--trace", str(trace)], root=root, device="cpu", t_start=time.time())
    out = capsys.readouterr()
    line = out.out.strip().splitlines()[-1] if out.out.strip() else ""
    return rc, (json.loads(line) if line.startswith("{") else None), out.err


def test_second_arch_runs_correct_and_mfu_reads_its_own_count(tmp_path, capsys, monkeypatch):
    root, before = add_second_arch(tmp_path)
    runs = []

    class Kept(harness.Run):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            runs.append(self)

    monkeypatch.setattr(harness, "Run", Kept)
    rc, res, err = run_cell(root, capsys, trace=1)
    assert rc == 0 and res["correct"], err
    assert set(res["checks"]) == set(manifest.load_file(root, "runners", "small_gat").LIMITS)
    (run,) = runs
    m = run.cell.config["model"]
    own = roofline.model_flops_per_instance(100, 32, 64, m["n_heads"], 1)
    assert run.model_flops == own and own < 1e9  # the GAT's count is 1.170e10
    want = 100.0 * own * run.instances / (run.window_s * run.peaks["f32_flops"])
    assert res["metrics"]["mfu"]["value"] == want
    assert only_added(root, before)
    assert harness_root.pins_broken(root) == []


def test_second_arch_control_plants_its_own_reference(tmp_path, capsys, monkeypatch):
    root, before = add_second_arch(tmp_path)
    cell = manifest.load(NAME, root)
    triples = faults.patches("control_tf32", "small_gat", cell.config, root,
                             cell.check["reference_batch"])
    for mod, name, new in triples:
        assert new.__module__ == "portbench_runners_small_gat"  # not the GAT's control
        monkeypatch.setattr(mod, name, new)
    rc, res, err = run_cell(root, capsys)
    assert rc == 0 and res["correct"] is False, err
    assert res["checks"]["pred_err"]["value"] > res["checks"]["pred_err"]["limit"]
    assert only_added(root, before)


@pytest.mark.parametrize("reduced, broken", [([], True), (["embed_dim"], False),
                                             (["no_such_key"], True)])
def test_a_configuration_that_breaks_its_width_pin_fails(tmp_path, reduced, broken):
    root, _ = add_second_arch(tmp_path)
    path = root / "portbench" / "configs" / f"{CONFIG}.json"
    cfg = json.loads(path.read_text())
    cfg["model"]["embed_dim"] = 48
    path.write_text(json.dumps(cfg))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"][-1]["reduced"] = reduced
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    found = harness_root.pins_broken(root)
    assert bool(found) is broken, found
    if broken and not reduced:
        assert found == ["small_gat: embed_dim 48, small_gat publishes 32"]
