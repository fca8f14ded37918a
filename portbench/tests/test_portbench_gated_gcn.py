"""The residual gated GCN's cells: a tiny GCN cell on the CPU, made from new
files alone in the manner of second_arch/ (portbench/tests/gcn_arch/: a
configuration at hidden 16, 3 layers and 4-NN, a traffic mix in two
BatchNorm batches a request, and a cell), run through the harness against the
real runner and reference (portbench/runners/gated_gcn.py,
portbench/reference/gated_gcn.py); its faults and its control; the
span_device reader on slices made by hand; and the repository's two new
cells with their width pins."""

from __future__ import annotations

import json
import shutil
import time
import types

import pytest

from portbench import faults, manifest, roofline, roofline_gated_gcn
from portbench import run as harness
from portbench.tests import harness_root
from portbench.trace import Summary

REPO = harness_root.REPO
GCN_ARCH = REPO / "portbench" / "tests" / "gcn_arch"
NAME, CONFIG, TRAFFIC = "gcn_tiny.gcn_tiny_fixed", "gcn_tiny", "gcn_tiny_fixed"
LIKE = "gcn_tsp100.fixed100"  # the cell whose metrics the tiny cell reports
SEED = 3000000019


def add_gcn_cell(tmp_path):
    """The tiny fixed root with the tiny GCN cell added from new files."""
    root, _ = harness_root.make(tmp_path, "fixed")
    for src in GCN_ARCH.rglob("*"):
        if src.is_file() and "__pycache__" not in src.parts:
            dst = root / "portbench" / src.relative_to(GCN_ARCH)
            assert not dst.exists(), dst
            shutil.copy(src, dst)
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": CONFIG, "source": "https://arxiv.org/abs/1906.01227",
                         "file": f"portbench/configs/{CONFIG}.json",
                         "reduced": ["hidden_dim", "num_layers", "num_neighbors"],
                         "why": "a test's small gated GCN"})
    b["workloads"].append({"name": NAME, "config": CONFIG, "traffic": TRAFFIC, "chips": 1,
                           "why": "a test's cell of the small gated GCN"})
    for m in b["end_to_end"] + b["per_layer"]:
        if LIKE in m.get("workloads", []):
            m["workloads"].append(NAME)
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root


def run_cell(root, capsys, trace=0):
    rc = harness.main(["--workload", NAME, "--seed", str(SEED), "--seconds", "1",
                       "--trace", str(trace)], root=root, device="cpu", t_start=time.time())
    out = capsys.readouterr()
    line = out.out.strip().splitlines()[-1] if out.out.strip() else ""
    return rc, (json.loads(line) if line.startswith("{") else None), out.err


def test_gcn_cell_runs_correct_and_mfu_reads_its_count(tmp_path, capsys, monkeypatch):
    root = add_gcn_cell(tmp_path)
    runs = []

    class Kept(harness.Run):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            runs.append(self)

    monkeypatch.setattr(harness, "Run", Kept)
    rc, res, err = run_cell(root, capsys, trace=1)
    assert rc == 0 and res["correct"], err
    assert set(res["checks"]) == set(manifest.load_file(root, "runners", "gated_gcn").LIMITS)
    # the tiny cell's limit lies between the sound reading (2.9e-6 at this
    # seed) and the control's (1.1e-3)
    assert res["checks"]["pred_err"]["value"] < 1e-5
    (run,) = runs
    own = roofline_gated_gcn.gated_gcn_flops(run.cell.config)
    assert run.model_flops == own and own == 3 * (2 * 16 * 16 * 100 ** 2 + 6 * 16 * 16 * 100) \
        + 2 * 2 * 16 * 16 * 100 ** 2 + 2 * 16 * 2 * 100 ** 2
    want = 100.0 * own * run.instances / (run.window_s * run.peaks["f32_flops"])
    assert res["metrics"]["mfu"]["value"] == want
    # the spans the CPU records; the device's metrics read nothing here
    assert {"gcn_inputs_ms.fixed", "inference_wait_ms.fixed"} <= set(res["metrics"])
    assert not {"gcn_roofline", "gcn_gemm_share"} & set(res["metrics"])
    assert harness_root.pins_broken(root) == []


@pytest.mark.parametrize("fault", ["control_tf32", "half_batch", "unchanged_state",
                                   "altered_answer"])
def test_gcn_cell_fault_is_not_correct(tmp_path, capsys, monkeypatch, fault):
    root = add_gcn_cell(tmp_path)
    cell = manifest.load(NAME, root)
    for mod, name, new in faults.patches(fault, "gated_gcn", cell.config, root,
                                         cell.check["reference_batch"]):
        assert name == "predict_edge_guide" or fault in ("unchanged_state", "altered_answer")
        monkeypatch.setattr(mod, name, new)
    rc, res, err = run_cell(root, capsys)
    assert rc == 0 and res["correct"] is False, err
    checks = res["checks"]
    if fault in ("control_tf32", "half_batch"):
        assert checks["pred_err"]["value"] > checks["pred_err"]["limit"]
    else:
        assert checks["search_differ"]["value"] > 0


def _run(device, host, steps=(0,), instances=4, batch=2):
    cfg = json.loads((GCN_ARCH / "configs" / "gcn_tiny.json").read_text())
    cell = types.SimpleNamespace(config=cfg, traffic={"batch_size": batch})
    reqs = [types.SimpleNamespace(index=i, instances=instances) for i in range(3)]
    return types.SimpleNamespace(
        trace=Summary((0.0, 10.0), list(steps), sorted(device), sorted(host)),
        cell=cell, requests=reqs, peaks=roofline.peaks("H100"))


def _read(run, metric):
    spec = json.loads((REPO / "portbench" / "metrics" / f"{metric}.json").read_text())
    return manifest.load_file(REPO, "readers", spec["reader"]).read(run, **spec["params"])


def test_span_device_reads_the_device_time_inside_predict():
    host = [(1.0, 3.0, "gnngls.predict"), (1.5, 2.0, "gnngls.predict.forward"),
            (5.0, 6.0, "gnngls.search")]
    device = [(0.5, 1.25, "distances_kernel"),  # a quarter inside
              (1.5, 2.0, "sm90_xmma_gemm_f32f32"), (1.75, 2.25, "ampere_sgemm_128x64"),
              (2.5, 2.75, "Memcpy DtoH"), (5.0, 6.0, "gls_whole_kernel")]
    run = _run(device, host)
    # device time inside predict: 0.25 + [1.5, 2.25] + 0.25 = 1.25 s, of it gemm 0.75 s
    assert _read(run, "gcn_gemm_share") == pytest.approx(60.0)
    m = run.cell.config["model"]
    bound = 2 * roofline.bound_s(*roofline_gated_gcn.gated_gcn_work(2, 100, m), run.peaks)
    assert _read(run, "gcn_roofline") == pytest.approx(100.0 * bound / 1.25)


@pytest.mark.parametrize("metric", ["gcn_roofline", "gcn_gemm_share"])
def test_span_device_reads_nothing_without_a_predict_span(metric):
    device = [(1.5, 2.0, "sm90_xmma_gemm_f32f32")]
    assert _read(_run(device, [(1.0, 3.0, "gnngls.search")]), metric) is None
    assert _read(_run([], [(1.0, 3.0, "gnngls.predict")]), metric) is None  # no device time
    run = _run(device, [(1.0, 3.0, "gnngls.predict")])
    run.trace = None
    assert _read(run, metric) is None


def test_the_new_cell_loads_with_its_width_pins(tmp_path):
    cell = manifest.load(LIKE)
    assert cell.traffic["runner"] == "gated_gcn"
    mod = manifest.load_file(REPO, "runners", "gated_gcn")
    assert set(cell.check["limits"]) == set(mod.LIMITS)
    assert all(cell.config["model"][k] == v for k, v in mod.PUBLISHED.items())
    assert manifest.load(LIKE).config["parameters"] == 11_054_402
    assert harness_root.pins_broken(REPO) == []
    # a cut width that BENCHMARK.json does not list under reduced breaks the pin
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    path = root / "portbench" / "configs" / "gcn_tsp100.json"
    cfg = json.loads(path.read_text())
    cfg["model"]["hidden_dim"] = 256
    path.write_text(json.dumps(cfg))
    assert harness_root.pins_broken(root) == [
        "gcn_tsp100: hidden_dim 256, gated_gcn publishes 300"]
