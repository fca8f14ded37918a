"""DIFUSCO's cells: a tiny DIFUSCO cell on the CPU, made from new files alone
in the manner of gcn_arch/ (portbench/tests/difusco_arch/: a configuration
at hidden 32, 2 layers, 5-NN edges and 4 denoising steps, a traffic mix of
one batch of 2 a request, and a cell), run through the harness against the
real runner and reference (portbench/runners/difusco.py,
portbench/reference/difusco.py); its faults and its control; the span_work
reader on slices made by hand; and the repository's new cell with its width
pins."""

from __future__ import annotations

import json
import shutil
import time
import types

import numpy as np
import pytest

from portbench import faults, manifest, roofline, roofline_difusco
from portbench import run as harness
from portbench.tests import harness_root
from portbench.trace import Summary

REPO = harness_root.REPO
ARCH = REPO / "portbench" / "tests" / "difusco_arch"
NAME, CONFIG, TRAFFIC = "difusco_tiny.difusco_tiny_fixed", "difusco_tiny", "difusco_tiny_fixed"
LIKE = "difusco_tsp500.fixed40"  # the cell whose metrics the tiny cell reports
SEED = 3000000019


def add_difusco_cell(tmp_path):
    """The tiny fixed root with the tiny DIFUSCO cell added from new files."""
    root, _ = harness_root.make(tmp_path, "fixed")
    for src in ARCH.rglob("*"):
        if src.is_file() and "__pycache__" not in src.parts:
            dst = root / "portbench" / src.relative_to(ARCH)
            assert not dst.exists(), dst
            shutil.copy(src, dst)
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": CONFIG, "source": "https://arxiv.org/abs/2302.08224",
                         "file": f"portbench/configs/{CONFIG}.json",
                         "reduced": ["hidden_dim", "num_layers", "sparse_factor",
                                     "inference_steps"],
                         "why": "a test's small DIFUSCO denoiser"})
    b["workloads"].append({"name": NAME, "config": CONFIG, "traffic": TRAFFIC, "chips": 1,
                           "why": "a test's cell of the small DIFUSCO denoiser"})
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


def test_difusco_cell_runs_correct_and_mfu_reads_its_count(tmp_path, capsys, monkeypatch):
    root = add_difusco_cell(tmp_path)
    runs = []

    class Kept(harness.Run):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            runs.append(self)

    monkeypatch.setattr(harness, "Run", Kept)
    rc, res, err = run_cell(root, capsys, trace=1)
    assert rc == 0 and res["correct"], err
    assert set(res["checks"]) == set(manifest.load_file(root, "runners", "difusco").LIMITS)
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert checks["step_err"] < 1e-5 and checks["pred_err"] < 1e-5
    assert checks["draws_differ"] == 0
    (run,) = runs
    own = roofline_difusco.difusco_flops(run.cell.config)
    E, H = 30 * 5, 32
    assert run.model_flops == own and own == 4 * (
        2 * (2 * 2 * E * H * H + 4 * 2 * 30 * H * H) + 2 * 30 * H * H + 2 * E * H * 2)
    want = 100.0 * own * run.instances / (run.window_s * run.peaks["f32_flops"])
    assert res["metrics"]["mfu"]["value"] == want
    # the spans the CPU records; the device's metrics read nothing here
    assert {"difusco_inputs_ms.fixed", "inference_wait_ms.fixed"} <= set(res["metrics"])
    assert not {"difusco_roofline", "difusco_gemm_share"} & set(res["metrics"])
    assert harness_root.pins_broken(root) == []


@pytest.mark.parametrize("fault", ["control_tf32", "half_batch", "one_step", "unchanged_state",
                                   "altered_answer"])
def test_difusco_cell_fault_is_not_correct(tmp_path, capsys, monkeypatch, fault):
    root = add_difusco_cell(tmp_path)
    cell = manifest.load(NAME, root)
    for mod, name, new in faults.patches(fault, "difusco", cell.config, root,
                                         cell.check["reference_batch"]):
        monkeypatch.setattr(mod, name, new)
    rc, res, err = run_cell(root, capsys)
    assert rc == 0 and res["correct"] is False, err
    checks = {k: v["value"] for k, v in res["checks"].items()}
    if fault in ("control_tf32", "half_batch", "one_step"):
        assert checks["step_err"] > 1e-4
    if fault in ("half_batch", "one_step"):  # no trajectory to follow
        assert checks["step_err"] == 1.0 and checks["draws_differ"] > 0
        assert checks["pred_err"] > 1e-4
    if fault in ("unchanged_state", "altered_answer"):
        assert checks["search_differ"] > 0


def _run(device, host, steps=(0,), instances=8, batch=8):
    cfg = json.loads((REPO / "portbench" / "configs" / "difusco_tsp500.json").read_text())
    cell = types.SimpleNamespace(config=cfg, traffic={"batch_size": batch})
    reqs = [types.SimpleNamespace(index=i, instances=instances) for i in range(3)]
    return types.SimpleNamespace(
        trace=Summary((0.0, 10.0), list(steps), sorted(device), sorted(host)),
        cell=cell, requests=reqs, peaks=roofline.peaks("H100"))


def _read(run, metric):
    spec = json.loads((REPO / "portbench" / "metrics" / f"{metric}.json").read_text())
    return manifest.load_file(REPO, "readers", spec["reader"]).read(run, **spec["params"])


def test_span_work_reads_the_bound_of_the_batches_over_their_device_time():
    host = [(1.0, 3.0, "gnngls.predict"), (1.5, 2.0, "gnngls.predict.forward"),
            (5.0, 6.0, "gnngls.search")]
    device = [(0.5, 1.25, "distances_kernel"),  # a quarter inside
              (1.5, 2.0, "sm90_xmma_gemm_f32f32"), (1.75, 2.25, "ampere_sgemm_128x64"),
              (2.5, 2.75, "Memcpy DtoH"), (5.0, 6.0, "gls_whole_kernel")]
    run = _run(device, host, instances=12)  # batches of 8 and 4
    m = run.cell.config["model"]
    bound = sum(roofline.bound_s(*roofline_difusco.difusco_work(B, 500, m), run.peaks)
                for B in (8, 4))
    assert _read(run, "difusco_roofline") == pytest.approx(100.0 * bound / 1.25)
    assert _read(run, "difusco_gemm_share") == pytest.approx(60.0)
    ops, nbytes = roofline_difusco.difusco_work(8, 500, m)
    assert ops == 8 * roofline_difusco.difusco_flops(run.cell.config)
    assert ops / run.peaks["f32_flops"] > nbytes / run.peaks["hbm_bytes_per_s"]


@pytest.mark.parametrize("metric", ["difusco_roofline", "difusco_gemm_share"])
def test_span_work_reads_nothing_without_a_predict_span(metric):
    device = [(1.5, 2.0, "sm90_xmma_gemm_f32f32")]
    assert _read(_run(device, [(1.0, 3.0, "gnngls.search")]), metric) is None
    assert _read(_run([], [(1.0, 3.0, "gnngls.predict")]), metric) is None  # no device time
    run = _run(device, [(1.0, 3.0, "gnngls.predict")])
    run.trace = None
    assert _read(run, metric) is None


def test_the_new_cell_loads_with_its_width_pins(tmp_path):
    from portbench.reference import difusco as ref

    cell = manifest.load(LIKE)
    assert cell.traffic["runner"] == "difusco" and cell.chips == 1
    mod = manifest.load_file(REPO, "runners", "difusco")
    assert set(cell.check["limits"]) == set(mod.LIMITS)
    assert all(cell.config["model"][k] == v for k, v in mod.PUBLISHED.items())
    m = cell.config["model"]
    assert cell.config["parameters"] == 5_333_762 == roofline_difusco.weights(m) == sum(
        int(np.prod(s)) for s in ref.param_shapes(m).values())
    assert {x.name for x in cell.end_to_end} == {"setup_s", "instances_per_s"}
    assert {"difusco_roofline", "difusco_gemm_share", "difusco_inputs_ms.fixed", "mfu",
            "idle.fixed"} <= {x.name for x in cell.per_layer}
    assert harness_root.pins_broken(REPO) == []
    # a cut width that BENCHMARK.json does not list under reduced breaks the pin
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    path = root / "portbench" / "configs" / "difusco_tsp500.json"
    cfg = json.loads(path.read_text())
    cfg["model"]["inference_steps"] = 10
    path.write_text(json.dumps(cfg))
    assert harness_root.pins_broken(root) == [
        "difusco_tsp500: inference_steps 10, difusco publishes 50"]
