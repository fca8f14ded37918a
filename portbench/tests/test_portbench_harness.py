"""The harness driven end to end on the CPU (the look for a card skipped), at a
size a test holds: a sound run comes out correct; the control (the
reference's TF32 arithmetic in the program's place) and each fault a cell can
have, planted under the timed path, come out not correct.  The fault "the
exchange between chips left out" has no place here: every cell runs on one
chip."""

from __future__ import annotations

import json
import sys
import time

import pytest
import torch

from portbench import faults
from portbench import run as harness
from portbench.tests import harness_root


@pytest.fixture
def tick_clock(monkeypatch):
    harness_root.tick_clock(monkeypatch)


def run_cell(tmp_path, capsys, kind, trace=0, seconds=1.0):
    """Run a tiny cell of `kind` once; (exit code, result line or None, stderr)."""
    root, name = harness_root.make(tmp_path, kind)
    rc = harness.main(["--workload", name, "--seed", "3000000019", "--seconds", str(seconds),
                       "--trace", str(trace)], root=root, device="cpu", t_start=time.time())
    out = capsys.readouterr()
    line = out.out.strip().splitlines()[-1] if out.out.strip() else ""
    return rc, (json.loads(line) if line.startswith("{") else None), out.err


def plant(monkeypatch, fault, runner):
    config = json.loads((harness_root.REPO / "portbench/configs/tsp100.json").read_text())
    for mod, name, new in faults.patches(fault, runner, config):
        monkeypatch.setattr(mod, name, new)


def test_sound_run_is_correct(tmp_path, capsys):
    rc, res, err = run_cell(tmp_path, capsys, "fixed")
    assert rc == 0 and res["correct"], err
    assert set(res["metrics"]) == {"setup_s", "instances_per_s", "solve_p95_s"}
    assert list(res)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check search_differ")


def test_traced_run_reports_the_cells_per_layer_metrics(tmp_path, capsys):
    rc, res, err = run_cell(tmp_path, capsys, "fixed", trace=1)
    assert rc == 0 and res["correct"], err
    # what the CPU can read: spans and counters, not the device
    assert {"dataset_ms.fixed", "host_ms.fixed", "inference_ms.fixed",
            "search_ms.fixed", "mfu"} <= set(res["metrics"])
    assert "busy_s" in res["device"] and "window_s" in res["device"]


@pytest.mark.usefixtures("tick_clock")
def test_deadline_cell_is_correct(tmp_path, capsys):
    rc, res, err = run_cell(tmp_path, capsys, "deadline")
    assert rc == 0 and res["correct"], err
    assert set(res["metrics"]) == {"setup_s", "gap_pct"}


@pytest.mark.parametrize("fault", ["control_tf32", "half_batch", "unchanged_state",
                                   "altered_answer"])
def test_fixed_cell_fault_is_not_correct(tmp_path, capsys, monkeypatch, fault):
    plant(monkeypatch, fault, "evaluate")
    rc, res, err = run_cell(tmp_path, capsys, "fixed")
    assert rc == 0 and res["correct"] is False, err


@pytest.mark.usefixtures("tick_clock")
def test_deadline_cell_unchanged_iterations_are_not_correct(tmp_path, capsys, monkeypatch):
    plant(monkeypatch, "unchanged_state", "evaluate")
    rc, res, err = run_cell(tmp_path, capsys, "deadline")
    assert rc == 0 and res["correct"] is False, err
    assert res["checks"]["search_differ"]["value"] > 0


def test_traced_slice_that_records_no_step_ends_the_run(tmp_path, capsys):
    # a fixed-budget cell traced by the per-move engine's iterations, of which
    # it runs none: the slice never steps, and the run says so
    root, name = harness_root.make(tmp_path, "fixed")
    own = root / "portbench" / "workloads" / f"{name}.json"
    spec = json.loads(own.read_text())
    spec["trace"]["step"] = "iteration"
    own.write_text(json.dumps(spec))
    rc = harness.main(["--workload", name, "--seed", "3000000019", "--seconds", "1",
                       "--trace", "1"], root=root, device="cpu", t_start=time.time())
    out = capsys.readouterr()
    assert rc != 0 and not out.out.strip() and "recorded no step" in out.err


def test_jax_loaded_after_the_window_ends_the_run(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    rc, res, err = run_cell(tmp_path, capsys, "fixed")
    assert rc != 0 and res is None and "jax" in err


def test_no_card_means_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = harness.main(["--workload", "tsp100.fixed100", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and not out.out.strip() and "CUDA" in out.err


def test_train_cell_is_correct(tmp_path, capsys):
    rc, res, err = run_cell(tmp_path, capsys, "train")
    assert rc == 0 and res["correct"], err
    assert set(res["metrics"]) == {"setup_s", "train_instances_per_s"}
    assert res["sample"]["last_steps"][0] >= 3  # the last steps lie past the start


@pytest.mark.parametrize("fault", ["control_tf32", "half_batch", "unchanged_state"])
def test_train_cell_fault_is_not_correct(tmp_path, capsys, monkeypatch, fault):
    if fault != "control_tf32":
        plant(monkeypatch, fault, "train")
    else:  # the reference's TF32 arithmetic in the program's place
        root, name = harness_root.make(tmp_path, "train")
        from portbench import manifest

        drv = manifest.load_file(root, "runners", "train").Runner(
            root, manifest.load(name, root), 3000000019, "cpu")
        got = drv.control(3000000019, "tf32")
        limits = manifest.load(name, root).check["limits"]
        assert any(got[k] > limits[k] for k in limits), got
        return
    rc, res, err = run_cell(tmp_path, capsys, "train")
    assert rc == 0 and res["correct"] is False, err


def test_train_fault_that_sets_in_after_the_start_is_not_correct(tmp_path, capsys,
                                                                  monkeypatch):
    # sound through the warm-up and the window's first three steps, then
    # steps on half of the batch: only the window's last steps can show it
    from gnngls_tpu_torch.train import step

    real, calls = step.train_step, []

    def late(model, opt, x, y, **kw):
        calls.append(1)
        if len(calls) > 4:
            x, y = x[:len(x) // 2], y[:len(y) // 2]
        return real(model, opt, x, y, **kw)

    monkeypatch.setattr(step, "train_step", late)
    rc, res, err = run_cell(tmp_path, capsys, "train")
    assert rc == 0 and res["correct"] is False, err
    assert res["sample"]["last"]["loss_gap"] > res["sample"]["start"]["loss_gap"]
