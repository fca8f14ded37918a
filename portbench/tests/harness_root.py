"""A checkout-like root for driving the harness on the CPU at a size a test
holds: a copy of portbench/, BENCHMARK.json with one more cell made of new
files only (a traffic mix, the cell's own file), and the repository's data
and model folders linked in; and the check of the configurations' pins."""

from __future__ import annotations

import json
import pathlib
import shutil
import time

from portbench import manifest

REPO = pathlib.Path(__file__).resolve().parents[2]

# The CPU cells: the tsp100 configuration under tiny mixes of the fixed-budget
# path (whole-search kernel's twin) and of the deadline path (per-move engine).
TINY = {
    "fixed": ("fixed100", "tsp100.fixed100",
              {"request_instances": 2, "n_iters": 3, "batch_size": 2, "warmup_requests": 1},
              {"step": "request", "slice": {"wait": 0, "warmup": 1, "active": 1}}),
    "deadline": ("deadline10s", "tsp100.deadline10s",
                 {"request_instances": 3, "time_limit": 0.5, "warmup_time_limit": 0.2},
                 {"step": "iteration", "slice": {"wait": 0, "warmup": 1, "active": 1}}),
    "train": ("train32", "tsp100.train32", {"request_instances": 2},
              {"step": "request", "slice": {"wait": 0, "warmup": 1, "active": 1}}),
}
LIMITS = {"evaluate": {"pred_err": 1e-4, "own_guide_differ": 1, "init_tours_differ": 0,
                       "search_differ": 0},
          "train": {"loss_gap": 1e-4, "grad_gap": 1e-2, "change_gap": 1e-2}}
TICK = 0.125  # s a reading of the deadline cells' clock: 3 iterations in 0.5 s, 1 in 0.2


def tick_clock(monkeypatch) -> None:
    """Make the per-move engine's clock advance TICK a reading, so that the
    tiny deadline cell runs 3 outer iterations a request (1 in its warm-up)
    however long the initial local search takes on a loaded CPU; the
    harness's own clock stays the host's."""
    from gnngls_tpu_torch.search import batched

    class Clock:
        def __init__(self):
            self.t = float(int(time.time()))  # whole seconds, so each tick adds exactly

        def time(self):
            self.t += TICK
            return self.t

    monkeypatch.setattr(batched, "time", Clock())


def make(tmp: pathlib.Path, kind: str) -> tuple:
    """Build the root under tmp; returns (root, the new cell's name)."""
    base_traffic, base_cell, changes, trace = TINY[kind]
    root = tmp / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for d in ("models", "data"):
        (root / d).symlink_to(REPO / d)
    traffic = json.loads((REPO / "portbench" / "traffic" / f"{base_traffic}.json").read_text())
    traffic.update(changes)
    name = f"tsp100.tiny_{kind}"
    (root / "portbench" / "traffic" / f"tiny_{kind}.json").write_text(json.dumps(traffic))
    if traffic["runner"] == "train":
        check = {"window_requests": traffic["compared_steps"] + 2}
    else:
        check = {"requests": 1, "lanes": traffic["request_instances"], "window_requests": 1,
                 "reference_batch": traffic["request_instances"]}
    check["limits"] = LIMITS[traffic["runner"]]
    (root / "portbench" / "workloads" / f"{name}.json").write_text(
        json.dumps({"check": check, "trace": trace}))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": name, "config": "tsp100", "traffic": f"tiny_{kind}",
                               "chips": 1, "why": "a CPU test's cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if base_cell in m.get("workloads", []):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, name


def pins_broken(root: pathlib.Path) -> list:
    """What breaks a pin in BENCHMARK.json under `root`: a `reduced` that is
    not a list of the configuration file's keys (top level or of its
    "model"), or a width of a runner's PUBLISHED that a configuration run by
    that runner does not keep and does not list under `reduced`."""
    b = json.loads((root / "BENCHMARK.json").read_text())
    runs = {}
    for w in b["workloads"]:
        runs.setdefault(w["config"], set()).add(manifest.load(w["name"], root).traffic["runner"])
    broken = []
    for c in b["configs"]:
        cfg = json.loads((root / c["file"]).read_text())
        model, reduced = cfg.get("model", {}), c["reduced"]
        if not isinstance(reduced, list) or not all(k in cfg or k in model for k in reduced):
            broken.append(f"{c['name']}: reduced {reduced!r} names no key of {c['file']}")
            continue
        for runner in sorted(runs.get(c["name"], ())):
            for key, want in manifest.load_file(root, "runners", runner).PUBLISHED.items():
                if key not in reduced and model.get(key) != want:
                    broken.append(f"{c['name']}: {key} {model.get(key)!r}, "
                                  f"{runner} publishes {want!r}")
    return broken
