"""What a cell is, found by name: BENCHMARK.json at the root names each cell's
configuration and traffic; the files hold the rest.

  portbench/configs/<config>.json     the configuration (BENCHMARK.json's "file")
  portbench/traffic/<traffic>.json    the traffic mix's parameters and its runner
  portbench/workloads/<cell>.json     the cell's own: its check (sample and
                                      limits) and its trace slice
  portbench/metrics/<metric>.json     a metric: its reader, the reader's
                                      parameters, and unit, source, layer and
                                      moves as BENCHMARK.json gives them
  portbench/readers/<reader>.py       a reader: read(run, **params) -> number or None
  portbench/runners/<runner>.py       a traffic mix's runner (its "runner"): the
                                      Runner, the names its check returns
                                      (LIMITS), the model widths its
                                      configurations keep (PUBLISHED) and its
                                      faults and control (faults)
  portbench/reference/<model>.py      a model's plain reference, which its
                                      runner calls

A cell, configuration, traffic mix or metric is added by adding files and
entries; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys
from typing import Callable, List

ROOT = pathlib.Path(__file__).resolve().parent.parent
AGREE = ("unit", "source", "layer", "moves")  # keys a metric's file repeats


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: Callable  # read(run) -> number or None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    trace: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def load_file(root: pathlib.Path, kind: str, name: str):
    """The module portbench/<kind>/<name>.py under `root`, loaded by its path."""
    path = root / "portbench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _reader(root: pathlib.Path, name: str):
    return load_file(root, "readers", name).read


def metric(root: pathlib.Path, entry: dict) -> Metric:
    """The metric of a BENCHMARK.json entry, with its reader bound to the
    parameters in its file; raises where the file and the entry disagree."""
    spec = _json(root / "portbench" / "metrics" / f"{entry['name']}.json")
    for key in AGREE:
        if key in entry and spec.get(key) != entry[key]:
            raise ValueError(f"metric {entry['name']}: {key} is {entry[key]!r} in "
                             f"BENCHMARK.json and {spec.get(key)!r} in its file")
    fn, params = _reader(root, spec["reader"]), dict(spec.get("params", {}))
    return Metric(entry["name"], entry["unit"],
                  lambda run, fn=fn, params=params: fn(run, **params))


def load(name: str, root: pathlib.Path = ROOT) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _json(root / cfg["file"])
    traffic = _json(root / "portbench" / "traffic" / f"{w['traffic']}.json")
    own = _json(root / "portbench" / "workloads" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in reported else [])]
    return Cell(name, int(w["chips"]), config, traffic, own["check"], own["trace"],
                [metric(root, m) for m in e2e], [metric(root, m) for m in layer])

