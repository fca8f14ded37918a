"""The readers of the program's spans and round counter: their arithmetic
on a synthetic slice with nested spans, nothing from a program without them,
and every one of them in a traced CPU run of the tiny fixed and deadline
cells."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest

from portbench import run as harness
from portbench.tests import harness_root
from portbench.tests.test_portbench_metrics import Req, fake_run, read
from portbench.trace import Summary

SPANS = ["data_span_ms.fixed", "entry_span_ms.fixed", "inference_host_ms.fixed",
         "inference_wait_ms.fixed", "search_host_ms.fixed"]
COUNTERS = ["rounds_per_iter.deadline", "lockstep_useful.deadline"]


def request_spans(t, dataset, evaluate, predict, fetch, search, kernel):
    """A request's spans from t on, nested as the program nests them."""
    out = [(t, t + dataset, "gnngls.dataset"), (t, t + dataset / 2, "gnngls.dataset.features")]
    t += dataset
    out.append((t, t + evaluate, "gnngls.evaluate"))
    out += [(t + 0.001, t + 0.001 + predict, "gnngls.predict"),
            (t + 0.002, t + 0.002 + fetch, "gnngls.predict.fetch")]
    s = t + 0.001 + predict + 0.001
    out += [(s, s + search, "gnngls.search"), (s + 0.001, s + 0.001 + kernel,
                                                "gnngls.search.kernel")]
    return out


def test_span_readers_on_nested_spans():
    host = [(0.0, 1.0, "ProfilerStep#4"), (1.0, 2.0, "ProfilerStep#5")]
    host += request_spans(0.0, 0.1, 0.8, 0.3, 0.2, 0.2, 0.05)
    host += request_spans(1.0, 0.12, 0.8, 0.3, 0.1, 0.3, 0.15)
    host += request_spans(2.5, 0.1, 0.1, 0.05, 0.01, 0.02, 0.01)  # past the window
    s = Summary((0.0, 2.0), [4, 5], [], sorted(host))
    reqs = [Req(i, float(i), i + 1.0, 64 if i in (4, 5) else 1) for i in range(8)]
    run = fake_run(reqs, (0.0, 8.0), trace=s)
    per = 1e3 / 128
    assert read("data_span_ms.fixed", run) == pytest.approx((0.1 + 0.12) * per)
    assert read("entry_span_ms.fixed", run) == pytest.approx(
        (0.8 + 0.8 - 0.3 - 0.3 - 0.2 - 0.3) * per)
    assert read("inference_host_ms.fixed", run) == pytest.approx((0.3 + 0.3 - 0.2 - 0.1) * per)
    assert read("inference_wait_ms.fixed", run) == pytest.approx((0.2 + 0.1) * per)
    assert read("search_host_ms.fixed", run) == pytest.approx((0.2 + 0.3 - 0.05 - 0.15) * per)
    # the five sum to the spans' time less the kernel's
    assert sum(read(m, run) for m in SPANS) == pytest.approx(
        (0.1 + 0.12 + 0.8 + 0.8 - 0.05 - 0.15) * per)


def test_span_and_counter_readers_without_the_program_s_own():
    # a parent's slice: the harness's spans only, and timings without rounds
    s = Summary((0.0, 1.0), [2], [], [(0.0, 1.0, "ProfilerStep#2"),
                                      (0.0, 0.1, "portbench.dataset"),
                                      (0.1, 0.9, "portbench.evaluate")])
    t = {"inference_s": 0.5, "search_s": 0.1, "total_s": 0.8}
    reqs = [Req(2, 0.0, 1.0, 64, timings=t, chunks=3, work=np.ones((64, 2)))]
    run = fake_run(reqs, (0.0, 1.0), trace=s)
    assert all(read(m, run) is None for m in SPANS)
    run = fake_run(reqs, (0.0, 1.0), cell="tsp100.deadline10s")
    assert all(read(m, run, "tsp100.deadline10s") is None for m in COUNTERS)


def test_counter_readers():
    # two requests: 3 and 5 chunks; rounds (LS, perturbation) against work
    w1 = np.array([[10, 4], [6, 4]])
    w2 = np.array([[20, 10], [20, 5], [2, 1]])
    reqs = [Req(0, 0.0, 1.0, 2, timings={"search_rounds": (12, 6)}, chunks=3, work=w1),
            Req(1, 1.0, 2.0, 3, timings={"search_rounds": (25, 10)}, chunks=5, work=w2)]
    run = fake_run(reqs, (0.0, 2.0), cell="tsp100.deadline10s")
    assert read("rounds_per_iter.deadline", run, "tsp100.deadline10s") == pytest.approx(
        (12 + 6 + 25 + 10) / 8)
    assert read("lockstep_useful.deadline", run, "tsp100.deadline10s") == pytest.approx(
        100 * (24 + 58) / (2 * 18 + 3 * 35))


@pytest.mark.parametrize("kind, names", [("fixed", SPANS), ("deadline", COUNTERS)])
def test_traced_cpu_run_reports_the_new_metrics(tmp_path, capsys, kind, names):
    root, name = harness_root.make(tmp_path, kind)
    if kind == "fixed":  # a CPU request takes seconds: trace the first, not the second
        own = root / "portbench" / "workloads" / f"{name}.json"
        spec = json.loads(own.read_text())
        spec["trace"]["slice"] = {"wait": 0, "warmup": 0, "active": 1}
        own.write_text(json.dumps(spec))
    else:  # a deadline that outlasts the initial local search on a busy CPU
        mix = root / "portbench" / "traffic" / f"tiny_{kind}.json"
        mix.write_text(json.dumps(dict(json.loads(mix.read_text()), time_limit=3.0)))
    rc = harness.main(["--workload", name, "--seed", "3000000019", "--seconds", "1",
                       "--trace", "1"], root=root, device="cpu", t_start=time.time())
    out = capsys.readouterr()
    res = json.loads(out.out.strip().splitlines()[-1])
    assert rc == 0 and res["correct"], out.err
    got = {m: res["metrics"][m]["value"] for m in names if m in res["metrics"]}
    assert set(got) == set(names) and all(v > 0 for v in got.values()), got
    if kind == "deadline":
        assert got["lockstep_useful.deadline"] <= 100.0
    else:  # one request, traced: the five spans add up to its latency less the search's
        m = {k: v["value"] for k, v in res["metrics"].items()}
        assert res["attempted"] == 1
        assert sum(got.values()) == pytest.approx(
            m["dataset_ms.fixed"] + m["host_ms.fixed"] + m["inference_ms.fixed"], rel=0.05)
