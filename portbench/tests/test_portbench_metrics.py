"""The benchmark's arithmetic: rates and percentiles over a window, the
busy share of a synthetic trace, the model's FLOPs, the kernels' operation
and byte counts, and the reduction of a real (CPU) profiler trace."""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest

from portbench import manifest, roofline
from portbench.trace import Slice, Summary


@dataclasses.dataclass
class Req:
    index: int
    start: float
    end: float
    instances: int
    dataset_s: float = 0.0
    timings: dict = dataclasses.field(default_factory=dict)
    chunks: int = 0
    search_s: float = 0.0
    work: object = None
    peak_bytes: int = 0


def fake_run(requests, window, trace=None, cell="tsp100.fixed100", gaps=None):
    c = manifest.load(cell)
    return types.SimpleNamespace(cell=c, setup_s=12.5, window=window, requests=requests,
                                 gaps=gaps, trace=trace, peaks=roofline.peaks("NVIDIA H100"),
                                 window_s=window[1] - window[0],
                                 instances=sum(q.instances for q in requests))


def read(name, run, cell="tsp100.fixed100"):
    c = manifest.load(cell)
    return {m.name: m for m in c.end_to_end + c.per_layer}[name].read(run)


def test_rate_is_all_instances_over_the_whole_window():
    reqs = [Req(i, 10.0 + 0.5 * i, 10.5 + 0.5 * i, 64) for i in range(8)]
    run = fake_run(reqs, (10.0, 14.0))
    assert read("instances_per_s", run) == pytest.approx(8 * 64 / 4.0)
    assert read("setup_s", run) == 12.5


def test_p95_is_over_every_request():
    lat = np.linspace(0.1, 0.3, 201)
    reqs = [Req(i, float(i), float(i) + float(x), 1) for i, x in enumerate(lat)]
    run = fake_run(reqs, (0.0, 201.0))
    assert read("solve_p95_s", run) == pytest.approx(np.percentile(lat, 95))
    assert read("solve_p95_s", run) == pytest.approx(0.29)


def test_gap_and_per_instance_parts():
    t = {"inference_s": 0.06, "search_s": 0.01, "total_s": 0.09}
    reqs = [Req(0, 0.0, 0.1, 4, dataset_s=0.02, timings=t)]
    run = fake_run(reqs, (0.0, 0.1), gaps=np.array([0.5, 1.0, 1.5]),
                   cell="tsp100.deadline10s")
    assert read("gap_pct", run, "tsp100.deadline10s") == pytest.approx(1.0)
    run = fake_run(reqs, (0.0, 0.1))
    assert read("inference_ms.fixed", run) == pytest.approx(15.0)
    assert read("dataset_ms.fixed", run) == pytest.approx(5.0)
    assert read("search_ms.fixed", run) == pytest.approx(2.5)
    assert read("host_ms.fixed", run) == pytest.approx(2.5)  # 0.1 - 0.02 - 0.06 - 0.01


def test_busy_share_and_idle_gaps_of_a_synthetic_trace():
    s = Summary((0.0, 10.0), [1, 2],
                [(1.0, 2.0, "k1"), (1.5, 2.5, "k2"), (3.0, 4.0, "k1"), (9.5, 11.0, "k3")],
                [(0.0, 10.0, "ProfilerStep#1"), (0.0, 0.9, "portbench.dataset"),
                 (2.6, 2.95, "aten::mm"), (4.5, 9.0, "portbench.evaluate"),
                 (5.0, 5.1, "aten::add")])
    assert s.busy_s() == pytest.approx(1.5 + 1.0 + 0.5)  # k3 clipped at the window's end
    assert s.device_ops() == [["k1", 2.0], ["k3", 1.5], ["k2", 1.0]]
    gaps = dict(s.idle_gaps())
    assert gaps["portbench.dataset: host code"] == pytest.approx(1.0)
    assert gaps["aten::mm"] == pytest.approx(0.5)
    assert gaps["portbench.evaluate: host code after aten::add"] == pytest.approx(5.5)
    assert sum(gaps.values()) == pytest.approx(10.0 - 3.0)
    run = fake_run([Req(1, 0, 1, 1), Req(2, 1, 2, 1)], (0.0, 2.0), trace=s)
    assert read("idle.fixed", run) == pytest.approx(70.0)


def test_a_cpu_profile_reduces_to_its_recorded_steps():
    import torch

    sl = Slice(wait=1, warmup=1, active=2)
    sl.start()
    for _ in range(5):
        torch.ones(64, 64) @ torch.ones(64, 64)
        sl.step()
    sl.stop()
    s = sl.summary
    assert s.steps == [2, 3] and s.window_s > 0
    assert any(name == "aten::mm" for _, _, name in s.host)


def test_model_flops_per_instance():
    f = roofline.model_flops_per_instance
    assert f(100, 128, 512, 8) == pytest.approx(11.70e9, rel=1e-3)
    assert f(500, 128, 512, 8) == pytest.approx(294.8e9, rel=1e-3)
    per_edge_layer = 2 * 128 * 128 + 4 * 128 + 4 * 128 * 512
    assert per_edge_layer == 295_424


def test_kernel_counts_from_shapes():
    pk = roofline.peaks("NVIDIA H100 80GB HBM3")
    ops, nbytes = roofline.gat_partials_work(64, 100, 8, 16)
    assert roofline.bound_s(ops, nbytes, pk) * 1e3 == pytest.approx(0.1634, rel=1e-3)
    ops, nbytes = roofline.gat_partials_work(16, 500, 8, 16)
    assert roofline.bound_s(ops, nbytes, pk) * 1e3 == pytest.approx(1.0299, rel=1e-3)
    ops, nbytes = roofline.gls_work([(10, 100), (20, 200)], 100, 1, 100)
    assert ops == 30 * (3 * 98 * 97 / 2 + 5 * 98 ** 2) + 300 * 46 * 100
    assert nbytes == 4 * (2 * 100 * 100 * 2 + 2 * 2 * 101 + 2 * 204)


def test_roofline_reader_counts_the_traced_launches():
    s = Summary((0.0, 1.0), [3, 4], [(0.1, 0.2, "void gat_group_kernel<16>(float*)"),
                                     (0.3, 0.4, "void gat_group_kernel<16>(float*)"),
                                     (0.5, 0.6, "void gls_whole_kernel<0>(float*)")], [])
    reqs = [Req(i, i, i + 1, 64, work=np.full((64, 2), 100)) for i in range(6)]
    run = fake_run(reqs, (0.0, 6.0), trace=s)
    one = roofline.bound_s(*roofline.gat_partials_work(64, 100, 8, 16), run.peaks)
    assert read("gat_group_roofline", run) == pytest.approx(100 * 2 * one / 0.2)
    # two traced requests but one K1 launch in the slice: no reading
    assert read("gls_whole_roofline", run) is None
    s.steps = [3]
    k1 = roofline.bound_s(*roofline.gls_work(reqs[3].work, 100, 1, 100), run.peaks)
    assert read("gls_whole_roofline", run) == pytest.approx(100 * k1 / 0.1)
