"""utils/profiling.py on the CPU: `device_trace` exports a Chrome trace into
its directory, holding the regions nested `annotate` calls name
(gnngls_tpu/utils/profiling.py's API over torch.profiler)."""

import json

import numpy as np
import torch

from gnngls_tpu_torch.search import batched
from gnngls_tpu_torch.utils.profiling import annotate, device_trace


def _events(logdir):
    traces = sorted(logdir.glob("*.pt.trace.json"))
    assert len(traces) == 1, traces
    return json.loads(traces[0].read_text())["traceEvents"]


def test_device_trace_exports_the_annotated_regions(tmp_path):
    rng = np.random.default_rng(0)
    D = rng.random((2, 8, 8)).astype(np.float32)
    D = D + D.transpose(0, 2, 1)
    tour = np.tile(np.r_[np.arange(8), 0], (2, 1))
    with device_trace(tmp_path / "trace"):
        with annotate("search"):
            for step in range(2):
                with annotate(f"gls#{step}"):
                    batched.run_fixed_kernel(D, D[:, None], tour, n_iters=1, device="cpu")
    events = _events(tmp_path / "trace")
    names = {e.get("name") for e in events}
    assert {"search", "gls#0", "gls#1"} <= names
    spans = {e["name"]: e for e in events if e.get("ph") == "X"}
    outer, inner = spans["search"], spans["gls#1"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    # torch's own operators are on the timeline too
    assert any(str(n).startswith("aten::") for n in names)


def test_annotate_outside_a_trace_is_harmless(tmp_path):
    with annotate("alone"), annotate("step#3"):
        assert torch.ones(3).sum() == 3
    with device_trace(tmp_path) as prof:
        assert prof is not None
    assert len(list(tmp_path.glob("*.pt.trace.json"))) == 1
