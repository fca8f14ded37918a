"""Profiler traces and named regions (gnngls_tpu/utils/profiling.py).

`device_trace` records host and device timelines with torch.profiler (the
device's when CUDA is available) and exports a Chrome trace, readable in
Perfetto or chrome://tracing; `annotate` and `step_annotation` name regions
on that timeline, and on the card also as NVTX ranges.
"""

from __future__ import annotations

import contextlib
import pathlib

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler


@contextlib.contextmanager
def device_trace(logdir):
    """Profile the block; its Chrome trace (`*.pt.trace.json`) is written
    into logdir when the block ends.  Yields the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    pathlib.Path(logdir).mkdir(parents=True, exist_ok=True)
    handler = tensorboard_trace_handler(str(logdir))
    with profile(activities=activities, on_trace_ready=handler) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str):
    """A named region: a profiler record_function, and an NVTX range when
    CUDA is available."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def step_annotation(name: str, step: int):
    """The region f"{name}#{step}", so repeated steps line up in a viewer."""
    return annotate(f"{name}#{step}")
