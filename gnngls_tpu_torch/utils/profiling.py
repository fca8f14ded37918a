"""Profiler traces and named regions (gnngls_tpu/utils/profiling.py).

`device_trace` records host and device timelines with torch.profiler (the
device's when CUDA is available) and exports a Chrome trace, readable in
Perfetto or chrome://tracing; `annotate` names a region on that timeline,
and on the card also as an NVTX range.

The program's own spans are `annotate` regions, recorded only while a
profiler listens (torch.profiler records the regions, an Nsight tool the
NVTX ranges); there is no other switch.  Their names and nesting:

    gnngls.dataset               TSPDataset.from_arrays (no features built)
    gnngls.dataset.features      edge_features (its own distance matrices), on
                                 the first read of a split's lazy features
    gnngls.dataset.batch         TSPDataset.get_scaled_batch (also in predict)
    gnngls.evaluate              the whole evaluate() call
      gnngls.evaluate.distances  the distance matrices, built on the evaluate's device
      gnngls.predict             predict_regret (the GAT)
        gnngls.predict.features  a batch's edge weights gathered from D and
                                 scaled on the device: enqueue
        gnngls.dataset.batch     or, for features of a dataset's own or
                                 dropped columns, a batch scaled on the host
        gnngls.predict.forward   the copy to the device and the model: enqueue
        gnngls.predict.fetch     the copy back: the host waits on the device
        gnngls.predict.unscale   inverse scaling, clamp at 0
      gnngls.evaluate.to_matrix  the edge vectors as (n, n) matrices
      gnngls.predict             predict_edge_guide (the gated GCN), a batch:
        gnngls.predict.inputs    coordinates up, k-NN tags and edge values from D
        gnngls.predict.forward   the layers and the edge MLP: enqueue
        gnngls.predict.guide     softmax, 1 - (p + p^T) / 2: enqueue
        gnngls.predict.fetch     the copy back: the host waits on the device
      gnngls.construct           nearest neighbour, its copies in and back
      gnngls.evaluate.guide_stack
      gnngls.search              run_fixed_kernel / run_fixed / run_wall_clock
        gnngls.search.upload     the kernel's inputs copied to the device
        gnngls.search.kernel     the kernel's launch through its synchronize
        gnngls.search.fetch      the copies back, f32 tour costs on the host
        gnngls.search.iteration  an outer iteration of the per-move engine
          gnngls.search.perturb  the perturbation's rounds
          gnngls.search.ls       the local search's rounds
      gnngls.evaluate.finish     gaps, initial costs, the result

On the CPU the kernel's twin runs the per-move engine's iterations, so
their spans nest in gnngls.search.kernel there.  No span opens inside a
round of the per-move engine, the model's forward or a training step.

Counters: evaluate's `timings["predict_batches"]`, the model's forwards
(each one batch of `batch_size`, the gated GCN's BatchNorm batch), and
`timings["host_feature_batches"]`, those of the GAT's batches whose features
came from the host (`gnngls.dataset.batch` under `gnngls.predict`).  The
per-move engine counts on the host the lock-step rounds the
batch ran, each followed by one host sync: `GLSState.rounds`,
`BatchResult.rounds` and evaluate's `timings["search_rounds"]`, as (local
search, perturbation), beside each instance's own rounds in `work`.
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
    CUDA is available.  Also a decorator, a region a call."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
