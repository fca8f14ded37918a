"""A bounded slice of the device trace, reduced in memory.

`Slice` runs torch.profiler (host and CUDA activities) over a few steps of
the window: `wait` steps pass untraced, `warmup` more prime the profiler, and
the next `active` are recorded.  Once the window has closed (`stop`) the
slice's events are reduced to a `Summary` (device intervals by name, host
ops, the recorded steps); no trace is written anywhere, and the profiler's
own buffers go.

The reduction (the arithmetic of the program's `trace_eval.busy_share`,
copied):
  * busy: the union of device intervals (kernels, copies, sets) inside the
    window, the window running from the first recorded step's start to the
    last one's end;
  * device ops: device seconds by name;
  * idle gaps: each stretch of the window with nothing on the device, named
    by the innermost host op running at its middle on the thread that
    stepped the profiler (else "host code after" the op that ended last
    before it), seconds summed by that name.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

STEP = re.compile(r"^ProfilerStep#(\d+)$")
SPAN = "portbench."  # the harness's own spans around its calls into the program
NOT_KERNELS = ("Memcpy", "Memset")


@dataclasses.dataclass
class Summary:
    window: Tuple[float, float]  # seconds on the trace's clock
    steps: List[int]  # the recorded step numbers
    device: List[Tuple[float, float, str]]  # (start, end, name), seconds, sorted
    host: List[Tuple[float, float, str]]  # (start, end, name) on the stepping thread

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self, pattern: str = "") -> List[Tuple[float, float, str]]:
        """Kernel intervals (not copies or sets) whose name contains pattern."""
        return [d for d in self.device
                if pattern in d[2] and not d[2].startswith(NOT_KERNELS)]

    def busy_s(self) -> float:
        return sum(e - s for s, e in _merged(self.device, *self.window))

    def device_ops(self, top: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for s, e, name in self.device:
            by[short(name)] = by.get(short(name), 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        lo, hi = self.window
        busy = _merged(self.device, lo, hi)
        gaps, cur = [], lo
        for s, e in busy:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if hi > cur:
            gaps.append((cur, hi))
        # a sweep over the host ops (nested, sorted by start) keeps the stack of
        # those open at each gap's middle: its top is the innermost; with none
        # open the host runs its own code, named by the op that ended last
        by: Dict[str, float] = {}
        stack: List[Tuple[float, str]] = []
        last, i = (-1.0, None), 0

        def pop_until(t):
            nonlocal last
            while stack and stack[-1][0] < t:
                last = max(last, stack.pop(), key=lambda x: x[0])

        for s, e in gaps:
            mid = 0.5 * (s + e)
            while i < len(self.host) and self.host[i][0] <= mid:
                hs, he, hn = self.host[i]
                i += 1
                if not STEP.match(hn):
                    pop_until(hs)
                    stack.append((he, hn))
            pop_until(mid)
            after = f"host code after {last[1]}" if last[1] else "host code"
            name = stack[-1][1] if stack else after
            if name.startswith(SPAN):  # a harness span: say what ran inside it
                name = f"{name}: {after}"
            by[name] = by.get(name, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def short(name: str, width: int = 96) -> str:
    """A kernel's name without its return type, cut to `width` characters."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= width else name[:width - 3] + "..."


def _merged(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e, *_ in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce_events(events) -> Optional[Summary]:
    """A Summary of torch.profiler's kineto events, or None when no step was
    recorded."""
    from torch.autograd import DeviceType

    device, host, steps, step_thread = [], [], [], None
    spans = []
    for ev in events:
        s = ev.start_ns() * 1e-9
        e = s + ev.duration_ns() * 1e-9
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            # the device's copy of a host annotation (a step, a record_function) is no work
            if not (ev.is_user_annotation() or STEP.match(name)):
                device.append((s, e, name))
            continue
        m = STEP.match(name)
        if m:
            steps.append(int(m.group(1)))
            spans.append((s, e))
            step_thread = ev.start_thread_id()
        host.append((s, e, name, ev.start_thread_id()))
    if not steps:
        return None
    window = (min(s for s, _ in spans), max(e for _, e in spans))
    host = sorted((s, e, n) for s, e, n, tid in host if tid == step_thread)
    device.sort()
    return Summary(window, sorted(steps), device, host)


class Slice:
    """torch.profiler over steps [wait + warmup, wait + warmup + active)."""

    def __init__(self, wait: int, warmup: int, active: int):
        from torch.profiler import ProfilerActivity, profile, schedule

        import torch

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.summary: Optional[Summary] = None
        self._events = None
        self._prof = profile(activities=acts, on_trace_ready=self._ready,
                             schedule=schedule(wait=wait, warmup=warmup, active=active,
                                               repeat=1))

    @staticmethod
    def prime() -> None:
        """Profile one tiny op, so that the profiler's first start in the
        process (seconds on the card) falls in set-up, not in the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        if torch.cuda.is_available():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()

    def _ready(self, prof) -> None:
        self._events = prof.profiler.kineto_results  # reduced in stop(), after the window

    def start(self) -> None:
        self._prof.start()

    def step(self) -> None:
        self._prof.step()

    def stop(self) -> None:
        """End the profiler (a slice still recording ends as it stands) and
        reduce the slice's events."""
        self._prof.stop()
        self._prof = None
        if self._events is not None:
            self.summary = reduce_events(self._events.events())
            self._events = None
