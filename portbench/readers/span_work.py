"""The roofline share of the device time inside a span of the program, in the
traced slice whose steps are requests: span_device's "roofline" reading
(the union of device intervals inside the host events named `span` of the
traced requests, each clipped to its event), with the work function
`<work>_work(B, n, model)` of portbench/roofline_<work>.py, for each batch of
the traffic's batch_size: the least time the chip could take for it over
that device time, in %.  Nothing where the slice holds no such span or no
device time in it, as from a program that has no such span."""

import importlib

from portbench import roofline
from portbench.readers.span_device import _union_s


def read(run, span, work):
    tr = run.trace
    if tr is None:
        return None
    lo, hi = tr.window
    spans = sorted((s, e) for s, e, n in tr.host if n == span and lo <= s and e <= hi)
    dev_s = _union_s(sorted(tr.device), spans)
    if not spans or dev_s <= 0:
        return None
    fn = getattr(importlib.import_module(f"portbench.roofline_{work}"), f"{work}_work")
    steps = set(tr.steps)
    cfg, bs = run.cell.config, int(run.cell.traffic["batch_size"])
    n = cfg["instances"]["n"]
    bound = sum(roofline.bound_s(*fn(min(bs, q.instances - s), n, cfg["model"]), run.peaks)
                for q in run.requests if q.index in steps
                for s in range(0, q.instances, bs))
    return 100.0 * bound / dev_s
