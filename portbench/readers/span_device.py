"""Device time inside a span of the program, in the traced slice whose steps
are requests: the union of device intervals (kernels, copies, sets) inside
the host events named `span` of the traced requests, each clipped to its
event.  A span that ends in a synchronisation (as `gnngls.predict` does in
its fetch) holds all the device work it enqueued.

  of="roofline"  the least time the chip could take for the traced requests'
                 forwards (roofline.bound_s of `work`'s operations and bytes
                 for each batch of the traffic's batch_size) over that device
                 time, in %;
  of="share"     the share (%) of that device time in kernels whose name
                 contains `kernel`.

Nothing where the slice holds no such span or no device time in it, as from
a program that has no such span."""

from portbench import roofline, roofline_gated_gcn

WORK = {"gated_gcn": roofline_gated_gcn.gated_gcn_work}


def _union_s(intervals, spans) -> float:
    """Seconds of the union of `intervals` clipped to each of `spans`
    (disjoint host events)."""
    total = 0.0
    for lo, hi in spans:
        cur = lo
        for s, e, *_ in intervals:
            s, e = max(s, cur), min(e, hi)
            if e > s:
                total += e - s
                cur = e
    return total


def read(run, span, of, kernel="", work="gated_gcn"):
    tr = run.trace
    if tr is None:
        return None
    lo, hi = tr.window
    spans = sorted((s, e) for s, e, n in tr.host if n == span and lo <= s and e <= hi)
    device = sorted(tr.device)
    dev_s = _union_s(device, spans)
    if not spans or dev_s <= 0:
        return None
    if of == "share":
        return 100.0 * _union_s(sorted(tr.kernels(kernel)), spans) / dev_s
    if of != "roofline":
        raise ValueError(f"unknown of {of!r}")
    steps = set(tr.steps)
    cfg, bs = run.cell.config, int(run.cell.traffic["batch_size"])
    n = cfg["instances"]["n"]
    bound = sum(roofline.bound_s(*WORK[work](min(bs, q.instances - s), n, cfg["model"]),
                                 run.peaks)
                for q in run.requests if q.index in steps
                for s in range(0, q.instances, bs))
    return 100.0 * bound / dev_s
