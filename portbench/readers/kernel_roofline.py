"""A kernel's share (%) of its roofline in the traced slice: the least time
the chip could take for its launches there (roofline.bound_s of each launch's
operations and bytes) over the device time they took.  `work` names how a
launch is counted: "gat_partials" from the shapes (every launch at the
traffic's batch), "gls" from the work counters of the traced requests.
Nothing where the slice holds no launch of the kernel."""

from portbench import roofline


def read(run, kernel, work):
    tr = run.trace
    if tr is None:
        return None
    launches = tr.kernels(kernel)
    if not launches:
        return None
    dev_s = sum(e - s for s, e, _ in launches)
    cfg, t = run.cell.config, run.cell.traffic
    n = cfg["instances"]["n"]
    if work == "gat_partials":
        m = cfg["model"]
        B = min(t["batch_size"], run.requests[0].instances)
        ops, nbytes = roofline.gat_partials_work(B, n, m["n_heads"],
                                                 m["embed_dim"] // m["n_heads"])
        bound = len(launches) * roofline.bound_s(ops, nbytes, run.peaks)
    elif work == "gls":
        traced = [q for q in run.requests if q.index in set(tr.steps)]
        if len(traced) != len(launches):
            return None  # a launch the slice cut, or a request that had none
        bound = sum(roofline.bound_s(*roofline.gls_work(q.work, n, len(t["guides"]),
                                                        t["n_iters"]), run.peaks)
                    for q in traced)
    else:
        raise ValueError(f"unknown work {work!r}")
    return 100.0 * bound / dev_s
