"""A percentile of the latency of every request in the window (host clock,
from the request's start to its result), numpy's linear interpolation."""

import numpy as np


def read(run, q):
    return float(np.percentile([r.end - r.start for r in run.requests], q))
