"""The share (%) of the per-move engine's lock-step work that an instance
still needed, over the window's requests: each instance's own rounds (the
search's `work`, local search and perturbation) over the rounds the batch
ran (`timings["search_rounds"]`) times its instances, each kind of round
against its own count.  Nothing where the program does not count them."""

import numpy as np


def read(run):
    useful = slots = 0
    for q in run.requests:
        rounds = q.timings.get("search_rounds")
        if rounds is None or q.work is None:
            continue
        work = np.asarray(q.work, np.int64)
        for kind, r in enumerate(rounds):
            useful += int(work[:, kind].sum())
            slots += len(work) * int(r)
    return 100.0 * useful / slots if slots else None
