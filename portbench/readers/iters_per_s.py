"""Outer search iterations per second of search: the iterations of every
request of the window over their search time, from the program's chunk
stamps (one chunk is one outer iteration on the per-move engine)."""


def read(run):
    s = sum(q.search_s for q in run.requests)
    return sum(q.chunks for q in run.requests) / s if s > 0 else None
