"""The largest device memory a request of the window held
(torch.cuda.max_memory_allocated, as the program reports it), GB."""


def read(run):
    peak = max(int(q.peak_bytes or 0) for q in run.requests)
    return peak / 1e9 if peak else None
