"""Milliseconds a part of the requests takes per instance, over the window:
"dataset" (the harness's span around the dataset's construction),
"inference" and "search" (the program's `timings`), or "host" (the rest of
the request: its latency less those three, which is evaluate's host work:
distance matrices, construction, guide stack, copies, gaps)."""


def _part(q, part):
    t = q.timings
    if part == "dataset":
        return q.dataset_s
    if part == "inference":
        return t["inference_s"]
    if part == "search":
        return t["search_s"]
    if part == "host":
        return (q.end - q.start) - q.dataset_s - t["inference_s"] - t["search_s"]
    raise ValueError(f"unknown part {part!r}")


def read(run, part):
    return 1e3 * sum(_part(q, part) for q in run.requests) / run.instances
