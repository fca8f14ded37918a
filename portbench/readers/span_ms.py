"""Milliseconds a span of the program takes per instance in the traced
slice, whose steps are requests: the host events named `span` (the
program's `utils/profiling.annotate` regions, on the thread that stepped the
profiler, inside the slice's window) less those named in `less` (spans
inside it), over the instances of the traced requests.  Nothing where the
slice holds no such span, as from a program that has none."""


def read(run, span, less=()):
    tr = run.trace
    if tr is None:
        return None
    lo, hi = tr.window

    def seconds(name):
        return [e - s for s, e, n in tr.host if n == name and lo <= s and e <= hi]

    own = seconds(span)
    steps = set(tr.steps)
    instances = sum(q.instances for q in run.requests if q.index in steps)
    if not own or not instances:
        return None
    return 1e3 * (sum(own) - sum(sum(seconds(x)) for x in less)) / instances
