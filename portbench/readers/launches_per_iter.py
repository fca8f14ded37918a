"""Kernel launches per outer iteration in the traced slice, whose steps are
the per-move engine's iterations."""


def read(run):
    tr = run.trace
    if tr is None or not tr.steps:
        return None
    return len(tr.kernels()) / len(tr.steps)
