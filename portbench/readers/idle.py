"""The device's idle share (%) of the traced slice: 1 - busy / window, busy the
union of device intervals."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
