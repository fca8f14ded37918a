"""Instances completed over the window: every instance of every request the
window ran, over the window's length on the host clock."""


def read(run):
    return run.instances / run.window_s
