"""setup_s: seconds from the process's start to the window's (imports,
loading, the kernels' build on a checkout's first run, warm-up)."""


def read(run):
    return run.setup_s
