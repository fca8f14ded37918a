"""Mean gap (%) to the optimum over every instance of every request in the
window, from the best tours' float64 lengths; nothing without optima."""

import numpy as np


def read(run):
    return None if run.gaps is None else float(np.mean(run.gaps))
