"""Host-side tour utilities (numpy), as in gnngls_tpu/utils/__init__.py.

`utils.profiling` holds the profiler helpers."""

from __future__ import annotations

import numpy as np

from ..core.graph import edge_index, n_edges


def tour_cost(D: np.ndarray, tour) -> float:
    """Cost of a closed tour (depot-to-depot node list) under matrix D."""
    t = np.asarray(tour)
    return float(D[t[:-1], t[1:]].sum())


def tour_to_edge_vector(n: int, tour) -> np.ndarray:
    """(E,) bool: which K_n edges the closed tour uses, undirected."""
    t = np.asarray(tour)
    out = np.zeros(n_edges(n), dtype=bool)
    out[edge_index(n, t[:-1], t[1:])] = True
    return out


def is_valid_tour(n: int, tour) -> bool:
    """Starts and ends at depot 0, the depot twice, every other node once."""
    t = list(np.asarray(tour).tolist())
    if len(t) != n + 1 or t[0] != 0 or t[-1] != 0:
        return False
    counts = np.bincount(np.asarray(t), minlength=n)
    return counts[0] == 2 and bool((counts[1:] == 1).all()) and len(counts) == n


def is_equivalent_tour(tour_a, tour_b) -> bool:
    """Equal, or equal when one is reversed."""
    a = list(np.asarray(tour_a).tolist())
    b = list(np.asarray(tour_b).tolist())
    return a == b or a == b[::-1]
