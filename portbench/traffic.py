"""The one generator of requests, driven by a traffic file's parameters and a
configuration's instance source.  Every request is drawn from the seed and
its index alone, never from the clock, so a seed gives the same inputs
whatever the timing.

Instance sources (the configuration's "instances"):
  {"kind": "split", "npz": ..., "split": ..., "train_split": ...}
      rows of a dataset file (coordinates, optimal costs, regret labels);
  {"kind": "uniform", "n": n}
      cities uniform in the unit square, fresh for every request; no optimum.

Traffic parameters used here:
  request_instances   instances a request carries (an int, or "all": the
                      whole split); a split is taken in one seed-drawn
                      order, requests taking consecutive runs of it and
                      wrapping, so every seed solves the same multiset of
                      instances; a uniform source draws fresh ones each time
  split               "test" (default) or "train"
  labels              true: load the split's regret labels (training)
"""

from __future__ import annotations

import pathlib
from typing import Optional

import numpy as np


class Requests:
    """Request r's coordinates (N, n, 2) float32 and optimal costs (N,)
    (None where the source has none), and for training its regret labels."""

    def __init__(self, root: pathlib.Path, config: dict, traffic: dict, seed: int):
        self.seed = int(seed)
        self.traffic = traffic
        src = config["instances"]
        self.kind = src["kind"]
        if self.kind == "split":
            which = traffic.get("split", "test")
            rows = np.loadtxt(root / src[f"{which}_split" if which != "test" else "split"],
                              dtype=np.int64, ndmin=1)
            with np.load(root / src["npz"], allow_pickle=False) as z:
                self.coords = np.ascontiguousarray(z["coords"][rows], np.float32)
                self.opt = np.asarray(z["opt_cost"][rows], np.float64)
                self.regret = (np.asarray(z["regret"][rows], np.float32)
                               if traffic.get("labels") else None)
            self.n = self.coords.shape[1]
            self.order = np.random.default_rng([self.seed, 0]).permutation(len(rows))
            k = traffic["request_instances"]
            self.size = len(rows) if k == "all" else int(k)
        elif self.kind == "uniform":
            self.n = int(src["n"])
            self.size = int(traffic["request_instances"])
        else:
            raise ValueError(f"unknown instance source {self.kind!r}")

    def rows(self, r: int) -> Optional[np.ndarray]:
        """The split rows of request r (None for a uniform source)."""
        if self.kind != "split":
            return None
        pos = (r * self.size + np.arange(self.size)) % len(self.order)
        return self.order[pos]

    def coords_of(self, r: int) -> np.ndarray:
        if self.kind == "split":
            return self.coords[self.rows(r)]
        rng = np.random.default_rng([self.seed, 1, r])
        return rng.random((self.size, self.n, 2), dtype=np.float32)

    def opt_of(self, r: int) -> Optional[np.ndarray]:
        return self.opt[self.rows(r)] if self.kind == "split" else None

    def regret_of(self, r: int) -> np.ndarray:
        return self.regret[self.rows(r)]


def lanes(seed: int, r: int, size: int, k: int) -> np.ndarray:
    """The instances of request r (r >= 0) that a run keeps for its check:
    k of its `size`, drawn from the seed and r, sorted."""
    rng = np.random.default_rng([seed, 2, r])
    return np.sort(rng.choice(size, size=min(k, size), replace=False))


def picks(seed: int, n_done: int, k: int) -> np.ndarray:
    """The requests a run checks: k of the n_done that its window completed,
    drawn from the seed, sorted."""
    rng = np.random.default_rng([seed, 3])
    return np.sort(rng.choice(n_done, size=min(k, n_done), replace=False))
