"""Min-max scaling with sklearn semantics (gnngls_tpu/core/scaler.py).

Only what evaluation needs: the affine map, its inverse, and the JSON reader
for `scalers.json`.  Pickled sklearn scalers wait for the reference-API slice.
"""

from __future__ import annotations

import json

import numpy as np


class MinMaxScaler:
    """Per-column x -> (x - data_min) / (data_max - data_min), zero range -> 1."""

    def __init__(self, data_min, data_max):
        self.data_min_ = np.asarray(data_min, dtype=np.float64)
        self.data_max_ = np.asarray(data_max, dtype=np.float64)

    @property
    def scale_(self) -> np.ndarray:
        r = self.data_max_ - self.data_min_
        return 1.0 / np.where(r == 0.0, 1.0, r)

    @property
    def min_(self) -> np.ndarray:
        return -self.data_min_ * self.scale_

    def transform(self, X):
        X = np.asarray(X)
        return X * self.scale_.astype(X.dtype) + self.min_.astype(X.dtype)

    def inverse_transform(self, X):
        X = np.asarray(X)
        return (X - self.min_.astype(X.dtype)) / self.scale_.astype(X.dtype)


def load_scalers(path) -> dict:
    """Scalers from the JSON format `{key: {data_min, data_max}}`."""
    path = str(path)
    if not path.endswith(".json"):
        raise NotImplementedError(
            f"{path}: only scalers.json is read by the port so far; pickled "
            "reference scalers wait for the reference-API slice")
    with open(path) as f:
        return {k: MinMaxScaler(v["data_min"], v["data_max"])
                for k, v in json.load(f).items()}
