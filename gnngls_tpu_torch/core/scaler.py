"""Min-max scaling with sklearn semantics (gnngls_tpu/core/scaler.py).

Only what evaluation needs: the affine map, its inverse, and the readers of
`scalers.json` and of the reference's pickled sklearn scalers (`scalers.pkl`,
scripts/preprocess_dataset.py), the latter unpickled without importing
sklearn here (pickle imports it to rebuild the objects).
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

    @classmethod
    def from_sklearn(cls, sk) -> "MinMaxScaler":
        """A fitted sklearn MinMaxScaler with the default feature_range."""
        fr = getattr(sk, "feature_range", (0, 1))
        if tuple(fr) != (0, 1):
            raise ValueError(f"only feature_range=(0, 1) is supported, got {fr}")
        return cls(sk.data_min_, sk.data_max_)


def load_scalers(path) -> dict:
    """Scalers from `scalers.json` ({key: {data_min, data_max}}) or from a
    reference `scalers.pkl`: a dict of sklearn scalers, possibly nested under
    an 'edges' key (gnngls/datasets.py)."""
    path = str(path)
    if path.endswith(".json"):
        with open(path) as f:
            return {k: MinMaxScaler(v["data_min"], v["data_max"])
                    for k, v in json.load(f).items()}
    import pickle

    with open(path, "rb") as f:
        obj = pickle.load(f)
    if "edges" in obj:
        obj = obj["edges"]
    return {k: MinMaxScaler.from_sklearn(v) for k, v in obj.items()}
