"""Min-max scaling with sklearn semantics (gnngls_tpu/core/scaler.py).

The reference fits one sklearn `MinMaxScaler` per key ('features', 'regret')
by `partial_fit` over the train set (scripts/preprocess_dataset.py).  Here:
the fit, the affine map and its inverse, `scalers.json` written byte for
byte as gnngls_tpu writes it, and the readers of that file and of the
reference's pickled sklearn scalers (`scalers.pkl`, unpickled without
importing sklearn here: pickle imports it to rebuild the objects).
"""

from __future__ import annotations

import json

import numpy as np


class MinMaxScaler:
    """Per-column x -> (x - data_min) / (data_max - data_min), zero range -> 1."""

    def __init__(self, data_min=None, data_max=None):
        """Unfitted, or fitted to the given per-column range."""
        self.data_min_ = None if data_min is None else np.asarray(data_min, dtype=np.float64)
        self.data_max_ = None if data_max is None else np.asarray(data_max, dtype=np.float64)

    def partial_fit(self, X) -> "MinMaxScaler":
        """Widen the range to the columns of X (rows are samples)."""
        X = np.asarray(X, dtype=np.float64)
        mn, mx = X.min(axis=0), X.max(axis=0)
        if self.data_min_ is None:
            self.data_min_, self.data_max_ = mn, mx
        else:
            self.data_min_ = np.minimum(self.data_min_, mn)
            self.data_max_ = np.maximum(self.data_max_, mx)
        return self

    def fit(self, X) -> "MinMaxScaler":
        self.data_min_ = self.data_max_ = None
        return self.partial_fit(X)

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

    def to_dict(self) -> dict:
        return {
            "data_min": np.asarray(self.data_min_).tolist(),
            "data_max": np.asarray(self.data_max_).tolist(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "MinMaxScaler":
        return cls(d["data_min"], d["data_max"])

    @classmethod
    def from_sklearn(cls, sk) -> "MinMaxScaler":
        """A fitted sklearn MinMaxScaler with the default feature_range."""
        fr = getattr(sk, "feature_range", (0, 1))
        if tuple(fr) != (0, 1):
            raise ValueError(f"only feature_range=(0, 1) is supported, got {fr}")
        return cls(sk.data_min_, sk.data_max_)


def save_scalers(path, scalers: dict) -> None:
    """{key: scaler} as `scalers.json`."""
    with open(path, "w") as f:
        json.dump({k: v.to_dict() for k, v in scalers.items()}, f)


def load_scalers(path) -> dict:
    """Scalers from `scalers.json` ({key: {data_min, data_max}}) or from a
    reference `scalers.pkl`: a dict of sklearn scalers, possibly nested under
    an 'edges' key (gnngls/datasets.py)."""
    path = str(path)
    if path.endswith(".json"):
        with open(path) as f:
            return {k: MinMaxScaler.from_dict(v) for k, v in json.load(f).items()}
    import pickle

    with open(path, "rb") as f:
        obj = pickle.load(f)
    if "edges" in obj:
        obj = obj["edges"]
    return {k: MinMaxScaler.from_sklearn(v) for k, v in obj.items()}
