"""Dataset arrays on disk (gnngls_tpu/data/generate.py, eval side only)."""

from __future__ import annotations

import numpy as np


def coords_to_distance_matrix(coords: np.ndarray) -> np.ndarray:
    """(..., n, 2) -> (..., n, n) Euclidean weights, f32."""
    d = coords[..., :, None, :] - coords[..., None, :, :]
    return np.sqrt((d * d).sum(-1)).astype(np.float32)


def load_dataset(path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
