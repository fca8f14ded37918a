"""Array-resident TSP splits (gnngls_tpu/data/dataset.py).

A split is dense arrays over a leading instance axis; every instance shares
the one static K_n topology.  `fit_scalers` fits a split's min-max scalers
and `split_dataset` carves the reference's shuffled train/test/val split
(both as scripts/preprocess_dataset.py does).  `from_reference_dir` reads the reference's own
format: a txt listing of pickled networkx graphs with `scalers.pkl` beside
it (unpickling them needs networkx; this module does not import it).

A split made from coordinates alone (`from_arrays`, or `features=None`)
builds its features, the edge weights, on their first read; until a caller
overrides them, `features_are_edge_weights` says so, and a predictor may form
them where its distance matrices already are (`scaled_edge_features`, the
bits of `get_scaled_batch`'s).  `from_arrays`, `edge_features` and
`get_scaled_batch` are the spans "gnngls.dataset", "gnngls.dataset.features"
and "gnngls.dataset.batch" (utils/profiling.py).
"""

from __future__ import annotations

import functools
import pathlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.graph import build_topology, edge_index
from ..core.scaler import MinMaxScaler, load_scalers
from ..utils.profiling import annotate
from .generate import coords_to_distance_matrix, load_dataset


@annotate("gnngls.dataset.features")
def edge_features(coords: np.ndarray) -> np.ndarray:
    """(..., n, 2) coords -> (..., E, 1) features (the edge weight)."""
    topo = build_topology(coords.shape[-2])
    D = coords_to_distance_matrix(coords)
    w = D[..., topo.edges[:, 0], topo.edges[:, 1]]
    return w[..., None].astype(np.float32)


@functools.lru_cache(maxsize=16)
def _edge_positions(n: int, device: torch.device) -> torch.Tensor:
    """The flat positions u * n + v of K_n's edges (u, v), in the canonical
    order, in a row-major n x n matrix, on `device`."""
    e = build_topology(n).edges.astype(np.int64)
    return torch.as_tensor(e[:, 0] * n + e[:, 1], device=device)


def scaled_edge_features(D: torch.Tensor, scaler: MinMaxScaler) -> torch.Tensor:
    """(B, n, n) f32 distance matrices -> (B, E, 1) f32 scaled features, on
    D's device: the bits of `get_scaled_batch`'s "features" for a split whose
    features are its edge weights.  The weights are gathered from D, then
    scaled by the scaler's f32 scale_ and min_ as a multiply and then an add,
    two roundings as NumPy's `transform` makes them (no fused multiply-add)."""
    if np.shape(scaler.scale_) != (1,):
        raise ValueError(f"edge weights are one feature; the scaler has {np.shape(scaler.scale_)}")
    B, n = D.shape[0], D.shape[-1]
    w = D.reshape(B, n * n).index_select(1, _edge_positions(n, D.device))
    scale = float(scaler.scale_.astype(np.float32)[0])
    shift = float(scaler.min_.astype(np.float32)[0])
    return (w * scale).add_(shift)[..., None]


class _Features:
    """TSPDataset's `features` field: the array it was given, or, given None,
    the coordinates' edge weights (`edge_features`), built on the first read
    and kept.  A required field: it has no default."""

    def __get__(self, obj, owner=None):
        if obj is None:
            raise AttributeError("features")
        if obj._features is None:
            obj._features = edge_features(obj.coords)
        return obj._features

    def __set__(self, obj, value):
        obj._features = value
        obj._edge_weights = value is None


@dataclass
class TSPDataset:
    coords: np.ndarray  # (N, n, 2)
    features: np.ndarray = _Features()  # (N, E, F) unscaled; None: the edge weights
    regret: np.ndarray  # (N, E) unscaled
    in_solution: np.ndarray  # (N, E) bool
    opt_cost: np.ndarray  # (N,)
    scalers: Dict[str, MinMaxScaler] = field(default_factory=dict)
    feat_drop_idx: List[int] = field(default_factory=list)

    def __len__(self) -> int:
        return self.coords.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.coords.shape[1]

    @property
    def features_are_edge_weights(self) -> bool:
        """The features are the coordinates' edge weights, built here (given
        as None) and not overridden since."""
        return self._edge_weights

    @property
    def feat_dim(self) -> int:
        return self.features.shape[-1] - len(self.feat_drop_idx)

    def fit_scalers(self) -> Dict[str, MinMaxScaler]:
        """Min-max scalers of this split, by partial_fit over each instance's
        edge rows, as the reference does; kept in self.scalers."""
        f = MinMaxScaler()
        r = MinMaxScaler()
        for i in range(len(self)):
            f.partial_fit(self.features[i])
            r.partial_fit(self.regret[i][:, None])
        self.scalers = {"features": f, "regret": r}
        return self.scalers

    @annotate("gnngls.dataset.batch")
    def get_scaled_batch(self, idx) -> dict:
        """Slice and min-max scale a batch, dropping `feat_drop_idx` columns."""
        idx = np.asarray(idx)
        x = self.scalers["features"].transform(self.features[idx]).astype(np.float32)
        if self.feat_drop_idx:
            x = np.delete(x, self.feat_drop_idx, axis=-1)
        y = self.scalers["regret"].transform(
            self.regret[idx][..., None]).astype(np.float32)
        return {
            "features": x,
            "regret": y,
            "regret_unscaled": self.regret[idx][..., None].astype(np.float32),
            "in_solution": self.in_solution[idx][..., None].astype(np.float32),
            "coords": self.coords[idx],
            "opt_cost": self.opt_cost[idx],
        }

    @classmethod
    @annotate("gnngls.dataset")
    def from_arrays(cls, data: dict, indices=None, scalers=None,
                    feat_drop_idx=()) -> "TSPDataset":
        """From a dataset dict (data/generate.py's arrays, with "regret");
        `indices` selects rows."""
        idx = np.arange(data["coords"].shape[0]) if indices is None else np.asarray(indices)
        return cls(coords=data["coords"][idx], features=None,
                   regret=np.asarray(data["regret"])[idx],
                   in_solution=np.asarray(data["in_solution"])[idx],
                   opt_cost=np.asarray(data["opt_cost"])[idx],
                   scalers=scalers or {}, feat_drop_idx=list(feat_drop_idx))

    @classmethod
    def from_npz(cls, npz_path, split_file=None, scalers_file=None,
                 feat_drop_idx=()) -> "TSPDataset":
        """An .npz shard; `split_file` holds 0-based row indices, one a line."""
        indices = None
        if split_file is not None:
            indices = np.loadtxt(split_file, dtype=np.int64, ndmin=1)
        scalers = load_scalers(scalers_file) if scalers_file else {}
        return cls.from_arrays(load_dataset(npz_path), indices, scalers, feat_drop_idx)

    @classmethod
    def from_reference_dir(cls, instances_file, scalers_file=None,
                           feat_drop_idx=()) -> "TSPDataset":
        """A reference dataset: `instances_file` lists pickled networkx graphs
        (paths relative to its folder, one a line) whose nodes carry "pos"
        and whose edges carry "weight", "features", "regret" and
        "in_solution"; the optimum is the weight of the in_solution edges.
        Scalers come from `scalers_file`, else from a `scalers.pkl` beside
        the listing when there is one."""
        import pickle

        instances_file = pathlib.Path(instances_file)
        root = instances_file.parent
        names = [ln.strip() for ln in open(instances_file) if ln.strip()]
        graphs = []
        for name in names:
            with open(root / name, "rb") as f:
                graphs.append(pickle.load(f))
        n = graphs[0].number_of_nodes()
        E = build_topology(n).n_edges
        N = len(graphs)
        coords = np.zeros((N, n, 2), dtype=np.float32)
        features = []
        regret = np.zeros((N, E), dtype=np.float32)
        in_sol = np.zeros((N, E), dtype=bool)
        opt_cost = np.zeros((N,), dtype=np.float64)
        for i, G in enumerate(graphs):
            for v in G.nodes:
                coords[i, v] = G.nodes[v]["pos"]
            width = len(np.atleast_1d(G.edges[next(iter(G.edges))]["features"]))
            feats = np.zeros((E, width), dtype=np.float32)
            for (u, v), d in G.edges.items():
                e = edge_index(n, u, v)
                feats[e] = d["features"]
                regret[i, e] = d.get("regret", 0.0)
                in_sol[i, e] = bool(d.get("in_solution", False))
            features.append(feats)
            opt_cost[i] = sum(d["weight"] for d in G.edges.values()
                              if d.get("in_solution", False))
        if scalers_file is None and (root / "scalers.pkl").exists():
            scalers_file = root / "scalers.pkl"
        scalers = load_scalers(scalers_file) if scalers_file is not None else {}
        return cls(coords=coords, features=np.stack(features), regret=regret,
                   in_solution=in_sol, opt_cost=opt_cost, scalers=scalers,
                   feat_drop_idx=list(feat_drop_idx))


def split_dataset(n_total: int, n_train: int, n_test: int, n_val: int,
                  seed: Optional[int] = None, rng=None):
    """Shuffled (train, val, test) index arrays.  The permutation is carved
    as train, then TEST, then val, the reference's order
    (scripts/preprocess_dataset.py)."""
    rng = np.random.default_rng(seed) if rng is None else rng
    perm = rng.permutation(n_total)
    train = perm[:n_train]
    test = perm[n_train:n_train + n_test]
    val = perm[n_train + n_test:n_train + n_test + n_val]
    return train, val, test
