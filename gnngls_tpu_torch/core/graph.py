"""Static K_n line-graph topology (host numpy), as in gnngls_tpu/core/graph.py.

Edges of K_n are the pairs (u, v), u < v, in lexicographic order.  For each
city u the n-1 edges incident to u form the group S_u, ordered by the other
endpoint; a line-graph node (u, v) attends over S_u and S_v minus itself.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch


class LineGraphTopology(NamedTuple):
    n: int
    n_edges: int
    edges: np.ndarray  # (E, 2) int32
    city_edges: np.ndarray  # (n, n-1) int32 edge ids of S_u
    slot_u: np.ndarray  # (E,) slot of edge (u, v) in the u-group: u*(n-1) + v-1
    slot_v: np.ndarray  # (E,) slot in the v-group: v*(n-1) + u

    @property
    def nbr(self) -> np.ndarray:
        """(E, 2(n-2)) int32 explicit neighbour lists, for the naive path only.
        Built on first use: at n=500 it is 0.5 GB (2 GB while it is built)."""
        return _neighbour_lists(self.n)


def n_edges(n: int) -> int:
    return n * (n - 1) // 2


def n_from_edges(E: int) -> int:
    """The n of K_n with E = n(n-1)/2 edges; raises for any other E."""
    n = int(round((1 + (1 + 8 * E) ** 0.5) / 2))
    if n_edges(n) != E:
        raise ValueError(f"{E} is not the edge count of a complete graph")
    return n


def edge_index(n: int, u, v):
    """Edge id of the pair (u, v) in the canonical order (vectorised)."""
    u, v = np.minimum(u, v), np.maximum(u, v)
    return u * (2 * n - u - 1) // 2 + (v - u - 1)


@functools.lru_cache(maxsize=64)
def build_topology(n: int) -> LineGraphTopology:
    if n < 3:
        raise ValueError(f"K_n line graph needs n >= 3, got n={n}")
    E = n_edges(n)
    us, vs = np.triu_indices(n, k=1)
    edges = np.stack([us, vs], axis=1).astype(np.int32)
    edge_id = np.full((n, n), -1, dtype=np.int32)
    eids = np.arange(E, dtype=np.int32)
    edge_id[us, vs] = eids
    edge_id[vs, us] = eids
    others = np.arange(n)[None, :].repeat(n, 0)
    others = others[others != np.arange(n)[:, None]].reshape(n, n - 1)
    city_edges = edge_id[np.arange(n)[:, None], others].astype(np.int32)
    slot_u = (us * (n - 1) + (vs - 1)).astype(np.int32)
    slot_v = (vs * (n - 1) + us).astype(np.int32)
    return LineGraphTopology(n, E, edges, city_edges, slot_u, slot_v)


@functools.lru_cache(maxsize=8)
def _neighbour_lists(n: int) -> np.ndarray:
    topo = build_topology(n)
    us, vs = topo.edges[:, 0], topo.edges[:, 1]
    eids = np.arange(topo.n_edges, dtype=np.int32)
    su_all, sv_all = topo.city_edges[us], topo.city_edges[vs]
    su = su_all[su_all != eids[:, None]].reshape(topo.n_edges, n - 2)
    sv = sv_all[sv_all != eids[:, None]].reshape(topo.n_edges, n - 2)
    return np.concatenate([su, sv], axis=1).astype(np.int32)


def weights_to_edge_vector(D: np.ndarray) -> np.ndarray:
    """The (..., E) per-edge vector of (..., n, n) symmetric matrices, in the
    canonical edge order."""
    n = D.shape[-1]
    us, vs = np.triu_indices(n, k=1)
    return D[..., us, vs]


def edge_vector_to_matrix(x: np.ndarray, n: int, diag=0.0) -> np.ndarray:
    """Scatter an (..., E) per-edge vector to a symmetric (..., n, n) matrix."""
    us, vs = np.triu_indices(n, k=1)
    M = np.full(x.shape[:-1] + (n, n), diag, dtype=x.dtype)
    M[..., us, vs] = x
    M[..., vs, us] = x
    return M


@functools.lru_cache(maxsize=32)
def edge_positions(n: int, device: torch.device, transpose: bool = False) -> torch.Tensor:
    """The flat positions u * n + v of K_n's edges (u, v), in the canonical
    order, in a row-major n x n matrix, on `device`; v * n + u with
    `transpose`."""
    u, v = build_topology(n).edges.astype(np.int64).T[::-1 if transpose else 1]
    return torch.as_tensor(u * n + v, device=device)


def edge_tensor_to_matrix(x: torch.Tensor, n: int) -> torch.Tensor:
    """Scatter an (..., E) per-edge tensor to symmetric (..., n, n) matrices
    with 0 on the diagonal, on x's device: the values `edge_vector_to_matrix`
    places."""
    M = x.new_zeros(x.shape[:-1] + (n * n,))
    for transpose in (False, True):
        M.index_copy_(-1, edge_positions(n, x.device, transpose), x)
    return M.unflatten(-1, (n, n))
