"""The reference's graph-level API over networkx graphs (gnngls_tpu/compat.py).

The same names and signatures as gnngls_tpu.compat (the reference's
gnngls/__init__.py, datasets.py and algorithms.py), over the port's array
core, so code written against either ports by changing one import:

    from gnngls_tpu_torch import compat as gnngls

networkx and matplotlib are imported only by the functions that draw;
everything else reads a graph through its `nodes` and `edges` views.  The
exact solvers take the Concorde or LKH binary when one is on PATH, else
Held-Karp (the native oracle, or numpy).  `nearest_neighbor` and
`guided_local_search` run on `device`: the card unless "cpu" is asked for.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .utils import is_equivalent_tour, is_valid_tour  # noqa: F401  (the same API)


def _weight_matrix(G, weight: str = "weight") -> np.ndarray:
    n = G.number_of_nodes()
    D = np.zeros((n, n))
    for (u, v), data in G.edges.items():
        D[u, v] = D[v, u] = data[weight]
    return D


def tour_to_edge_attribute(G, tour) -> dict:
    """{edge: whether the closed tour uses it}, undirected."""
    tour_edges = set(zip(tour[:-1], tour[1:]))
    return {e: (e in tour_edges or tuple(reversed(e)) in tour_edges)
            for e in G.edges}


def tour_cost(G, tour, weight: str = "weight") -> float:
    return float(sum(G.edges[e][weight] for e in zip(tour[:-1], tour[1:])))


def optimal_cost(G, weight: str = "weight") -> float:
    """The summed weight of the edges marked 'in_solution'."""
    return float(sum(d[weight] for d in G.edges.values() if d["in_solution"]))


def optimal_tour(G, scale: float = 1e3):
    """An optimal tour: Concorde when its binary is on PATH, else Held-Karp
    (`scale` only matters for Concorde's integer coordinates)."""
    from .data import solvers

    if solvers.has_concorde():
        coords = np.vstack([G.nodes[i]["pos"] for i in sorted(G.nodes)])
        return solvers.concorde_tour(coords, scale=scale)
    D = _weight_matrix(G)
    try:
        from .data import native_oracle

        tour, _ = native_oracle.held_karp(D)
        return list(map(int, tour))
    except (RuntimeError, ValueError):
        tour, _ = solvers.held_karp(D)
        return tour


def fixed_edge_tour(G, e, scale: float = 1e3, lkh_path: str = "LKH", **kwargs):
    """A near-optimal tour through edge e: LKH when its binary is on PATH,
    else the exact forced-edge Held-Karp."""
    from .data import solvers

    if solvers.has_lkh(lkh_path):
        coords = np.vstack([G.nodes[i]["pos"] for i in sorted(G.nodes)])
        return solvers.lkh_fixed_edge_tour(coords, e, scale=scale,
                                           lkh_path=lkh_path, **kwargs)
    D = _weight_matrix(G)
    tour, _ = solvers.held_karp_fixed_edge(D, tuple(e))
    return tour


def plot_edge_attribute(G, attr, ax, **kwargs):
    """Draw G with its edges coloured by `attr` on a red alpha ramp."""
    import networkx as nx
    from matplotlib import colors

    cmap_colors = np.zeros((100, 4))
    cmap_colors[:, 0] = 1.0
    cmap_colors[:, 3] = np.linspace(0, 1, 100)
    cmap = colors.ListedColormap(cmap_colors)
    pos = nx.get_node_attributes(G, "pos")
    nx.draw(G, pos, edge_color=list(attr.values()), edge_cmap=cmap, ax=ax, **kwargs)


def set_features(G) -> None:
    """Each edge's 'features' = [weight] (f32)."""
    for e in G.edges:
        G.edges[e]["features"] = np.array([G.edges[e]["weight"]], dtype=np.float32)


def set_labels(G) -> None:
    """Each edge's 'regret': 0 on the optimal tour, else the relative excess
    of the best tour through it, floored at 0."""
    opt = optimal_cost(G)
    for e in G.edges:
        if G.edges[e]["in_solution"]:
            G.edges[e]["regret"] = 0.0
        else:
            tour = fixed_edge_tour(G, e)
            G.edges[e]["regret"] = max((tour_cost(G, tour) - opt) / opt, 0.0)


def nearest_neighbor(G, depot, weight: str = "weight", device=None):
    """Greedy tour over an edge attribute, on `device`."""
    from .evaluate import resolve_device
    from .search.construct import nearest_neighbor_batch

    W = torch.as_tensor(_weight_matrix(G, weight), dtype=torch.float32,
                        device=resolve_device(device))
    return [int(x) for x in nearest_neighbor_batch(W[None], depot)[0].cpu()]


def guided_local_search(G, init_tour, init_cost, t_lim, weight="weight",
                        guides=("weight",), perturbation_moves=30,
                        first_improvement=False, device=None):
    """GLS on the per-move engine, in one-iteration chunks until the absolute
    time.time() deadline `t_lim`, on `device`.  Returns (best_tour,
    best_cost, search_progress), a {time, cost} row for each accepted move
    (its cost after the move), stamped when its chunk ends."""
    from .search import batched

    D = _weight_matrix(G, weight).astype(np.float32)[None]
    guide_mats = np.stack([_weight_matrix(G, g).astype(np.float32) for g in guides])[None]
    init = np.asarray(init_tour, dtype=np.int32)[None]
    states = batched.batch_init(D, guide_mats, init, 4096, first_improvement, device=device)
    D_t, G_t = (torch.as_tensor(a, device=states.tour.device) for a in (D, guide_mats))
    progress = []
    prev_n = 0
    while time.time() < t_lim:
        states = batched.batch_chunk(states, D_t, G_t, 1, perturbation_moves,
                                     first_improvement)
        n_tr = int(states.trace.n[0])
        now = time.time()
        costs = states.trace.costs[0].cpu().numpy()
        for m in range(prev_n, min(n_tr, costs.shape[0])):
            progress.append({"time": now, "cost": float(costs[m])})
        prev_n = n_tr
    best_tour = [int(x) for x in states.best_tour[0].cpu()]
    return best_tour, float(states.best_cost[0]), progress
