"""Regret labels (gnngls_tpu/data/labels.py; reference gnngls/datasets.py:14-34).

Features: per-edge vector = [weight], canonical edge order (`edge_features`).
Labels: regret(e) = 0 if e is in the optimal tour, else
  (cost of the best tour forced through e - opt_cost) / opt_cost.

The reference's per-edge LKH loop becomes one batch of forced-edge searches
on the whole-GLS kernel (data/solvers.py), exact Held-Karp solves for small
n, or the native C++ oracle.
"""

from __future__ import annotations

import numpy as np

from ..core.graph import build_topology
from .dataset import edge_features  # noqa: F401  (public API, as in gnngls_tpu)
from .generate import check_shard_meta, coords_to_distance_matrix

MAX_TOUR_BYTES = 1 << 30  # the lane tours of one oracle call, on the host


def warm_labels_chunked(data: dict, shard_dir, *, chunk: int = 250,
                        warm_gls_iters: int = 0, dual_splice: bool = True,
                        perturbation_moves: int = 20,
                        max_chunks: int | None = None,
                        verbose: bool = False, device=None) -> dict | None:
    """Production regret labels: the warm-start forced-edge oracle, resumable.

    Every forced-edge problem of an instance is solved warm-started from its
    best-known tour (solvers.warm_fixed_edge_costs_batch, called on groups of
    instances whose lane tours, B * S * E * (n+1) int32, fit MAX_TOUR_BYTES,
    at least one instance a call: the host's buffers grow with the group,
    not the shard); where a forced-edge tour beats the best-known, it
    REFINES the best-known and the instance's regrets are measured against
    the refined optimum.

    Shards of `chunk` instances are written to `shard_dir` as
    labels_<start>.npz (atomic rename); on restart the existing shards are
    loaded by their filename offsets (their sizes may vary across runs),
    gaps from lost shards are recomputed with exactly-sized shards, and
    labelling continues past the last shard.  The shards are those of
    gnngls_tpu, so either package resumes the other's directory.

    `max_chunks` bounds the NEW shards computed by this call; when it stops
    the run early the function returns None (callers exit and relaunch).
    gnngls_tpu's duty cycle (an idle pause every 45 instances for its TPU
    worker) is left out: it changes no label.

    Updates data's regret, opt_tour, opt_cost and in_solution in place and
    returns it, or None if max_chunks stopped the run before completion.
    """
    import pathlib
    import tempfile
    import time

    from ..utils import tour_to_edge_vector
    from . import solvers

    if shard_dir is None:  # no resumability requested
        shard_dir = tempfile.mkdtemp(prefix="warm_labels_")
    shard_dir = pathlib.Path(shard_dir)
    shard_dir.mkdir(parents=True, exist_ok=True)
    coords = data["coords"]
    N, n, _ = coords.shape
    topo = build_topology(n)
    Ds = coords_to_distance_matrix(coords).astype(np.float64)

    regret = np.zeros((N, topo.n_edges), dtype=np.float32)
    opt_tour = np.asarray(data["opt_tour"], dtype=np.int32).copy()
    opt = Ds[np.arange(N)[:, None], opt_tour[:, :-1], opt_tour[:, 1:]].sum(-1)
    lane_tours = (2 if dual_splice else 1) * topo.n_edges * (n + 1) * 4  # bytes an instance
    group = max(1, MAX_TOUR_BYTES // lane_tours)

    def compute_shard(s, e):
        t0 = time.time()
        for g in range(s, e, group):
            h = min(g + group, e)
            costs_all, _, tours_all = solvers.warm_fixed_edge_costs_batch(
                Ds[g:h], topo.edges, opt_tour[g:h], n_gls_iters=warm_gls_iters,
                perturbation_moves=perturbation_moves, dual_splice=dual_splice,
                device=device)
            for i, costs, tours in zip(range(g, h), costs_all, tours_all):
                j = int(costs.argmin())
                if costs[j] < opt[i] - 1e-9:
                    opt[i] = costs[j]
                    opt_tour[i] = tours[j]
                r = (costs - opt[i]) / opt[i]
                r[tour_to_edge_vector(n, opt_tour[i])] = 0.0
                regret[i] = np.maximum(r, 0.0)
        part = shard_dir / f"labels_{s:08d}.npz"
        tmp = part.with_suffix(".tmp.npz")
        np.savez(tmp, regret=regret[s:e], opt_tour=opt_tour[s:e],
                 opt_cost=opt[s:e], meta_n_nodes=str(n),
                 meta_warm_gls_iters=str(warm_gls_iters),
                 meta_perturbation_moves=str(perturbation_moves),
                 meta_dual_splice=str(dual_splice))
        tmp.rename(part)
        if verbose:
            print(f"[labels] {e}/{N} ({(time.time() - t0) / (e - s):.2f}s/inst)",
                  flush=True)

    existing = []
    for part in sorted(shard_dir.glob("labels_*.npz")):
        if ".tmp" in part.name:  # interrupted atomic write
            continue
        existing.append((int(part.stem.split("_")[1]), part))
    done, new_chunks = 0, 0
    budget_hit = False

    def budget():
        nonlocal new_chunks
        if max_chunks is not None and new_chunks >= max_chunks:
            return True
        new_chunks += 1
        return False

    for offset, part in existing:
        if offset >= N:
            break
        if offset < done:
            raise ValueError(
                f"overlapping label shards at {part} (starts {offset}, "
                f"{done} labels already loaded) — remove stale shards")
        while done < offset and not budget_hit:  # fill a lost-shard gap
            if budget():
                budget_hit = True
                break
            e = min(done + chunk, offset)
            compute_shard(done, e)
            done = e
        if budget_hit:
            break
        with np.load(part) as z:
            k = z["regret"].shape[0]
            check_shard_meta(
                z, part, k, "regret", n_nodes=n,
                warm_gls_iters=warm_gls_iters,
                perturbation_moves=perturbation_moves,
                dual_splice=dual_splice)
            if offset + k > N:
                raise ValueError(
                    f"label shard {part} extends past the dataset "
                    f"({offset}+{k} > {N}) — stale shard dir?")
            regret[offset:offset + k] = z["regret"]
            opt_tour[offset:offset + k] = z["opt_tour"]
            opt[offset:offset + k] = z["opt_cost"]
        done = offset + k
    while done < N and not budget_hit:
        if budget():
            budget_hit = True
            break
        e = min(done + chunk, N)
        compute_shard(done, e)
        done = e
    if budget_hit:
        return None  # bounded bout: the caller exits and relaunches

    data["regret"] = regret
    data["opt_tour"] = opt_tour
    data["opt_cost"] = opt
    data["in_solution"] = np.stack(
        [tour_to_edge_vector(n, t) for t in opt_tour])
    return data


def compute_regret(data: dict, *, method: str = "auto", n_iters: int = 10,
                   perturbation_moves: int = 30, verbose: bool = False,
                   device=None) -> np.ndarray:
    """Per-edge regret labels for a generated dataset dict.

    method: 'auto' | 'held_karp' | 'gls' | 'native' | 'lkh' | 'warm'; 'auto'
    takes LKH when on PATH, then the native oracle for n <= 22, then
    Held-Karp for n <= 16, else 'warm'.  `device` runs the 'gls' and 'warm'
    oracles ("cuda" unless "cpu" is asked for).  Returns (N, E) f32 and
    stores it in data['regret'].
    """
    from . import native_oracle, solvers

    coords = data["coords"]
    N, n, _ = coords.shape
    topo = build_topology(n)
    E = topo.n_edges
    opt_cost = np.asarray(data["opt_cost"], dtype=np.float64)
    in_sol = np.asarray(data["in_solution"], dtype=bool)

    if method == "auto":
        if solvers.has_lkh():
            method = "lkh"
        elif native_oracle.available() and n <= 22:
            method = "native"
        elif n <= solvers.HELD_KARP_MAX_N:
            method = "held_karp"
        else:
            method = "warm"

    if method == "warm":
        warm_labels_chunked(data, None, verbose=verbose, device=device)
        return data["regret"]

    regret = np.zeros((N, E), dtype=np.float32)
    Ds = coords_to_distance_matrix(coords).astype(np.float64)

    if method == "native":  # the C++ oracle, threaded across instances
        costs_all = native_oracle.regret_costs_batch(Ds)
        r = (costs_all - opt_cost[:, None]) / opt_cost[:, None]
        r[in_sol] = 0.0
        regret = np.maximum(r, 0.0).astype(np.float32)
        data["regret"] = regret
        return regret

    for i in range(N):
        D = Ds[i]
        if method == "held_karp":
            costs = np.empty(E)
            for e in range(E):
                if in_sol[i, e]:
                    costs[e] = opt_cost[i]
                else:
                    _, costs[e] = solvers.held_karp_fixed_edge(D, tuple(topo.edges[e]))
        elif method == "gls":
            costs, used = solvers.gls_fixed_edge_costs(
                D, topo.edges, n_iters=n_iters,
                perturbation_moves=perturbation_moves, device=device)
            # rare: the forced edge dropped by the heuristic -> exact solve for
            # small n, else the (upper-bound) unforced cost is kept
            if not used.all() and n <= solvers.HELD_KARP_MAX_N:
                for e in np.flatnonzero(~used):
                    _, costs[e] = solvers.held_karp_fixed_edge(D, tuple(topo.edges[e]))
        elif method == "lkh":
            costs = np.empty(E)
            for e in range(E):
                if in_sol[i, e]:
                    costs[e] = opt_cost[i]
                else:
                    t = np.asarray(solvers.lkh_fixed_edge_tour(coords[i],
                                                               tuple(topo.edges[e])))
                    costs[e] = D[t[:-1], t[1:]].sum()
        else:
            raise ValueError(f"unknown method {method!r}")

        r = (costs - opt_cost[i]) / opt_cost[i]
        r[in_sol[i]] = 0.0  # solution edges have zero regret
        regret[i] = np.maximum(r, 0.0)  # heuristic oracles may dip epsilon-negative
        if verbose and (i + 1) % 50 == 0:
            print(f"regret labels: {i + 1}/{N}")

    data["regret"] = regret
    return regret
