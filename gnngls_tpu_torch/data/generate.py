"""Solved-instance generation and dataset arrays on disk
(gnngls_tpu/data/generate.py).

Instances are uniform random points in [0, 1]^2 with Euclidean weights, drawn
from `np.random.default_rng(seed)` as the JAX package draws them, so both
packages see bit-identical coordinates.  Best-known tours come from the tiered
oracle of data/solvers.py, chosen by gnngls_tpu's rule (`resolve_solver`):
Concorde when on PATH, exact Held-Karp for small n, else the GLS oracle.  A
dataset is a dict of dense arrays:
  coords (N, n, 2) f32, opt_tour (N, n+1) i32, opt_cost (N,) f64,
  in_solution (N, E) bool in the canonical edge order, regret (N, E) f32
  (data/labels.py),
saved as one .npz file.  `generate_instances_sharded` writes the JAX
package's resumable `gen_<start>.npz` shards, so either package resumes the
other's shard directory.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils import tour_to_edge_vector


def coords_to_distance_matrix(coords: np.ndarray) -> np.ndarray:
    """(..., n, 2) -> (..., n, n) Euclidean weights, f32."""
    d = coords[..., :, None, :] - coords[..., None, :, :]
    return np.sqrt((d * d).sum(-1)).astype(np.float32)


def coords_to_distance_tensor(coords: np.ndarray, device) -> torch.Tensor:
    """`coords_to_distance_matrix` built on `device`: the same (..., n, n) f32
    bits, as a tensor there.

    The differences, squares and their sum run in the coordinates' precision
    as separate operations (no fused multiply-add), as NumPy runs them; the
    square root runs in f64 and is rounded once to f32.  f64's 53 bits are at
    least twice f32's 24 plus two, so that gives the correctly rounded f32
    root, which NumPy's f32 sqrt gives and torch's f32 sqrt on the CPU does
    not always."""
    c = torch.as_tensor(np.asarray(coords), device=device)
    d = c[..., :, None, :] - c[..., None, :, :]
    sq = d * d
    return (sq[..., 0] + sq[..., 1]).double().sqrt_().float()


def resolve_solver(n_nodes: int, solver: Optional[str] = None) -> str:
    """The named solver, else gnngls_tpu's rule: "concorde" when a binary is
    on PATH, "held_karp" for n <= 16 (n <= 22 when the native oracle builds),
    else "gls"."""
    from . import native_oracle, solvers

    native_hk_max = 22  # the C++ DP stays tractable a bit past the numpy limit
    if solver is not None:
        return solver
    if solvers.has_concorde():
        return "concorde"
    if n_nodes <= solvers.HELD_KARP_MAX_N or (
            n_nodes <= native_hk_max and native_oracle.available()):
        return "held_karp"
    return "gls"


def solve_instances(coords: np.ndarray, solver: str, opt_iters: int = 25,
                    device=None) -> tuple:
    """Best-known (or exact) tours for a batch of coords: (tours (B, n+1) i32,
    costs (B,) f64).  opt_iters is the GLS budget per instance for "gls"
    (ignored by the exact solvers, which run on the host)."""
    from . import native_oracle, solvers

    D = coords_to_distance_matrix(coords)
    n_samples = coords.shape[0]

    if solver == "concorde":
        tours = np.stack([solvers.concorde_tour(c) for c in coords])
        costs = np.array([D[i][tours[i][:-1], tours[i][1:]].sum()
                          for i in range(n_samples)], dtype=np.float64)
    elif solver == "held_karp":
        if native_oracle.available():
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor() as ex:
                pairs = list(ex.map(lambda Di: native_oracle.held_karp(
                    Di.astype(np.float64)), D))
        else:
            pairs = [solvers.held_karp(Di) for Di in D]
        tours = np.stack([np.asarray(t, dtype=np.int32) for t, _ in pairs])
        costs = np.array([c for _, c in pairs], dtype=np.float64)
    elif solver == "gls":
        tours, costs = solvers.gls_oracle(D, n_iters=opt_iters, device=device)
        costs = costs.astype(np.float64)
    else:
        raise ValueError(f"unknown solver {solver!r}")
    return np.asarray(tours, dtype=np.int32), costs


def generate_instances(n_samples: int, n_nodes: int, seed: int = 0,
                       solver: Optional[str] = None, opt_iters: int = 25,
                       device=None) -> dict:
    """Solved instances.  solver: None (auto), "held_karp", "gls" or "concorde"."""
    rng = np.random.default_rng(seed)
    coords = rng.random((n_samples, n_nodes, 2)).astype(np.float32)
    solver = resolve_solver(n_nodes, solver)
    tours, costs = solve_instances(coords, solver, opt_iters, device=device)
    in_solution = np.stack([tour_to_edge_vector(n_nodes, t) for t in tours])
    return {
        "coords": coords,
        "opt_tour": tours,
        "opt_cost": costs,
        "in_solution": in_solution,
        "solver": np.array(solver),
        "n_nodes": np.array(n_nodes),
    }


def check_shard_meta(z, part, n_rows: int, row_key: str, **expect) -> None:
    """Validate a resume shard against the current run's parameters.

    Re-running a sharded stage with a different seed/chunk/n/solver must not
    silently merge stale shards.  Shards written before metadata existed
    carry no ``meta_*`` keys and are accepted as-is (row count still
    checked); any present key must match or the resume fails loudly.
    """
    if z[row_key].shape[0] != n_rows:
        raise ValueError(
            f"resume shard {part} holds {z[row_key].shape[0]} rows where "
            f"this run expects {n_rows} (chunk size changed?) — delete the "
            f"stale shard dir or re-run with matching parameters")
    files = getattr(z, "files", ())
    for k, v in expect.items():
        mk = f"meta_{k}"
        if mk in files and str(z[mk]) != str(v):
            raise ValueError(
                f"resume shard {part} was written with {k}={z[mk]!r} but "
                f"this run expects {k}={v!r} — delete the stale shard dir "
                f"or re-run with matching parameters")


def generate_instances_sharded(shard_dir, n_samples: int, n_nodes: int, *,
                               seed: int = 0, solver: Optional[str] = None,
                               opt_iters: int = 100, chunk: int = 512,
                               batch: int = 64, verbose: bool = True,
                               device=None) -> dict:
    """Crash-resumable instance generation: one gen_<start>.npz shard per chunk.

    A killed run resumes where it stopped (reference scripts/
    generate_instances.py writes one pickle per instance); the unit is a
    chunk shard, written by an atomic rename.  Chunk coords are drawn from
    default_rng((seed, chunk_start)), so a restart regenerates identical
    instances.  Returns the merged dataset dict; the shards stay on disk
    until the caller persists the merge.
    """
    import pathlib
    import time

    shard_dir = pathlib.Path(shard_dir)
    shard_dir.mkdir(parents=True, exist_ok=True)
    solver = resolve_solver(n_nodes, solver)

    parts = []
    for s in range(0, n_samples, chunk):
        m = min(chunk, n_samples - s)
        part = shard_dir / f"gen_{s:08d}.npz"
        parts.append(part)
        if part.exists():
            continue
        t0 = time.time()
        rng = np.random.default_rng((seed, s))
        coords = rng.random((m, n_nodes, 2)).astype(np.float32)
        tours = np.empty((m, n_nodes + 1), np.int32)
        costs = np.empty((m,), np.float64)
        for b in range(0, m, batch):
            e = min(b + batch, m)
            tours[b:e], costs[b:e] = solve_instances(coords[b:e], solver, opt_iters,
                                                     device=device)
        tmp = part.with_suffix(".tmp.npz")
        np.savez(tmp, coords=coords, opt_tour=tours, opt_cost=costs,
                 meta_seed=str(seed), meta_n_nodes=str(n_nodes),
                 meta_chunk=str(chunk), meta_solver=str(solver))
        tmp.rename(part)  # atomic: a crash mid-write never leaves a bad shard
        if verbose:
            print(f"[generate] {s + m}/{n_samples} "
                  f"({(time.time() - t0) / m:.2f}s/inst, {solver})",
                  flush=True)

    coords, tours, costs = [], [], []
    for s, part in zip(range(0, n_samples, chunk), parts):
        with np.load(part) as z:
            check_shard_meta(z, part, min(chunk, n_samples - s), "coords",
                             seed=seed, n_nodes=n_nodes, chunk=chunk,
                             solver=solver)
            coords.append(z["coords"])
            tours.append(z["opt_tour"])
            costs.append(z["opt_cost"])
    coords = np.concatenate(coords)
    tours = np.concatenate(tours)
    costs = np.concatenate(costs)
    if coords.shape[0] != n_samples:
        raise ValueError(f"shards in {shard_dir} hold {coords.shape[0]} instances, "
                         f"not {n_samples}")
    in_solution = np.stack([tour_to_edge_vector(n_nodes, t) for t in tours])
    return {
        "coords": coords,
        "opt_tour": tours,
        "opt_cost": costs,
        "in_solution": in_solution,
        "solver": np.array(solver),
        "n_nodes": np.array(n_nodes),
    }


def save_dataset(path, data: dict) -> None:
    np.savez_compressed(path, **data)


def load_dataset(path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
