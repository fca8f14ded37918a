"""Solved-instance generation and dataset arrays on disk
(gnngls_tpu/data/generate.py).

Instances are uniform random points in [0, 1]^2 with Euclidean weights, drawn
from `np.random.default_rng(seed)` as the JAX package draws them, so both
packages see bit-identical coordinates.  Best-known tours come from the GLS
oracle (data/solvers.py).  A dataset is a dict of dense arrays:
  coords (N, n, 2) f32, opt_tour (N, n+1) i32, opt_cost (N,) f64,
  in_solution (N, E) bool in the canonical edge order,
saved as one .npz file.  The exact solvers ("held_karp", "concorde") wait for
the data-generation slice of the port.
"""

from __future__ import annotations

import shutil
from typing import Optional

import numpy as np

from ..utils import tour_to_edge_vector

# Above every Held-Karp range of gnngls_tpu's rule (its numpy and native
# solvers stop at n=22), the JAX package takes the GLS oracle too.
EXACT_MAX_N = 22
_EXACT = ("held_karp", "concorde")


def coords_to_distance_matrix(coords: np.ndarray) -> np.ndarray:
    """(..., n, 2) -> (..., n, n) Euclidean weights, f32."""
    d = coords[..., :, None, :] - coords[..., None, :, :]
    return np.sqrt((d * d).sum(-1)).astype(np.float32)


def resolve_solver(n_nodes: int, solver: Optional[str] = None) -> str:
    """The oracle for n_nodes: "gls" for n > 22 when none is named.

    gnngls_tpu names "concorde" at every n when a `concorde` binary is on
    PATH; until the exact solvers are ported that raises here, so that the
    two packages never label the same instances with different oracles."""
    if solver is None:
        if shutil.which("concorde"):
            raise NotImplementedError(
                "a concorde binary is on PATH, so gnngls_tpu would label with solver "
                "'concorde', which waits for the data-generation slice of the port; "
                "pass solver='gls'")
        if n_nodes <= EXACT_MAX_N:
            raise NotImplementedError(
                f"n={n_nodes} <= {EXACT_MAX_N} takes an exact solver in gnngls_tpu, "
                "which waits for the data-generation slice of the port; pass solver='gls'")
        return "gls"
    if solver in _EXACT:
        raise NotImplementedError(f"solver {solver!r} waits for the data-generation "
                                  "slice of the port; use solver='gls'")
    if solver != "gls":
        raise ValueError(f"unknown solver {solver!r}")
    return solver


def solve_instances(coords: np.ndarray, solver: str, opt_iters: int = 25,
                    device=None) -> tuple:
    """(tours (B, n+1) i32, costs (B,) f64) for a batch of coords; opt_iters
    is the GLS budget per instance."""
    from . import solvers

    solver = resolve_solver(coords.shape[-2], solver)
    D = coords_to_distance_matrix(coords)
    tours, costs = solvers.gls_oracle(D, n_iters=opt_iters, device=device)
    return np.asarray(tours, dtype=np.int32), costs.astype(np.float64)


def generate_instances(n_samples: int, n_nodes: int, seed: int = 0,
                       solver: Optional[str] = None, opt_iters: int = 25,
                       device=None) -> dict:
    """Solved instances.  solver: None (auto) or "gls"."""
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


def save_dataset(path, data: dict) -> None:
    np.savez_compressed(path, **data)


def load_dataset(path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
