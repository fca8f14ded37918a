"""TSP oracles for generated instances and their regret labels
(gnngls_tpu/data/solvers.py).

* `held_karp`, `held_karp_fixed_edge`: exact bitmask DP (numpy) for
  n <= HELD_KARP_MAX_N; a forced edge by the exact big-M reduction.
* `gls_oracle`: weight-guided fixed-budget GLS from a nearest-neighbour start,
  run by `search.batched.run_fixed_kernel`.
* The forced-edge label oracles, one K1 lane per forced-edge problem:
  `gls_fixed_edge_costs` (cold: nearest neighbour on the reduced matrix, then
  GLS) and `warm_fixed_edge_costs[_batch]` (the best-known tour with the edge
  spliced in, then a local search and optionally a few GLS iterations).  Each
  lane searches its big-M-reduced matrix D2 with D2 as its only guide and the
  penalty scale k taken from the unreduced matrix, the whole-GLS kernel's
  k input.  The D2 stack is built on the device in launches of at most
  `MAX_D2_BYTES` bytes (read at each call); that is the only way the lanes
  are split.
* `concorde_tour`, `lkh_fixed_edge_tour`: the external binaries, when on PATH.

Everything on the device runs through the whole-GLS kernel on the card and
its plain twin on the CPU.  If the kernel fails, the oracle raises; nothing
falls back to another engine.
"""

from __future__ import annotations

import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

HELD_KARP_MAX_N = 16
MAX_D2_BYTES = 1 << 31  # the reduced matrices of one kernel launch


def held_karp(D: np.ndarray) -> Tuple[list, float]:
    """Exact TSP via Held-Karp DP.  Returns (closed tour from 0, cost).

    O(2^n * n^2); intended for n <= HELD_KARP_MAX_N.
    """
    D = np.asarray(D, dtype=np.float64)
    n = D.shape[0]
    if n > HELD_KARP_MAX_N:
        raise ValueError(f"held_karp limited to n<={HELD_KARP_MAX_N}, got {n}")
    if n == 2:
        return [0, 1, 0], float(D[0, 1] * 2)
    m = n - 1  # cities 1..n-1
    full = 1 << m
    dp = np.full((full, m), np.inf)
    parent = np.full((full, m), -1, dtype=np.int32)
    for j in range(m):
        dp[1 << j, j] = D[0, j + 1]
    Dsub = D[1:, 1:]  # (m, m)
    for mask in range(1, full):
        row = dp[mask]
        if not np.isfinite(row).any():
            continue
        js = np.flatnonzero(np.isfinite(row))
        # extend to every k not in mask
        ext = row[js, None] + Dsub[js, :]  # (|js|, m)
        arg = np.argmin(ext, axis=0)
        best = ext[arg, np.arange(m)]
        for k in range(m):
            if mask & (1 << k):
                continue
            nmask = mask | (1 << k)
            if best[k] < dp[nmask, k]:
                dp[nmask, k] = best[k]
                parent[nmask, k] = js[arg[k]]
    fullmask = full - 1
    tot = dp[fullmask] + D[1:, 0]
    j = int(np.argmin(tot))
    cost = float(tot[j])
    tour = [0]
    mask, cur = fullmask, j
    rev = []
    while cur != -1:
        rev.append(cur + 1)
        pj = parent[mask, cur]
        mask &= ~(1 << cur)
        cur = pj
    tour += rev[::-1] + [0]
    return tour, cost


def held_karp_fixed_edge(D: np.ndarray, e: Tuple[int, int]) -> Tuple[list, float]:
    """Exact optimal tour constrained to use edge e (big-M reduction)."""
    D = np.asarray(D, dtype=np.float64)
    M = D.sum() + 1.0
    D2 = D.copy()
    u, v = e
    D2[u, v] -= M
    D2[v, u] -= M
    tour, cost = held_karp(D2)
    return tour, float(cost + M)


def gls_oracle(Ds: np.ndarray, *, n_iters: int = 25, perturbation_moves: int = 30,
               device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Ds (B, n, n) -> (tours (B, n+1) int32, costs (B,) f64: f32 sums of D
    along the tours).  `device` is "cuda" unless the caller asks for "cpu"."""
    from ..evaluate import resolve_device
    from ..search import batched

    dev = resolve_device(device)
    Ds = np.ascontiguousarray(Ds, dtype=np.float32)
    inits = batched.nearest_neighbor_batch(torch.as_tensor(Ds, device=dev)).cpu().numpy()
    res = batched.run_fixed_kernel(Ds, Ds[:, None], inits, n_iters=n_iters,
                                   perturbation_moves=perturbation_moves, device=dev)
    return res.best_tours.astype(np.int32), res.best_costs


# ---------------------------------------------------------------------------
# Forced-edge label oracles on the whole-GLS kernel


def _launches(n_lanes: int, n: int):
    """Lane ranges [s, e) whose reduced (n, n) f32 matrices fit MAX_D2_BYTES."""
    width = max(1, MAX_D2_BYTES // (4 * n * n))
    return [(s, min(s + width, n_lanes)) for s in range(0, n_lanes, width)]


def _reduced(D32: torch.Tensor, inst: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
             at_uv: torch.Tensor, at_vu: torch.Tensor) -> torch.Tensor:
    """The (L, n, n) stack D32[inst] with entry (u, v) of lane l set to
    at_uv[l] and (v, u) to at_vu[l]."""
    D2 = D32[inst]
    lane = torch.arange(D2.shape[0], device=D2.device)
    D2[lane, u, v] = at_uv
    D2[lane, v, u] = at_vu
    return D2


def _costs64(Ds64: np.ndarray, tours: np.ndarray) -> np.ndarray:
    """(B, n, n) f64 and (B, E, n+1) tours -> (B, E) f64 tour costs."""
    B = Ds64.shape[0]
    return Ds64[np.arange(B)[:, None, None], tours[..., :-1], tours[..., 1:]].sum(axis=-1)


def _uses_edge(tours: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """(..., n+1) tours and (E, 2) edges, the tours' second-to-last axis
    running over E -> (..., E) whether each tour holds its edge."""
    a, b = tours[..., :-1], tours[..., 1:]
    eu, ev = edges[:, :1], edges[:, 1:2]
    return (((a == eu) & (b == ev)) | ((a == ev) & (b == eu))).any(axis=-1)


def cold_lanes(D: np.ndarray, edges: np.ndarray, *, device=None):
    """The kernel inputs of `gls_fixed_edge_costs`, launch by launch: yields
    (s, e, D2 (L, n, n) f32, init (L, n+1) int32, k (L,) f32) for lanes
    s..e-1 (edges[s:e]) on `device`.  D2 is the big-M reduction (M = sum(D)
    + 1, built in f64 and rounded to f32), init the nearest-neighbour tour on
    D2, k = 0.1 * (init's f32 cost on D) / n."""
    from ..evaluate import resolve_device
    from ..search import construct
    from ..search import moves as mv
    from ..search.local_search import penalty_scale

    dev = resolve_device(device)
    D = np.asarray(D, dtype=np.float64)
    n = D.shape[0]
    M = float(D.sum() + 1.0)
    edges = np.asarray(edges)
    D32 = torch.as_tensor(D.astype(np.float32), device=dev)[None]
    at_uv, at_vu = (torch.as_tensor((D[a, b] - M).astype(np.float32), device=dev)
                    for a, b in ((edges[:, 0], edges[:, 1]), (edges[:, 1], edges[:, 0])))
    uv = torch.as_tensor(edges, dtype=torch.long, device=dev)
    for s, e in _launches(edges.shape[0], n):
        zero = torch.zeros(e - s, dtype=torch.long, device=dev)
        D2 = _reduced(D32, zero, uv[s:e, 0], uv[s:e, 1], at_uv[s:e], at_vu[s:e])
        init = construct.nearest_neighbor_batch(D2)
        k = penalty_scale(mv.tour_costs(D32.expand(e - s, n, n), init.long()), n)
        yield s, e, D2, init, k
        del D2  # one launch's stack at a time


def gls_fixed_edge_costs(D: np.ndarray, edges: np.ndarray, *, n_iters: int = 10,
                         perturbation_moves: int = 30, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Near-optimal tour cost through each forced edge of one instance.

    Each lane solves one forced-edge problem from scratch (`cold_lanes`):
    nearest neighbour on its big-M reduction D2, then GLS on D2 with D2 as
    the guide and the unreduced k.  The cost is the kernel's f32 search cost
    plus M.

    Returns (costs (E,) f64, used (E,) bool: whether the forced edge is in the
    returned tour)."""
    from ..search import gls_whole

    D = np.asarray(D, dtype=np.float64)
    n = D.shape[0]
    M = float(D.sum() + 1.0)
    edges = np.asarray(edges)
    costs = np.empty((edges.shape[0],), dtype=np.float64)
    tours = np.empty((edges.shape[0], n + 1), dtype=np.int32)
    for s, e, D2, init, k in cold_lanes(D, edges, device=device):
        out = gls_whole.gls_whole(D2, D2, init, n_iters=n_iters,
                                  perturbation_moves=perturbation_moves, k=k)
        costs[s:e] = out.best_costs.cpu().numpy().astype(np.float64) + M
        tours[s:e] = out.best_tours.cpu().numpy()
        del D2  # before the next launch's stack is built
    return costs, _uses_edge(tours, edges)


def _splice(tours: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
            before: torch.Tensor) -> torch.Tensor:
    """Make (u, v) adjacent in each tour by one relocate of v: after u, or
    before u where `before` (for u = 0, before the closing depot).  Tours that
    hold the edge already are kept.  Canonical edges have u < v, so v is
    never the depot."""
    from ..search import moves as mv

    nt = tours.shape[1]
    a, b = tours[:, :-1], tours[:, 1:]
    u, v = u[:, None], v[:, None]
    contained = (((a == u) & (b == v)) | ((a == v) & (b == u))).any(dim=1)
    pos_u = (a == u).int().argmax(dim=1)
    pos_v = (a == v).int().argmax(dim=1)
    u = u[:, 0]
    j_before = torch.where(u == 0, nt - 2, torch.where(pos_v > pos_u, pos_u, pos_u - 1))
    j_after = torch.where(u == 0, 1, torch.where(pos_v > pos_u, pos_u + 1, pos_u))
    moved = mv.apply_relocate(tours, pos_v, torch.where(before, j_before, j_after))
    return torch.where(contained[:, None], tours, moved)


def warm_lanes(Ds: np.ndarray, edges: np.ndarray, best_tours: np.ndarray, *,
               dual_splice: bool = True, device=None):
    """The kernel inputs of `warm_fixed_edge_costs_batch`, launch by launch:
    yields (s, e, D2 (L, n, n) f32, init (L, n+1) int32, k (L,) f32) for
    lanes s..e-1 on `device`.  Lane (b * S + splice) * E + edge, S = 2 with
    `dual_splice` (splice 1: v before u) else 1.  D2 = D less M at (u, v)
    and (v, u), M = n * max(D) + 1 rounded to f32, in f32; init the best-known
    tour with the edge spliced in; k = 0.1 * (the best-known tour's f32 cost
    on D) / n."""
    from ..evaluate import resolve_device
    from ..search import moves as mv
    from ..search.local_search import penalty_scale

    dev = resolve_device(device)
    Ds64 = np.asarray(Ds, dtype=np.float64)
    B, n, _ = Ds64.shape
    E = np.asarray(edges).shape[0]
    S = 2 if dual_splice else 1
    D32 = torch.as_tensor(Ds64.astype(np.float32), device=dev)
    Ms = torch.as_tensor(np.array([n * Ds64[i].max() + 1.0 for i in range(B)],
                                  dtype=np.float32), device=dev)
    best = torch.as_tensor(np.asarray(best_tours), dtype=torch.long, device=dev)
    k = penalty_scale(mv.tour_costs(D32, best), n)
    uv = torch.as_tensor(np.asarray(edges), dtype=torch.long, device=dev)
    for s, e in _launches(B * S * E, n):
        lane = torch.arange(s, e, device=dev)
        inst, before, edge = lane // (S * E), (lane // E) % S == 1, lane % E
        u, v = uv[edge, 0], uv[edge, 1]
        D2 = _reduced(D32, inst, u, v, D32[inst, u, v] - Ms[inst], D32[inst, v, u] - Ms[inst])
        yield s, e, D2, _splice(best[inst], u, v, before).to(torch.int32), k[inst]
        del D2  # one launch's stack at a time


def warm_fixed_edge_costs_batch(Ds: np.ndarray, edges: np.ndarray, best_tours: np.ndarray,
                                *, n_gls_iters: int = 0, perturbation_moves: int = 20,
                                dual_splice: bool = True, device=None):
    """Near-optimal tour cost through each forced edge of each instance,
    warm-started from its best-known tour.

    One lane per (instance, splice, edge) (`warm_lanes`): the edge spliced
    into the best-known tour, then on its big-M reduction D2 the kernel's
    initial local search and `n_gls_iters` GLS iterations with D2 as the
    guide and the unreduced k.  With `dual_splice` each edge also runs from
    the v-before-u splice, and that lane's tour wins where its search cost is
    strictly smaller.  Costs are re-derived from the tours in f64 on the
    host, so M never touches them.

    Ds (B, n, n), edges (E, 2), best_tours (B, n+1).  Returns (costs (B, E)
    f64, used (B, E) bool, tours (B, E, n+1) int32).  The host holds the
    B * S * E lane tours and a (B, E, n) f64 gather, so callers bound B
    (`labels.warm_labels_chunked` by `labels.MAX_TOUR_BYTES`)."""
    from ..search import gls_whole

    Ds64 = np.asarray(Ds, dtype=np.float64)
    B, n, _ = Ds64.shape
    edges = np.asarray(edges)
    E = edges.shape[0]
    S = 2 if dual_splice else 1
    tours = torch.empty((B * S * E, n + 1), dtype=torch.int32)
    search = torch.empty((B * S * E,), dtype=torch.float32)
    for s, e, D2, init, k in warm_lanes(Ds64, edges, best_tours, dual_splice=dual_splice,
                                        device=device):
        out = gls_whole.gls_whole(D2, D2, init, n_iters=n_gls_iters,
                                  perturbation_moves=perturbation_moves, k=k)
        tours[s:e] = out.best_tours.cpu()
        search[s:e] = out.best_costs.cpu()
        del D2  # before the next launch's stack is built
    tours = tours.view(B, S, E, n + 1)
    search = search.view(B, S, E)
    if dual_splice:
        tours = torch.where((search[:, 1] < search[:, 0])[..., None], tours[:, 1], tours[:, 0])
    else:
        tours = tours[:, 0]
    tours = tours.numpy()
    return _costs64(Ds64, tours), _uses_edge(tours, edges), tours


def warm_fixed_edge_costs(D: np.ndarray, edges: np.ndarray, best_tour: np.ndarray, *,
                          n_gls_iters: int = 2, perturbation_moves: int = 20,
                          dual_splice: bool = False, device=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """`warm_fixed_edge_costs_batch` for one instance (with gnngls_tpu's
    defaults for one instance).  Returns (costs (E,) f64, used (E,) bool,
    tours (E, n+1) int32)."""
    costs, used, tours = warm_fixed_edge_costs_batch(
        np.asarray(D)[None], edges, np.asarray(best_tour)[None], n_gls_iters=n_gls_iters,
        perturbation_moves=perturbation_moves, dual_splice=dual_splice, device=device)
    return costs[0], used[0], tours[0]


# ---------------------------------------------------------------------------
# External C solvers (used when on PATH)


def has_concorde() -> bool:
    return shutil.which("concorde") is not None


def has_lkh(lkh_path: str = "LKH") -> bool:
    return shutil.which(lkh_path) is not None


def _write_tsplib(path: Path, coords: np.ndarray, scale: float,
                  fixed_edge: Optional[Sequence[int]] = None) -> None:
    n = coords.shape[0]
    with open(path, "w") as f:
        f.write("NAME: TSP\nTYPE: TSP\n")
        f.write(f"DIMENSION: {n}\nEDGE_WEIGHT_TYPE: EUC_2D\n")
        f.write("NODE_COORD_SECTION\n")
        for i, (x, y) in enumerate(coords):
            f.write(f"{i + 1} {x * scale:.0f} {y * scale:.0f}\n")
        if fixed_edge is not None:
            u, v = fixed_edge
            f.write(f"FIXED_EDGES_SECTION\n{u + 1} {v + 1}\n-1\n")
        f.write("EOF\n")


def concorde_tour(coords: np.ndarray, scale: float = 1e6) -> list:
    """Optimal tour via the Concorde binary (reference gnngls/__init__.py:47-52)."""
    if not has_concorde():
        raise RuntimeError("concorde binary not on PATH")
    with tempfile.TemporaryDirectory() as td:
        tsp = Path(td) / "p.tsp"
        _write_tsplib(tsp, coords, scale)
        sol = Path(td) / "p.sol"
        subprocess.run(["concorde", "-x", "-o", str(sol), str(tsp)],
                       cwd=td, check=True, capture_output=True)
        toks = sol.read_text().split()
        tour = [int(t) for t in toks[1:]]
    return tour + [0]


def lkh_fixed_edge_tour(coords: np.ndarray, e: Sequence[int], scale: float = 1e6,
                        lkh_path: str = "LKH", max_trials: int = 100,
                        runs: int = 10) -> list:
    """Near-optimal tour through edge e via the LKH-3 binary (reference
    gnngls/__init__.py:63-74, called with scale 1e6, 100 trials, 10 runs)."""
    if not has_lkh(lkh_path):
        raise RuntimeError(f"{lkh_path} binary not on PATH")
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        _write_tsplib(td / "p.tsp", coords, scale, fixed_edge=e)
        tourf = td / "p.tour"
        (td / "p.par").write_text(
            f"PROBLEM_FILE = {td / 'p.tsp'}\nTOUR_FILE = {tourf}\n"
            f"MAX_TRIALS = {max_trials}\nRUNS = {runs}\nTRACE_LEVEL = 0\n")
        subprocess.run([lkh_path, str(td / "p.par")], check=True, capture_output=True)
        lines = tourf.read_text().splitlines()
        start = lines.index("TOUR_SECTION") + 1
        tour = []
        for ln in lines[start:]:
            val = int(ln.strip())
            if val == -1:
                break
            tour.append(val - 1)
    return tour + [0]
