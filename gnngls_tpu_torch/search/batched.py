"""Batched GLS driver on the whole-search kernel (gnngls_tpu/search/batched.py).

`run_fixed_kernel` is the counterpart of gnngls_tpu's `run_fixed_pallas`: the
whole batch and budget run in one launch (no chunking of the batch: the
kernel's blocks run side by side), and final costs are re-derived from the
tours on the host in f32, as the JAX driver does.  The wall-clock driver and
the per-move XLA engine wait for later slices.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .construct import nearest_neighbor_batch  # noqa: F401  (public API)
from .gls_whole import gls_whole


class BatchResult(NamedTuple):
    best_tours: np.ndarray  # (B, n+1)
    best_costs: np.ndarray  # (B,) f64, re-derived from the tours in f32
    trace_costs: np.ndarray  # (B, n_iters) best cost after each iteration
    trace_n: np.ndarray  # (B,) number of trace rows
    chunk_times: List[float]  # wall clock before and after the launch
    chunk_moves: np.ndarray  # (B, 2) cumulative accepted moves at those times
    trace_moves: Optional[np.ndarray] = None  # (B, n_iters) cumulative moves
    work: Optional[np.ndarray] = None  # (B, 2) LS rounds, perturbation rounds
    search_costs: Optional[np.ndarray] = None  # (B,) the search's own f32 accounting


def make_guide_stack(Ds, guides: List[str], regret_pred: Optional[np.ndarray]):
    """Guide matrices by name, (B, G, n, n): 'weight' -> D, 'regret_pred'."""
    mats = []
    for g in guides:
        if g == "weight":
            mats.append(np.asarray(Ds))
        elif g == "regret_pred":
            if regret_pred is None:
                raise ValueError("guide 'regret_pred' needs predictions")
            mats.append(np.asarray(regret_pred))
        else:
            raise ValueError(f"unknown guide {g!r}")
    return np.stack(mats, axis=1)


def run_fixed_kernel(Ds, guide_stack, init_tours, *, n_iters: int,
                     perturbation_moves: int = 20, device="cuda") -> BatchResult:
    """Fixed-budget GLS for the whole batch in one `gls_whole` call."""
    Ds = np.ascontiguousarray(Ds, dtype=np.float32)
    dev = torch.device(device)
    D_t = torch.as_tensor(Ds, device=dev)
    G_t = torch.as_tensor(np.ascontiguousarray(guide_stack, dtype=np.float32), device=dev)
    T_t = torch.as_tensor(np.ascontiguousarray(init_tours, dtype=np.int32), device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    out = gls_whole(D_t, G_t, T_t, n_iters=n_iters,
                    perturbation_moves=perturbation_moves)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.time()
    tours = out.best_tours.cpu().numpy()
    moves = out.moves.cpu().numpy().astype(np.int64)
    B = Ds.shape[0]
    costs = Ds[np.arange(B)[:, None], tours[:, :-1], tours[:, 1:]].sum(-1)
    return BatchResult(
        best_tours=tours,
        best_costs=costs.astype(np.float64),
        trace_costs=out.trace_costs.cpu().numpy(),
        trace_n=np.full((B,), n_iters, np.int64),
        chunk_times=[t0, t1],
        chunk_moves=np.stack([np.zeros_like(moves), moves], axis=1),
        trace_moves=out.trace_moves.cpu().numpy().astype(np.int64),
        work=out.work.cpu().numpy(),
        search_costs=out.best_costs.cpu().numpy(),
    )
