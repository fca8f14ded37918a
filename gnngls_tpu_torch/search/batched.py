"""Batched GLS drivers (gnngls_tpu/search/batched.py): fixed-budget and
wall-clock-chunked, on the per-move engine or the whole-search kernel.

* The per-move engine (search/local_search.py, the counterpart of gnngls_tpu's
  vmapped lax engine) runs the batch in lock step as tensor code on the
  device: `batch_init` runs the initial local search, `batch_chunk` advances
  every instance by some outer iterations, `run_fixed` runs a fixed budget
  and `run_wall_clock` runs chunks until a deadline that covers the whole
  batch.  It traces every accepted move and takes first-improvement.
* `run_fixed_kernel` is the counterpart of gnngls_tpu's `run_fixed_pallas`:
  the whole batch and budget run in one launch of the whole-GLS kernel (its
  plain twin on the CPU), traced once per outer iteration, and final costs
  are re-derived from the tours in f32, as gnngls_tpu's `run_fixed_pallas`
  does: the edge lengths are gathered where D lives and summed on the host.

Chunk boundaries are stamped on the host clock after the device has
synchronised, so search-progress rows can interpolate move times.  Each run
is the span "gnngls.search"; the kernel's run splits into
"gnngls.search.upload", ".kernel" and ".fetch" (utils/profiling.py).
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..utils.profiling import annotate
from . import local_search as ls
from .construct import nearest_neighbor_batch  # noqa: F401  (public API)
from .gls_whole import gls_whole


class BatchResult(NamedTuple):
    best_tours: np.ndarray  # (B, n+1)
    best_costs: np.ndarray  # (B,) per-move engine: f32 search accounting; kernel: f64
    trace_costs: np.ndarray  # (B, cap) cost after each move, or (B, n_iters) best cost
    trace_n: np.ndarray  # (B,) accepted moves (per-move) or trace rows (per-iteration)
    chunk_times: List[float]  # wall clock at each chunk boundary
    chunk_moves: np.ndarray  # (B, len(chunk_times)) cumulative accepted moves there
    # Per-iteration traces (the kernel) carry the cumulative moves at each
    # trace row; None for per-move traces, where row m is move m+1.
    trace_moves: Optional[np.ndarray] = None
    work: Optional[np.ndarray] = None  # (B, 2) LS rounds, perturbation rounds
    search_costs: Optional[np.ndarray] = None  # (B,) the search's own f32 accounting
    deadline: Optional[float] = None  # run_wall_clock's deadline, host clock
    # per-move engine: the lock-step rounds the batch ran (local search,
    # perturbation), over the init and every chunk; None from the kernel
    rounds: Optional[Tuple[int, int]] = None


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _on(x, dev, dtype) -> torch.Tensor:
    """x as a tensor of `dtype` on `dev`: a tensor already there is kept, an
    array is copied."""
    if torch.is_tensor(x):
        return x.to(device=dev, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=dev)


def edge_lengths(Ds: torch.Tensor, tours) -> np.ndarray:
    """(B, n) f32 lengths of the tours' (B, n+1) edges, gathered from Ds
    (B, n, n) on its device and fetched.  Their `.sum(-1)` on the host is
    the f32 tour cost, in the order of a host gather's sum."""
    t = _on(tours, Ds.device, torch.long)
    b = torch.arange(Ds.shape[0], device=Ds.device)[:, None]
    return Ds[b, t[:, :-1], t[:, 1:]].cpu().numpy()


def _tensors(dev, Ds, guide_stack, init_tours=None):
    """Ds (B, n, n) and guide_stack (B, G, n, n) as f32 and init_tours
    (B, n+1) as int64 on `dev`."""
    out = [_on(Ds, dev, torch.float32), _on(guide_stack, dev, torch.float32)]
    if init_tours is not None:
        out.append(_on(init_tours, dev, torch.long))
    return out


def batch_init(Ds, guide_stack, init_tours, trace_cap: int = 4096,
               first_improvement: bool = False, device=None) -> ls.GLSState:
    """The initial local search of every instance.  Ds (B, n, n),
    guide_stack (B, G, n, n), init_tours (B, n+1); arrays or tensors, run on
    `device` (cuda unless "cpu" is asked for)."""
    D_t, _, T_t = _tensors(resolve_device(device), Ds, guide_stack, init_tours)
    return ls.gls_init(D_t, T_t, trace_cap=trace_cap, first_improvement=first_improvement)


def batch_chunk(states: ls.GLSState, Ds, guide_stack, n_iters: int,
                perturbation_moves: int, first_improvement: bool = False) -> ls.GLSState:
    """Advance every instance by n_iters outer iterations on the states'
    device; `states` itself is left as it was."""
    D_t, G_t = _tensors(states.tour.device, Ds, guide_stack)
    state = ls.clone_state(states)
    for _ in range(n_iters):
        state = ls.gls_iteration(state, D_t, G_t, perturbation_moves=perturbation_moves,
                                 first_improvement=first_improvement)
    return state


def _per_move_result(state: ls.GLSState, times, moves) -> BatchResult:
    best = state.best_cost.cpu().numpy()
    return BatchResult(
        best_tours=state.best_tour.to(torch.int32).cpu().numpy(),
        best_costs=best,
        trace_costs=state.trace.costs.cpu().numpy(),
        trace_n=state.trace.n.cpu().numpy(),
        chunk_times=times,
        chunk_moves=np.stack(moves, axis=1),
        work=state.work.cpu().numpy(),
        search_costs=best,
        rounds=state.rounds,
    )


@annotate("gnngls.search")
def run_fixed(Ds, guide_stack, init_tours, *, n_iters: int,
              perturbation_moves: int = 20, trace_cap: int = 4096,
              first_improvement: bool = False, device=None) -> BatchResult:
    """Fixed-budget GLS on the per-move engine: one init and one chunk of
    n_iters, stamped before the init, after it and after the chunk."""
    dev = resolve_device(device)
    D_t, G_t, T_t = _tensors(dev, Ds, guide_stack, init_tours)
    t0 = time.time()
    state = batch_init(D_t, G_t, T_t, trace_cap, first_improvement, device=dev)
    _sync(dev)
    t1 = time.time()
    moves = [state.trace.n.cpu().numpy().astype(np.int64)]
    state = batch_chunk(state, D_t, G_t, n_iters, perturbation_moves, first_improvement)
    _sync(dev)
    t2 = time.time()
    moves.append(state.trace.n.cpu().numpy().astype(np.int64))
    return _per_move_result(state, [t0, t1, t2], moves)


# run_wall_clock's first trace rows when it sizes the trace itself (read at
# each call); the initial local search alone may need more, 20 n.
TRACE_ROWS = 4096


def _moves_bound(n: int, perturbation_moves: int, iters: int) -> int:
    """The most moves an instance accepts in `iters` outer iterations: a
    perturbation stops within the round that reaches pm, which accepts at
    most 4, and the local search at most 2 in each of its 10 n rounds."""
    return iters * (perturbation_moves + 3 + 20 * n)


def _widened(state: ls.GLSState, rows: int) -> ls.GLSState:
    """The state with `rows` cost rows in its trace, the filled ones kept."""
    old = state.trace.costs
    costs = old.new_zeros((old.shape[0], rows))
    costs[:, :old.shape[1]] = old
    return state._replace(trace=state.trace._replace(costs=costs))


@annotate("gnngls.search")
def run_wall_clock(Ds, guide_stack, init_tours, *, time_limit_s: float,
                   perturbation_moves: int = 20, chunk_iters: int = 1,
                   trace_cap: Optional[int] = None, first_improvement: bool = False,
                   device=None) -> BatchResult:
    """Chunks of outer iterations on the per-move engine until the deadline.

    One deadline covers the whole batch (all instances search side by side),
    set before the initial local search; the first boundary is stamped after
    it, then one after every chunk until a boundary lies at or past the
    deadline (kept in the result as `deadline`).

    trace_cap None sizes the trace to the run: it starts at max(TRACE_ROWS,
    20 n) rows and, before any chunk that could fill it, widens to at least
    twice its rows, so no move overwrites a row however many the deadline buys.
    An int fixes the rows; moves past them overwrite the last."""
    dev = resolve_device(device)
    D_t, G_t, T_t = _tensors(dev, Ds, guide_stack, init_tours)
    n = D_t.shape[1]
    rows = max(TRACE_ROWS, 20 * n) if trace_cap is None else trace_cap
    deadline = time.time() + time_limit_s
    state = batch_init(D_t, G_t, T_t, rows, first_improvement, device=dev)
    _sync(dev)
    times = [time.time()]
    moves = [state.trace.n.cpu().numpy().astype(np.int64)]
    while times[-1] < deadline:
        need = int(moves[-1].max(initial=0)) + _moves_bound(n, perturbation_moves, chunk_iters)
        if trace_cap is None and need > state.trace.costs.shape[1]:
            state = _widened(state, max(2 * state.trace.costs.shape[1], need))
        state = batch_chunk(state, D_t, G_t, chunk_iters, perturbation_moves,
                            first_improvement)
        _sync(dev)
        times.append(time.time())
        moves.append(state.trace.n.cpu().numpy().astype(np.int64))
    return _per_move_result(state, times, moves)._replace(deadline=deadline)


def make_guide_stack(Ds, guides: List[str], regret_pred: Optional[torch.Tensor]):
    """Guide matrices by name, (B, G, n, n) tensors on their device: 'weight'
    -> D, 'regret_pred'.  One guide is a view of its matrices, not a copy."""
    mats = []
    for g in guides:
        if g == "weight":
            mats.append(torch.as_tensor(Ds))
        elif g == "regret_pred":
            if regret_pred is None:
                raise ValueError("guide 'regret_pred' needs predictions")
            mats.append(torch.as_tensor(regret_pred))
        else:
            raise ValueError(f"unknown guide {g!r}")
    return mats[0][:, None] if len(mats) == 1 else torch.stack(mats, dim=1)


@annotate("gnngls.search")
def run_fixed_kernel(Ds, guide_stack, init_tours, *, n_iters: int,
                     perturbation_moves: int = 20, k=None, device=None) -> BatchResult:
    """Fixed-budget GLS for the whole batch in one `gls_whole` call, on
    `device` (cuda unless "cpu" is asked for).  Ds, guide_stack and
    init_tours are arrays or tensors: a tensor there in the kernel's dtype is
    used as it is, else copied.  k: None or (B,) penalty scales (`gls_whole`)."""
    with annotate("gnngls.search.upload"):
        dev = resolve_device(device)
        D_t = _on(Ds, dev, torch.float32).contiguous()
        G_t = _on(guide_stack, dev, torch.float32).contiguous()
        T_t = _on(init_tours, dev, torch.int32).contiguous()
        k_t = None if k is None else _on(k, dev, torch.float32)
        _sync(dev)
    with annotate("gnngls.search.kernel"):
        t0 = time.time()
        out = gls_whole(D_t, G_t, T_t, n_iters=n_iters,
                        perturbation_moves=perturbation_moves, k=k_t)
        _sync(dev)
        t1 = time.time()
    with annotate("gnngls.search.fetch"):
        tours = out.best_tours.cpu().numpy()
        moves = out.moves.cpu().numpy().astype(np.int64)
        B = D_t.shape[0]
        costs = edge_lengths(D_t, out.best_tours).sum(-1)
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
