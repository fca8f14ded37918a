"""Guided Local Search in plain PyTorch, batched in lock step over instances:
the whole-GLS kernel's twin (gnngls_tpu/search/pallas_gls.py's outputs) and
the per-move engine (gnngls_tpu/search/local_search.py), on one pair of loops.

Per instance:
  * k = 0.1 * init_cost / n from the cost before the initial local search,
    unless the caller gives k.
  * Local search: a round applies the best 2-opt, then the best relocate,
    each only if it improves; cost += delta.  Rounds run while one of them
    improved, at most max_ls_iters (by default 10 n).
  * Perturbation rounds run while fewer than pm moves were accepted and
    fewer than max_pert_iters rounds (by default 3 pm) ran.  A round takes the first tour edge (u, v)
    of largest guide / (1 + penalty), penalties read before the bump, bumps
    its penalty symmetrically, then for u and then v, skipping the depot:
    one-to-all 2-opt at the endpoint's position under D + k*P, then
    one-to-all relocate at that same, now stale, position.  An accepted
    move re-costs the tour on true weights.
  * Each outer iteration (guide it % G) perturbs, runs the local search, and
    keeps the tour if its cost is strictly below the best.

With `first_improvement` every scan takes the first improving candidate in
scan order instead of the best.  An instance whose loop has ended is masked:
the batch runs a loop's rounds in lock step until its last instance is done,
each round followed by one host sync, and the state counts those rounds on
the host (`GLSState.rounds`) beside each instance's own (`work`).  Every
accepted move counts in the state's `Trace`; with a cost buffer the trace
also records the cost after the move (cost + delta in the local
search, the true-weight re-cost in the perturbation) at the saturating index
min(count, cap - 1), as gnngls_tpu's `_record` does.  Every f32 expression is
the kernel's (see search/moves.py) and tour costs are its halving-tree sums,
so with best-improvement the per-move engine, the twin and the kernel give
the same tours, moves and costs on the same inputs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.profiling import annotate
from . import moves as mv


class GLSOutput(NamedTuple):
    best_tours: torch.Tensor  # (B, n+1) int32
    best_costs: torch.Tensor  # (B,) f32, the search's own accounting
    moves: torch.Tensor  # (B,) int32 accepted moves
    trace_costs: torch.Tensor  # (B, n_iters) f32 best cost after each iteration
    trace_moves: torch.Tensor  # (B, n_iters) int32 cumulative moves after each
    work: torch.Tensor  # (B, 2) int32 local-search rounds, perturbation rounds


class Trace(NamedTuple):
    costs: Optional[torch.Tensor]  # (B, cap) f32 cost after each accepted move, or None
    n: torch.Tensor  # (B,) int32 accepted moves (may exceed cap)


def make_trace(B: int, cap: Optional[int], device) -> Trace:
    """A trace of `cap` cost rows an instance; cap None counts moves only."""
    if cap is not None and cap < 1:
        raise ValueError(f"trace_cap must be >= 1, got {cap}")
    costs = None if cap is None else torch.zeros((B, cap), dtype=torch.float32, device=device)
    return Trace(costs, torch.zeros(B, dtype=torch.int32, device=device))


def _record(trace: Trace, cost: torch.Tensor, on: torch.Tensor) -> None:
    """Where `on`: write cost at row min(n, cap - 1), then count the move."""
    if trace.costs is not None:
        idx = trace.n.clamp(max=trace.costs.shape[1] - 1).long()[:, None]
        keep = trace.costs.gather(1, idx)[:, 0]
        trace.costs.scatter_(1, idx, torch.where(on, cost, keep)[:, None])
    trace.n.add_(on.int())


class GLSState(NamedTuple):
    """The search state of a batch, chunkable across calls."""

    tour: torch.Tensor  # (B, n+1) int64 current tours
    cost: torch.Tensor  # (B,) f32 current true cost
    best_tour: torch.Tensor  # (B, n+1) int64
    best_cost: torch.Tensor  # (B,) f32
    penalties: torch.Tensor  # (B, n, n) f32 symmetric edge penalties
    k: torch.Tensor  # (B,) f32 penalty scale, 0.1 * init_cost / n
    iter_i: int  # outer iterations run: the guide cycles on it
    trace: Trace
    work: torch.Tensor  # (B, 2) int32 local-search rounds, perturbation rounds
    # the lock-step rounds the batch ran (local search, perturbation), host ints
    rounds: Tuple[int, int] = (0, 0)


def clone_state(state: GLSState) -> GLSState:
    """A copy that the loops may update in place without touching `state`."""
    tr = state.trace
    trace = Trace(None if tr.costs is None else tr.costs.clone(), tr.n.clone())
    return state._replace(tour=state.tour.clone(), cost=state.cost.clone(),
                          best_tour=state.best_tour.clone(),
                          best_cost=state.best_cost.clone(),
                          penalties=state.penalties.clone(), k=state.k.clone(),
                          trace=trace, work=state.work.clone())


class LSResult(NamedTuple):
    tour: torch.Tensor  # (B, n+1) int64
    cost: torch.Tensor  # (B,) f32
    trace: Trace
    rounds: int = 0  # the rounds the batch ran; work[:, 0] counts each instance's


def local_search(tour: torch.Tensor, cost: torch.Tensor, D: torch.Tensor, trace: Trace,
                 max_iters: int = 0, first_improvement: bool = False,
                 work: Optional[torch.Tensor] = None) -> LSResult:
    """Rounds of the best (or first) 2-opt, then relocate, on D (B, n, n)
    until a round makes no move, at most max_iters rounds (0: 10 n).  Updates
    the trace, and `work` (B, 2) when given, in place; `rounds` counts the
    rounds the batch ran, each followed by a host sync."""
    n = D.shape[1]
    if max_iters <= 0:
        max_iters = 10 * n
    if work is None:
        work = torch.zeros((tour.shape[0], 2), dtype=torch.int32, device=D.device)
    t = tour
    active = torch.ones(t.shape[0], dtype=torch.bool, device=D.device)
    rounds = 0
    for _ in range(max_iters):
        if not bool(active.any()):
            break
        rounds += 1
        work[:, 0] += active.int()
        d, i, j, found = mv.two_opt_a2a(mv.tour_matrix(D, t), first_improvement)
        f1 = active & found
        t = torch.where(f1[:, None], mv.apply_two_opt(t, i, j), t)
        cost = torch.where(f1, cost + d, cost)
        _record(trace, cost, f1)
        d, i, j, found = mv.relocate_a2a(mv.tour_matrix(D, t), first_improvement)
        f2 = active & found
        t = torch.where(f2[:, None], mv.apply_relocate(t, i, j), t)
        cost = torch.where(f2, cost + d, cost)
        _record(trace, cost, f2)
        active = f1 | f2
    return LSResult(t, cost, trace, rounds)


def _perturbation(D, Gm, P, k, t, cost, trace, work, pm, max_iters, first_improvement=False):
    """At most max_iters rounds; updates P, the trace and work in place and
    returns the tours, the costs and the rounds the batch ran."""
    B, n, _ = D.shape
    b = torch.arange(B, device=D.device)
    made = torch.zeros(B, dtype=torch.int32, device=D.device)
    rounds = 0
    for _ in range(max_iters):
        act = made < pm
        if not bool(act.any()):
            break
        rounds += 1
        work[:, 1] += act.int()
        a, c = t[:, :-1], t[:, 1:]
        util = Gm[b[:, None], a, c] / (1.0 + P[b[:, None], a, c])
        q = mv.first_max(util)
        u, v = t[b, q], t[b, q + 1]
        P[b, u, v] += act.float()
        P[b, v, u] += act.float()
        Dg = D + k[:, None, None] * P
        for node in (u, v):
            on = act & (node != 0)
            i = torch.where(t == node[:, None], torch.arange(n + 1, device=D.device),
                            n + 1).min(dim=1).values.clamp(max=n)
            _, lo, hi, found = mv.two_opt_o2a(mv.tour_matrix(Dg, t), i, first_improvement)
            acc = on & found
            t = torch.where(acc[:, None], mv.apply_two_opt(t, lo, hi), t)
            cost = torch.where(acc, mv.tour_costs(D, t), cost)
            _record(trace, cost, acc)
            made += acc.int()
            _, j, found = mv.relocate_o2a(mv.tour_matrix(Dg, t), i, first_improvement)
            acc = on & found
            t = torch.where(acc[:, None], mv.apply_relocate(t, i, j), t)
            cost = torch.where(acc, mv.tour_costs(D, t), cost)
            _record(trace, cost, acc)
            made += acc.int()
    return t, cost, rounds


def penalty_scale(cost: torch.Tensor, n: int) -> torch.Tensor:
    """k = 0.1 * cost / n in f32, rounded as the kernel rounds it."""
    return (torch.full_like(cost, 0.1) * cost) / torch.full_like(cost, float(n))


def gls_init(D: torch.Tensor, init_tours: torch.Tensor, *, trace_cap: Optional[int] = 1024,
             max_ls_iters: int = 0, k=None, first_improvement: bool = False) -> GLSState:
    """The initial local search on true weights.  D (B, n, n) f32,
    init_tours (B, n+1) int; runs on D's device.  k, a (B,) tensor or a
    scalar, overrides the penalty scale 0.1 * init_cost / n (the forced-edge
    label oracles set it from the unreduced tour); max_ls_iters bounds the
    local search's rounds (0: 10 n)."""
    B, n, _ = D.shape
    t = init_tours.to(device=D.device, dtype=torch.long)
    cost = mv.tour_costs(D, t)
    if k is None:
        k = penalty_scale(cost, n)
    else:
        k = torch.as_tensor(k, dtype=torch.float32, device=D.device).expand(B).clone()
    trace = make_trace(B, trace_cap, D.device)
    work = torch.zeros((B, 2), dtype=torch.int32, device=D.device)
    t, cost, _, rounds = local_search(t, cost, D, trace, max_ls_iters, first_improvement, work)
    return GLSState(t, cost, t, cost, torch.zeros_like(D), k, 0, trace, work, (rounds, 0))


@annotate("gnngls.search.iteration")
def gls_iteration(state: GLSState, D: torch.Tensor, guides: torch.Tensor, *,
                  perturbation_moves: int, max_pert_iters: int = 0, max_ls_iters: int = 0,
                  first_improvement: bool = False) -> GLSState:
    """One outer iteration: perturb under guide iter_i % G, re-optimise on
    true weights, keep a strictly better tour.  Updates the state's
    penalties, trace and work in place.  guides (B, G, n, n).  The
    perturbation runs at most max_pert_iters rounds (0: 3 pm), the local
    search at most max_ls_iters (0: 10 n)."""
    if max_pert_iters <= 0:
        max_pert_iters = 3 * perturbation_moves
    guide = guides[:, state.iter_i % guides.shape[1]]
    with annotate("gnngls.search.perturb"):
        t, cost, p_rounds = _perturbation(D, guide, state.penalties, state.k, state.tour,
                                          state.cost, state.trace, state.work,
                                          perturbation_moves, max_pert_iters, first_improvement)
    with annotate("gnngls.search.ls"):
        t, cost, _, ls_rounds = local_search(t, cost, D, state.trace, max_ls_iters,
                                             first_improvement, state.work)
    better = cost < state.best_cost
    return state._replace(tour=t, cost=cost,
                          best_tour=torch.where(better[:, None], t, state.best_tour),
                          best_cost=torch.where(better, cost, state.best_cost),
                          iter_i=state.iter_i + 1,
                          rounds=(state.rounds[0] + ls_rounds,
                                  state.rounds[1] + p_rounds))


def guided_local_search(D: torch.Tensor, guides: torch.Tensor, init_tours: torch.Tensor, *,
                        n_iters: int, perturbation_moves: int = 20,
                        trace_cap: Optional[int] = 1024, k=None,
                        first_improvement: bool = False) -> GLSState:
    """Fixed-budget GLS with per-move traces.  guides (B, G, n, n) or
    (B, n, n); k as in `gls_init`."""
    if guides.dim() == 3:
        guides = guides[:, None]
    state = gls_init(D, init_tours, trace_cap=trace_cap, k=k,
                     first_improvement=first_improvement)
    for _ in range(n_iters):
        state = gls_iteration(state, D, guides, perturbation_moves=perturbation_moves,
                              first_improvement=first_improvement)
    return state


def gls_fixed_plain(Ds: torch.Tensor, guides: torch.Tensor,
                    init_tours: torch.Tensor, *, n_iters: int,
                    perturbation_moves: int = 20, k=None) -> GLSOutput:
    """The kernel's twin: best-improvement, per-iteration traces.  Ds
    (B, n, n) f32, guides (B, G, n, n) or (B, n, n) f32, init_tours (B, n+1)
    int; k as in `gls_init`; runs on the tensors' device."""
    if guides.dim() == 3:
        guides = guides[:, None]
    B = Ds.shape[0]
    state = gls_init(Ds, init_tours, trace_cap=None, k=k)
    tr_c = torch.zeros((B, n_iters), dtype=torch.float32, device=Ds.device)
    tr_m = torch.zeros((B, n_iters), dtype=torch.int32, device=Ds.device)
    for it in range(n_iters):
        state = gls_iteration(state, Ds, guides, perturbation_moves=perturbation_moves)
        tr_c[:, it] = state.best_cost
        tr_m[:, it] = state.trace.n
    return GLSOutput(state.best_tour.to(torch.int32), state.best_cost, state.trace.n,
                     tr_c, tr_m, state.work)
