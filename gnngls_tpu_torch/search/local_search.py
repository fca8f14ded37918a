"""Fixed-budget Guided Local Search in plain PyTorch: the twin of the
whole-GLS kernel (gnngls_tpu/search/local_search.py semantics, with
gnngls_tpu/search/pallas_gls.py's outputs).

Per instance:
  * k = 0.1 * init_cost / n from the cost before the initial local search.
  * Local search: a round applies the best 2-opt, then the best relocate,
    each only if it improves; cost += delta.  Rounds run while one of them
    improved, at most 10 n.
  * Perturbation rounds run while fewer than pm moves were accepted and
    fewer than 3 pm rounds ran.  A round takes the first tour edge (u, v)
    of largest guide / (1 + penalty), penalties read before the bump, bumps
    its penalty symmetrically, then for u and then v, skipping the depot:
    one-to-all 2-opt at the endpoint's position under D + k*P, then
    one-to-all relocate at that same, now stale, position.  An accepted
    move re-costs the tour on true weights.
  * Each outer iteration (guide it % G) perturbs, runs the local search, and
    keeps the tour if its cost is strictly below the best.

The batch runs in lock step: an instance whose loop has ended is masked.
Every f32 expression is the kernel's (see search/moves.py), so on the same
inputs the two give the same tours, moves, traces and costs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import moves as mv


class GLSOutput(NamedTuple):
    best_tours: torch.Tensor  # (B, n+1) int32
    best_costs: torch.Tensor  # (B,) f32, the search's own accounting
    moves: torch.Tensor  # (B,) int32 accepted moves
    trace_costs: torch.Tensor  # (B, n_iters) f32 best cost after each iteration
    trace_moves: torch.Tensor  # (B, n_iters) int32 cumulative moves after each
    work: torch.Tensor  # (B, 2) int32 local-search rounds, perturbation rounds


def _local_search(D, t, cost, moves, work):
    n = D.shape[1]
    active = torch.ones(t.shape[0], dtype=torch.bool, device=D.device)
    for _ in range(10 * n):
        if not bool(active.any()):
            break
        work[:, 0] += active.int()
        d, i, j, found = mv.two_opt_a2a(mv.tour_matrix(D, t))
        f1 = active & found
        t = torch.where(f1[:, None], mv.apply_two_opt(t, i, j), t)
        cost = torch.where(f1, cost + d, cost)
        d, i, j, found = mv.relocate_a2a(mv.tour_matrix(D, t))
        f2 = active & found
        t = torch.where(f2[:, None], mv.apply_relocate(t, i, j), t)
        cost = torch.where(f2, cost + d, cost)
        moves += f1.int() + f2.int()
        active = f1 | f2
    return t, cost


def _perturbation(D, Gm, P, k, t, cost, work, pm):
    B, n, _ = D.shape
    b = torch.arange(B, device=D.device)
    made = torch.zeros(B, dtype=torch.int32, device=D.device)
    for _ in range(3 * pm):
        act = made < pm
        if not bool(act.any()):
            break
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
            _, lo, hi, found = mv.two_opt_o2a(mv.tour_matrix(Dg, t), i)
            acc = on & found
            t = torch.where(acc[:, None], mv.apply_two_opt(t, lo, hi), t)
            cost = torch.where(acc, mv.tour_costs(D, t), cost)
            made += acc.int()
            _, j, found = mv.relocate_o2a(mv.tour_matrix(Dg, t), i)
            acc = on & found
            t = torch.where(acc[:, None], mv.apply_relocate(t, i, j), t)
            cost = torch.where(acc, mv.tour_costs(D, t), cost)
            made += acc.int()
    return t, cost, made


def gls_fixed_plain(Ds: torch.Tensor, guides: torch.Tensor,
                    init_tours: torch.Tensor, *, n_iters: int,
                    perturbation_moves: int = 20) -> GLSOutput:
    """Ds (B, n, n) f32, guides (B, G, n, n) or (B, n, n) f32, init_tours
    (B, n+1) int; runs on the tensors' device."""
    if guides.dim() == 3:
        guides = guides[:, None]
    B, n, _ = Ds.shape
    dev = Ds.device
    t = init_tours.long()
    cost = mv.tour_costs(Ds, t)
    k = (torch.full_like(cost, 0.1) * cost) / torch.full_like(cost, float(n))
    P = torch.zeros_like(Ds)
    moves = torch.zeros(B, dtype=torch.int32, device=dev)
    work = torch.zeros((B, 2), dtype=torch.int32, device=dev)
    t, cost = _local_search(Ds, t, cost, moves, work)
    best_t, best_c = t, cost
    tr_c = torch.zeros((B, n_iters), dtype=torch.float32, device=dev)
    tr_m = torch.zeros((B, n_iters), dtype=torch.int32, device=dev)
    for it in range(n_iters):
        t, cost, made = _perturbation(Ds, guides[:, it % guides.shape[1]], P, k,
                                      t, cost, work, perturbation_moves)
        moves += made
        t, cost = _local_search(Ds, t, cost, moves, work)
        better = cost < best_c
        best_t = torch.where(better[:, None], t, best_t)
        best_c = torch.where(better, cost, best_c)
        tr_c[:, it] = best_c
        tr_m[:, it] = moves
    return GLSOutput(best_t.to(torch.int32), best_c, moves, tr_c, tr_m, work)
