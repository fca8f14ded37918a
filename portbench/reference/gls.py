"""The plain reference of the search: nearest-neighbour construction (NumPy)
and Guided Local Search (plain PyTorch, batched in lock step over instances).

A frozen copy of the algorithm as the program's plain twin states it, kept
here so that the benchmark's yardstick cannot move with the program.  Per
instance:
  * k = 0.1 * init_cost / n, from the tour before the first local search.
  * Local search: a round applies the best 2-opt, then the best relocate,
    each only if its delta is below -EPS_CLOSE (in f32); rounds run while one
    of them improved, at most 10 n.
  * Perturbation: rounds run while fewer than pm moves were accepted, at most
    3 pm.  A round takes the first tour edge (u, v) of largest
    guide / (1 + penalty), bumps its penalty symmetrically, then for u and
    then v (not the depot) the best one-to-all 2-opt at the endpoint's
    position under D + k P, then the best one-to-all relocate at that same,
    now stale, position; an accepted move re-costs the tour on D.
  * An outer iteration perturbs under guide it % G, runs the local search on
    D, and keeps the tour if its cost is strictly below the best.
Ties go to the first candidate in row-major order.  Every f32 expression and
the tour cost's halving-tree sum are written in the order the program's
search states, so that a correct search gives the same tours and the same
f32 costs bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

EPS_CLOSE = 1e-8 / (1.0 - 1e-5)
NEG_EPS = float(np.float32(-EPS_CLOSE))
_BIG = 1 << 30


def nearest_neighbour(W: np.ndarray, depot: int = 0) -> np.ndarray:
    """(B, n, n) guides -> (B, n+1) int32 tours: from the depot, always to the
    unvisited city of least guide value, the lowest id on ties, then back."""
    B, n, _ = W.shape
    tours = np.empty((B, n + 1), np.int32)
    for b in range(B):
        visited = np.zeros(n, bool)
        cur = depot
        visited[cur] = True
        tours[b, 0] = cur
        for t in range(1, n):
            cur = int(np.argmin(np.where(visited, np.inf, W[b, cur])))
            visited[cur] = True
            tours[b, t] = cur
        tours[b, n] = depot
    return tours


def is_tour(t: np.ndarray, n: int, depot: int = 0) -> bool:
    """A closed tour from the depot through every city once."""
    return (t.shape == (n + 1,) and t[0] == depot and t[-1] == depot
            and np.array_equal(np.sort(t[:-1]), np.arange(n)))


def _tm(A, t):
    b = torch.arange(A.shape[0], device=A.device)[:, None, None]
    return A[b, t[:, :, None], t[:, None, :]]


def _tree_sum(x):
    p2 = 1
    while p2 < x.shape[1]:
        p2 *= 2
    x = F.pad(x, (0, p2 - x.shape[1]))
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] + x[:, h:]
    return x[:, 0]


def tour_costs(D, t):
    b = torch.arange(D.shape[0], device=D.device)[:, None]
    return _tree_sum(D[b, t[:, :-1], t[:, 1:]])


def _first_min(score):
    mn = score.min(dim=1).values
    ar = torch.arange(score.shape[1], device=score.device)
    idx = torch.where(score == mn[:, None], ar, _BIG).min(dim=1).values
    return mn, idx, torch.isfinite(mn)


def _first_max(score):
    mx = score.max(dim=1).values
    ar = torch.arange(score.shape[1], device=score.device)
    return torch.where(score == mx[:, None], ar, _BIG).min(dim=1).values


def _diag(M, offset):
    return F.pad(torch.diagonal(M, offset=-offset, dim1=1, dim2=2), (0, offset))


def _right(x):
    return F.pad(x[..., :-1], (1, 0))


def _grid(nt, device):
    ar = torch.arange(nt, device=device)
    return ar[:, None], ar[None, :]


def _two_opt_all(M):
    nt = M.shape[1]
    n = nt - 1
    shifted = F.pad(M[:, :-1, :-1], (1, 0, 1, 0))
    c = F.pad(torch.diagonal(M, offset=1, dim1=1, dim2=2), (1, 0))
    delta = ((M + shifted) - c[:, :, None]) - c[:, None, :]
    ii, jj = _grid(nt, M.device)
    valid = (ii >= 1) & (jj <= n - 1) & (jj - ii >= 2) & (delta < NEG_EPS)
    d, k, found = _first_min(torch.where(valid, delta, torch.inf).reshape(M.shape[0], -1))
    return d, k // nt, k % nt, found


def _relocate_all(M):
    nt = M.shape[1]
    n = nt - 1
    d1, d2 = _diag(M, 1), _diag(M, 2)
    d1s, d2s = _right(d1), _right(d2)
    rem = (-d1s - d1) + d2s
    T = M.transpose(1, 2)
    Mr = F.pad(M[:, :, 1:], (0, 1))
    Tl = F.pad(T[:, :, :-1], (1, 0))
    ins_lt = (-d1[:, None, :] + T) + Mr
    ins_gt = (-d1s[:, None, :] + Tl) + M
    ii, jj = _grid(nt, M.device)
    delta = rem[:, :, None] + torch.where(ii < jj, ins_lt, ins_gt)
    valid = ((ii >= 1) & (ii <= n - 1) & (jj >= 1) & (jj <= n - 1)
             & (ii != jj) & (ii - jj != 1) & (delta < NEG_EPS))
    d, k, found = _first_min(torch.where(valid, delta, torch.inf).reshape(M.shape[0], -1))
    return d, k // nt, k % nt, found


def _row(M, i):
    return M[torch.arange(M.shape[0], device=M.device), i]


def _two_opt_one(Mg, i):
    nt = Mg.shape[1]
    n = nt - 1
    row_i = _row(Mg, i)
    row_im1 = _right(_row(Mg, (i - 1).clamp(min=0)))
    c = F.pad(torch.diagonal(Mg, offset=1, dim1=1, dim2=2), (1, 0))
    delta = ((row_i + row_im1) - c.gather(1, i[:, None])) - c
    jj = torch.arange(nt, device=Mg.device)[None, :]
    valid = (jj >= 1) & (jj <= n - 1) & ((i[:, None] - jj).abs() >= 2) & (delta < NEG_EPS)
    d, j, found = _first_min(torch.where(valid, delta, torch.inf))
    return torch.minimum(i, j), torch.maximum(i, j), found


def _relocate_one(Mg, i):
    nt = Mg.shape[1]
    n = nt - 1
    d1, d2 = _diag(Mg, 1), _diag(Mg, 2)
    d1s, d2s = _right(d1), _right(d2)
    at = lambda v: v.gather(1, i[:, None])  # noqa: E731
    rem_i = (-at(d1s) - at(d1)) + at(d2s)
    row_i = _row(Mg, i)
    ins_gt = (-d1 + row_i) + F.pad(row_i[:, 1:], (0, 1))
    ins_lt = (-d1s + _right(row_i)) + row_i
    jj = torch.arange(nt, device=Mg.device)[None, :]
    delta = rem_i + torch.where(jj > i[:, None], ins_gt, ins_lt)
    valid = (jj >= 1) & (jj <= n - 1) & (jj != i[:, None]) & (delta < NEG_EPS)
    _, j, found = _first_min(torch.where(valid, delta, torch.inf))
    return j, found


def _reverse(t, i, j):
    p = torch.arange(t.shape[1], device=t.device)[None, :]
    i, j = i[:, None], j[:, None]
    return t.gather(1, torch.where((p >= i) & (p < j), i + j - 1 - p, p))


def _move(t, i, j):
    nt = t.shape[1]
    p = torch.arange(nt, device=t.device)[None, :]
    i, j = i[:, None], j[:, None]
    lt = torch.where(p < i, p, torch.where(p < j, p + 1, torch.where(p == j, i, p)))
    gt = torch.where(p < j, p, torch.where(p == j, i, torch.where(p <= i, p - 1, p)))
    return t.gather(1, torch.where(i < j, lt, gt).clamp(0, nt - 1))


def _local_search(t, cost, D):
    n = D.shape[1]
    active = torch.ones(t.shape[0], dtype=torch.bool, device=D.device)
    for _ in range(10 * n):
        if not bool(active.any()):
            break
        d, i, j, found = _two_opt_all(_tm(D, t))
        f1 = active & found
        t = torch.where(f1[:, None], _reverse(t, i, j), t)
        cost = torch.where(f1, cost + d, cost)
        d, i, j, found = _relocate_all(_tm(D, t))
        f2 = active & found
        t = torch.where(f2[:, None], _move(t, i, j), t)
        cost = torch.where(f2, cost + d, cost)
        active = f1 | f2
    return t, cost


def _perturb(D, G, P, k, t, cost, pm):
    B, n, _ = D.shape
    b = torch.arange(B, device=D.device)
    made = torch.zeros(B, dtype=torch.int32, device=D.device)
    for _ in range(3 * pm):
        act = made < pm
        if not bool(act.any()):
            break
        a, c = t[:, :-1], t[:, 1:]
        q = _first_max(G[b[:, None], a, c] / (1.0 + P[b[:, None], a, c]))
        u, v = t[b, q], t[b, q + 1]
        P[b, u, v] += act.float()
        P[b, v, u] += act.float()
        Dg = D + k[:, None, None] * P
        for node in (u, v):
            on = act & (node != 0)
            i = torch.where(t == node[:, None], torch.arange(n + 1, device=D.device),
                            n + 1).min(dim=1).values.clamp(max=n)
            lo, hi, found = _two_opt_one(_tm(Dg, t), i)
            acc = on & found
            t = torch.where(acc[:, None], _reverse(t, lo, hi), t)
            cost = torch.where(acc, tour_costs(D, t), cost)
            made += acc.int()
            j, found = _relocate_one(_tm(Dg, t), i)
            acc = on & found
            t = torch.where(acc[:, None], _move(t, i, j), t)
            cost = torch.where(acc, tour_costs(D, t), cost)
            made += acc.int()
    return t, cost


@torch.no_grad()
def guided_local_search(D: torch.Tensor, guides: torch.Tensor, init: torch.Tensor, *,
                        n_iters: int, perturbation_moves: int):
    """D (B, n, n) f32, guides (B, G, n, n) f32, init (B, n+1) tours ->
    (best tours (B, n+1) int32, best costs (B,) f32), on D's device."""
    B, n, _ = D.shape
    t = init.to(device=D.device, dtype=torch.long)
    cost = tour_costs(D, t)
    k = (torch.full_like(cost, 0.1) * cost) / torch.full_like(cost, float(n))
    t, cost = _local_search(t, cost, D)
    best_t, best_c = t, cost
    P = torch.zeros_like(D)
    for it in range(n_iters):
        t, cost = _perturb(D, guides[:, it % guides.shape[1]], P, k, t, cost, perturbation_moves)
        t, cost = _local_search(t, cost, D)
        better = cost < best_c
        best_t = torch.where(better[:, None], t, best_t)
        best_c = torch.where(better, cost, best_c)
    return best_t.to(torch.int32), best_c
