"""Move semantics of the GLS, batched over instances (gnngls_tpu/search/moves.py).

Tours are closed position arrays of length n+1 (depot at both ends).  With
M[p, q] = D[t[p], t[q]], the expressions below are written in exactly the
order of gnngls_tpu/search/pallas_gls.py:223-256 and :346-371, and the CUDA
kernel (csrc/gls_whole.cu) evaluates them in the same order, so the two
agree bit for bit:

  2-opt (i < j):   ((M[i,j] + M[i-1,j-1]) - M[i-1,i]) - M[j-1,j]
  relocate i->j:   rem(i) + ins(i, j),
    rem(i)        = ((-M[i,i-1]) - M[i+1,i]) + M[i+1,i-1]
    ins(i, j<>i)  = ((-M[j+1,j]) + M[j,i]) + M[i,j+1]      if i < j
                    ((-M[j,j-1]) + M[j-1,i]) + M[i,j]      if i > j

A move is accepted only if delta < -EPS_CLOSE (the reference's
`not np.isclose(0, delta)`, compared in f32); ties go to the first candidate
in row-major (i, j) order.  Candidates: 2-opt i >= 1, j <= n-1, j-i >= 2;
relocate all-to-all skips i-j == 1, one-to-all skips only i == j.

Each scan takes `first_improvement`: off, it returns the most improving
candidate (the kernel's rule); on, the first improving one in row-major
(i, j) scan order (gnngls_tpu/search/moves.py `_pick`, the reference's
first-improvement mode).  The delta expressions are the same either way.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

EPS_CLOSE = 1e-8 / (1.0 - 1e-5)
NEG_EPS_F32 = float(np.float32(-EPS_CLOSE))  # the f32 threshold both sides compare with
_BIGI = 1 << 30


def tour_matrix(A: torch.Tensor, tours: torch.Tensor) -> torch.Tensor:
    """(B, n, n), (B, nt) -> (B, nt, nt) with [b, p, q] = A[b, t[p], t[q]]."""
    b = torch.arange(A.shape[0], device=A.device)[:, None, None]
    return A[b, tours[:, :, None], tours[:, None, :]]


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """(B, m) -> (B,): zero-pad to a power of two, then add halves.

    The kernel's block reduction adds in this order, so tour costs agree bit
    for bit (gnngls_tpu's XLA reduction order differs by about an ulp)."""
    p2 = 1
    while p2 < x.shape[1]:
        p2 *= 2
    x = F.pad(x, (0, p2 - x.shape[1]))
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] + x[:, h:]
    return x[:, 0]


def tour_costs(D: torch.Tensor, tours: torch.Tensor) -> torch.Tensor:
    b = torch.arange(D.shape[0], device=D.device)[:, None]
    return tree_sum(D[b, tours[:, :-1], tours[:, 1:]])


def first_min(score: torch.Tensor):
    """(B, m) -> (min, first index); +inf marks an invalid candidate."""
    mn = score.min(dim=1).values
    ar = torch.arange(score.shape[1], device=score.device)
    idx = torch.where(score == mn[:, None], ar, _BIGI).min(dim=1).values
    return mn, idx, torch.isfinite(mn)


def _pick(score: torch.Tensor, first_improvement: bool):
    """(value, index, found) of the chosen candidate of each row of score
    (B, m): the most negative, first on ties, or with `first_improvement`
    the first finite one (index 0 and not found when there is none, as
    gnngls_tpu's argmax(isfinite(flat)))."""
    if not first_improvement:
        return first_min(score)
    ar = torch.arange(score.shape[1], device=score.device)
    idx = torch.where(torch.isfinite(score), ar, _BIGI).min(dim=1).values
    found = idx < _BIGI
    idx = torch.where(found, idx, 0)
    return score.gather(1, idx[:, None])[:, 0], idx, found


def first_max(score: torch.Tensor):
    mx = score.max(dim=1).values
    ar = torch.arange(score.shape[1], device=score.device)
    return torch.where(score == mx[:, None], ar, _BIGI).min(dim=1).values


def _grid(nt: int, device):
    ar = torch.arange(nt, device=device)
    return ar[:, None], ar[None, :]


def _offdiag(M: torch.Tensor, offset: int) -> torch.Tensor:
    """r[q] = M[q + offset, q] for offset > 0, zero-padded to length nt."""
    d = torch.diagonal(M, offset=-offset, dim1=1, dim2=2)
    return F.pad(d, (0, offset))


def _shift_right(x: torch.Tensor) -> torch.Tensor:
    """r[q] = x[q-1] (r[0] = 0) along the last axis."""
    return F.pad(x[..., :-1], (1, 0))


def two_opt_a2a(M: torch.Tensor, first_improvement: bool = False):
    """Best (or first) improving 2-opt over all (i, j): (delta, i, j, found)."""
    nt = M.shape[1]
    n = nt - 1
    shifted = F.pad(M[:, :-1, :-1], (1, 0, 1, 0))  # [i, j] -> M[i-1, j-1]
    c = F.pad(torch.diagonal(M, offset=1, dim1=1, dim2=2), (1, 0))  # c[q] = M[q-1, q]
    delta = ((M + shifted) - c[:, :, None]) - c[:, None, :]
    ii, jj = _grid(nt, M.device)
    valid = (ii >= 1) & (jj <= n - 1) & (jj - ii >= 2) & (delta < NEG_EPS_F32)
    d, k, found = _pick(torch.where(valid, delta, torch.inf).reshape(M.shape[0], -1),
                        first_improvement)
    return d, k // nt, k % nt, found


def relocate_a2a(M: torch.Tensor, first_improvement: bool = False):
    """Best (or first) improving relocate over all ordered (i, j), skipping
    i-j == 1."""
    nt = M.shape[1]
    n = nt - 1
    d1, d2 = _offdiag(M, 1), _offdiag(M, 2)  # d1[q] = M[q+1, q], d2[q] = M[q+2, q]
    d1s, d2s = _shift_right(d1), _shift_right(d2)
    rem = (-d1s - d1) + d2s
    T = M.transpose(1, 2)
    Mr = F.pad(M[:, :, 1:], (0, 1))  # [i, j] -> M[i, j+1]
    Tl = F.pad(T[:, :, :-1], (1, 0))  # [i, j] -> M[j-1, i]
    ins_lt = (-d1[:, None, :] + T) + Mr
    ins_gt = (-d1s[:, None, :] + Tl) + M
    ii, jj = _grid(nt, M.device)
    delta = rem[:, :, None] + torch.where(ii < jj, ins_lt, ins_gt)
    valid = ((ii >= 1) & (ii <= n - 1) & (jj >= 1) & (jj <= n - 1)
             & (ii != jj) & (ii - jj != 1) & (delta < NEG_EPS_F32))
    d, k, found = _pick(torch.where(valid, delta, torch.inf).reshape(M.shape[0], -1),
                        first_improvement)
    return d, k // nt, k % nt, found


def _rows(M: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return M[torch.arange(M.shape[0], device=M.device), i]


def two_opt_o2a(Mg: torch.Tensor, i: torch.Tensor, first_improvement: bool = False):
    """Best (or first) improving 2-opt with one end at position i:
    (delta, lo, hi, found)."""
    nt = Mg.shape[1]
    n = nt - 1
    row_i = _rows(Mg, i)
    row_im1 = _shift_right(_rows(Mg, (i - 1).clamp(min=0)))  # [j] -> Mg[i-1, j-1]
    c = F.pad(torch.diagonal(Mg, offset=1, dim1=1, dim2=2), (1, 0))  # c[q] = Mg[q-1, q]
    c_i = c.gather(1, i[:, None])
    delta = ((row_i + row_im1) - c_i) - c
    jj = torch.arange(nt, device=Mg.device)[None, :]
    valid = ((jj >= 1) & (jj <= n - 1) & ((i[:, None] - jj).abs() >= 2)
             & (delta < NEG_EPS_F32))
    d, j, found = _pick(torch.where(valid, delta, torch.inf), first_improvement)
    return d, torch.minimum(i, j), torch.maximum(i, j), found


def relocate_o2a(Mg: torch.Tensor, i: torch.Tensor, first_improvement: bool = False):
    """Best (or first) improving relocate of the city at position i:
    (delta, j, found)."""
    nt = Mg.shape[1]
    n = nt - 1
    d1, d2 = _offdiag(Mg, 1), _offdiag(Mg, 2)
    d1s, d2s = _shift_right(d1), _shift_right(d2)
    at = lambda v: v.gather(1, i[:, None])  # noqa: E731
    rem_i = (-at(d1s) - at(d1)) + at(d2s)
    row_i = _rows(Mg, i)
    ins_gt = (-d1 + row_i) + F.pad(row_i[:, 1:], (0, 1))  # j > i
    ins_lt = (-d1s + _shift_right(row_i)) + row_i  # j < i
    jj = torch.arange(nt, device=Mg.device)[None, :]
    delta = rem_i + torch.where(jj > i[:, None], ins_gt, ins_lt)
    valid = (jj >= 1) & (jj <= n - 1) & (jj != i[:, None]) & (delta < NEG_EPS_F32)
    d, j, found = _pick(torch.where(valid, delta, torch.inf), first_improvement)
    return d, j, found


def apply_two_opt(tours, i, j):
    """Reverse positions [i, j-1] (i < j) of every tour."""
    p = torch.arange(tours.shape[1], device=tours.device)[None, :]
    i, j = i[:, None], j[:, None]
    src = torch.where((p >= i) & (p < j), i + j - 1 - p, p)
    return tours.gather(1, src)


def apply_relocate(tours, i, j):
    """Pop position i and insert it at position j."""
    nt = tours.shape[1]
    p = torch.arange(nt, device=tours.device)[None, :]
    i, j = i[:, None], j[:, None]
    src_lt = torch.where(p < i, p, torch.where(p < j, p + 1, torch.where(p == j, i, p)))
    src_gt = torch.where(p < j, p, torch.where(p == j, i, torch.where(p <= i, p - 1, p)))
    src = torch.where(i < j, src_lt, src_gt).clamp(0, nt - 1)
    return tours.gather(1, src)
