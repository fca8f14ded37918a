"""Nearest-neighbour construction (gnngls_tpu/search/construct.py).

Greedy min-guide tour from the depot, closed at the depot; ties go to the
lowest city id, as Python's min() over G.neighbors does in the reference.
The other constructors wait for the reference-API slice.
"""

from __future__ import annotations

import torch


def nearest_neighbor_batch(W: torch.Tensor, depot: int = 0) -> torch.Tensor:
    """(B, n, n) guide matrices -> (B, n+1) int32 tours."""
    B, n, _ = W.shape
    ar = torch.arange(n, device=W.device)
    b = torch.arange(B, device=W.device)
    cur = torch.full((B,), depot, dtype=torch.long, device=W.device)
    visited = (ar == depot)[None, :].repeat(B, 1)
    order = [cur]
    for _ in range(n - 1):
        row = torch.where(visited, torch.inf, W[b, cur])
        mn = row.min(dim=1).values
        cur = torch.where(row == mn[:, None], ar, n).min(dim=1).values
        visited = visited | (ar[None, :] == cur[:, None])
        order.append(cur)
    order.append(order[0])
    return torch.stack(order, dim=1).to(torch.int32)
