"""Tour construction (gnngls_tpu/search/construct.py).

* `nearest_neighbor_batch`: greedy min-guide tour from the depot, closed at
  the depot; ties go to the lowest city id, as Python's min() over
  G.neighbors does in the reference.  CUDA guides take one launch of
  csrc/nearest_neighbor.cu for the batch (f32 or f64; other dtypes raise);
  CPU tensors take the plain twin `nearest_neighbor_plain`, n - 1 steps of
  batched torch ops.  Both give the same tours, bit for bit.
* `probabilistic_nearest_neighbour` and its best-of-n: the next city is
  sampled with weights from the (inverted) guide row, with the reference's
  guards.  A categorical draw is argmax(logits + g) with g Gumbel noise, which
  is how jax.random.categorical draws it; the noise may be passed in, so the
  same noise gives JAX's tours.  The steps run batched over instances and
  samples on the guide's device.
* `cheapest_insertion` and `insertion`: host numpy, exact.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import kernels
from .moves import tour_costs


def nearest_neighbor_batch(W: torch.Tensor, depot: int = 0) -> torch.Tensor:
    """(B, n, n) guide matrices -> (B, n+1) int32 tours on W's device.

    A CUDA W, f32 or f64 at any strides, is read in place by one kernel
    launch; a CPU W takes `nearest_neighbor_plain`."""
    if W.dim() != 3 or W.shape[1] != W.shape[2]:
        raise ValueError(f"nearest_neighbor_batch: expected W (B, n, n), got {tuple(W.shape)}")
    if W.device.type != "cuda":
        return nearest_neighbor_plain(W, depot)
    if W.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"nearest_neighbor_batch: a CUDA W must be float32 or float64, "
                        f"got {W.dtype}")
    B, n, _ = W.shape
    if not 0 <= depot < n:
        raise ValueError(f"nearest_neighbor_batch: depot {depot} is not one of {n} cities")
    tours = torch.empty((B, n + 1), dtype=torch.int32, device=W.device)
    if B == 0:
        return tours
    lib = kernels.library()
    seen = torch.empty(lib.nearest_neighbor_workspace_bytes(B, n), dtype=torch.uint8,
                       device=W.device)
    err = lib.nearest_neighbor_launch(W.data_ptr(), *W.stride(), B, n, depot,
                                      int(W.dtype == torch.float64), seen.data_ptr(),
                                      tours.data_ptr(), W.device.index, kernels.stream_of(W))
    kernels.check(err, "nearest_neighbor_launch")
    kernels.launches["nearest_neighbor"] += 1
    return tours


def nearest_neighbor_plain(W: torch.Tensor, depot: int = 0) -> torch.Tensor:
    """The twin of the kernel: (B, n, n) guides -> (B, n+1) int32 tours, one
    step of batched ops a city.  Visited cities read +inf; the next city is
    the lowest id whose entry equals the row's least, so a row whose
    unvisited entries are all +inf picks city 0, visited or not."""
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


def gumbel_noise(shape, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """-log(-log(u)) with u uniform in [tiny, 1), drawn on the generator's
    device (the CPU's default generator when None)."""
    device = generator.device if generator is not None else "cpu"
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def probabilistic_nearest_neighbour_batch(W: torch.Tensor, depot: int, noise: torch.Tensor,
                                          invert: bool = True) -> torch.Tensor:
    """(B, n, n) guides and (B, n-1, n) Gumbel noise -> (B, n+1) int32 tours.

    Step t from city c: p = W[c]; if any entry of p is +-inf, p becomes
    the indicator of the inf entries; if p sums to 0 over the unvisited
    cities, p becomes all ones; invert takes 1/p; visited cities get
    logit -inf, the others log p; the next city is the first argmax of
    logits + noise[:, t]."""
    B, n, _ = W.shape
    ar = torch.arange(n, device=W.device)
    b = torch.arange(B, device=W.device)
    noise = noise.to(device=W.device, dtype=W.dtype)
    cur = torch.full((B,), depot, dtype=torch.long, device=W.device)
    visited = (ar == depot)[None, :].repeat(B, 1)
    order = [cur]
    for t in range(n - 1):
        p = W[b, cur]
        is_inf = torch.isinf(p)
        p = torch.where(is_inf.any(dim=1, keepdim=True), is_inf.to(W.dtype), p)
        masked_sum = torch.where(visited, 0.0, p).sum(dim=1, keepdim=True)
        p = torch.where(masked_sum == 0.0, torch.ones_like(p), p)
        if invert:
            p = 1.0 / p
        logits = torch.where(visited, -torch.inf, torch.log(p))
        cur = torch.argmax(logits + noise[:, t], dim=1)
        visited = visited | (ar[None, :] == cur[:, None])
        order.append(cur)
    order.append(order[0])
    return torch.stack(order, dim=1).to(torch.int32)


def probabilistic_nearest_neighbour(W: torch.Tensor, depot: int, invert: bool = True,
                                    generator: Optional[torch.Generator] = None,
                                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One sampled tour over the (n, n) guide W: (n+1,) int32.  noise
    (n-1, n), by default drawn from `generator`."""
    n = W.shape[0]
    if noise is None:
        noise = gumbel_noise((n - 1, n), generator)
    return probabilistic_nearest_neighbour_batch(W[None], depot, noise[None], invert)[0]


def best_probabilistic_nearest_neighbour(W: torch.Tensor, depot: int, n_iters: int,
                                         guide: Optional[torch.Tensor] = None,
                                         generator: Optional[torch.Generator] = None,
                                         noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The best of n_iters tours sampled over `guide` (default W) by their
    cost under W, the first on ties: (n+1,) int32.  noise (n_iters, n-1, n),
    by default drawn from `generator`; the samples run as one batch."""
    n = W.shape[0]
    guide = W if guide is None else guide
    if noise is None:
        noise = gumbel_noise((n_iters, n - 1, n), generator)
    tours = probabilistic_nearest_neighbour_batch(guide.expand(n_iters, n, n), depot, noise)
    costs = tour_costs(W.expand(n_iters, n, n), tours.long())
    return tours[torch.argmin(costs)]


# ---------------------------------------------------------------------------
# Host-side insertion heuristics (the reference's API, gnngls/algorithms.py)


def cheapest_insertion(W: np.ndarray, sub_tour, node) -> list:
    """Insert `node` into the closed sub-tour where the whole re-costed tour
    is cheapest; the first minimum wins."""
    sub_tour = list(sub_tour)
    best, best_cost = None, None
    for j in range(1, len(sub_tour)):
        cand = sub_tour[:j] + [node] + sub_tour[j:]
        cost = float(np.asarray(W)[cand[:-1], cand[1:]].sum())
        if best is None or cost < best_cost:
            best, best_cost = cand, cost
    return best


def insertion(W: np.ndarray, depot: int, mode: str = "farthest", rng=None) -> list:
    """Random, nearest or farthest insertion from the depot's loop; `rng` a
    numpy Generator (a fresh one when None) for mode "random"."""
    if mode not in ("random", "nearest", "farthest"):
        raise ValueError(f"Unknown mode: {mode}")
    W = np.asarray(W)
    n = W.shape[0]
    rng = np.random.default_rng() if rng is None else rng
    nodes = [x for x in range(n) if x != depot]
    tour = [depot, depot]
    while nodes:
        if mode == "random":
            nxt = int(rng.choice(nodes))
        else:
            nxt, nxt_cost = None, None
            for i in tour:
                for j in nodes:
                    w = W[i, j]
                    if (nxt is None or (mode == "nearest" and w < nxt_cost)
                            or (mode == "farthest" and w > nxt_cost)):
                        nxt, nxt_cost = j, w
        nodes.remove(nxt)
        tour = cheapest_insertion(W, tour, nxt)
    return tour
