"""Instance-sharded GLS evaluation (gnngls_tpu/parallel/eval_shard.py).

The searches are independent, so each rank of the "data" axis runs the
whole-GLS kernel (K1; its plain twin on a CPU mesh) on its contiguous share
of the instances, with no collective inside the search, and one all_gather
returns the global result to every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from ..search import batched
from .mesh import all_gather_cat, data_sharding


def make_sharded_gls(mesh, *, n_iters: int, perturbation_moves: int = 20,
                     trace_cap: int = 1024, use_shard_map: bool = True):
    """run(Ds, guide_stack, init_tours) -> (best_tours (B, n+1) int32,
    best_costs (B,) f32, accepted moves (B,) int64) of the whole batch, on
    every rank.  Every rank passes the global batch (B divisible by the
    axis' ranks) and searches its share, as `batched.run_fixed_kernel`.

    `trace_cap` and `use_shard_map` are gnngls_tpu's, accepted and unused:
    its trace count, the moves returned, counts every accepted move whatever
    the cap, and shard_map against a global jit is a choice of TPU program
    that changes no result."""
    group = mesh.get_group("data")
    dev = torch.device(mesh.device_type)

    def run(Ds, guide_stack, init_tours):
        res = batched.run_fixed_kernel(data_sharding(mesh, np.asarray(Ds)),
                                       data_sharding(mesh, np.asarray(guide_stack)),
                                       data_sharding(mesh, np.asarray(init_tours)),
                                       n_iters=n_iters,
                                       perturbation_moves=perturbation_moves, device=dev)
        local = (res.best_tours, res.best_costs.astype(np.float32), res.chunk_moves[:, -1])
        return tuple(all_gather_cat(torch.as_tensor(a, device=dev), group).cpu().numpy()
                     for a in local)

    return run
