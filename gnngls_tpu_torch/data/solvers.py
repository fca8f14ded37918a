"""The GLS oracle: near-optimal tours for generated instances
(gnngls_tpu/data/solvers.py::gls_oracle).

Weight-guided fixed-budget GLS from a nearest-neighbour start on D, run by
`search.batched.run_fixed_kernel`: the whole-GLS kernel on the card, its plain
twin on the CPU.  If the kernel fails, the oracle raises; nothing falls back
to another engine.  The exact solvers (Held-Karp, Concorde) wait for the
data-generation slice of the port.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


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
