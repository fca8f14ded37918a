"""The per-move engine's perturbation phase as one CUDA launch for the batch
(csrc/gls_perturb.cu), and its wrapper.

`perturbation` takes the arguments of the plain twin
`search/local_search._perturbation` and gives its bits: the tours, the costs,
the penalties (bumped in place), the trace (cost rows and counts) and
`work[:, 1]`.  It returns the rounds the twin's lock step would have run:
an instance is active on a prefix of the rounds, so that is the largest of
the instances' own rounds, fetched as one host int.  One block runs one
instance's rounds, so nothing waits for the batch and no round syncs.

Range: CUDA float32 tensors, 1 <= n <= `max_n(global_layout=True)`
(131,072, past what the card holds).  Up to `max_n()` cities (14,495 on sm_90,
past the whole-GLS kernel's 8192) each block keeps its tour state in shared
memory; past that, in a global workspace that the wrapper allocates.  Past the
range the wrapper raises rather than compute some other way.  D, the guide
and the penalties are read at their strides; tours, costs and k are taken
contiguous.  The engine takes the twin on the CPU alone
(`local_search._perturb`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels


def max_n(global_layout: bool = False) -> int:
    """Largest n whose tour state fits one block's shared memory, or, with
    global_layout, the largest n the kernel takes."""
    return kernels.library().gls_perturb_max_n(int(global_layout))


def perturbation(D: torch.Tensor, Gm: torch.Tensor, P: torch.Tensor, k: torch.Tensor,
                 t: torch.Tensor, cost: torch.Tensor, trace, work: torch.Tensor, pm: int,
                 max_iters: int,
                 first_improvement: bool = False) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """D, Gm, P (B, n, n) f32, k and cost (B,) f32, t (B, n+1) int64, trace a
    `local_search.Trace`, work (B, 2) int32, all on one CUDA device ->
    (tours, costs, rounds).  Updates P, the trace and work in place."""
    mats = (D, Gm, P)
    f32 = (*mats, k, cost) + (() if trace.costs is None else (trace.costs,))
    if any(x.dtype != torch.float32 for x in f32) or t.dtype != torch.int64 \
            or trace.n.dtype != torch.int32 or work.dtype != torch.int32:
        raise TypeError("gls_perturb: D, the guide, P, k, cost and the trace's costs must be "
                        "float32, the tours int64, the trace's count and work int32")
    B, n, _ = D.shape
    if any(m.shape != (B, n, n) for m in mats) or t.shape != (B, n + 1) \
            or k.shape != (B,) or cost.shape != (B,):
        raise ValueError(f"gls_perturb: inconsistent shapes D {tuple(D.shape)}, guide "
                         f"{tuple(Gm.shape)}, P {tuple(P.shape)}, tours {tuple(t.shape)}")
    out = (trace.n, work) if trace.costs is None else (trace.costs, trace.n, work)
    dev = D.device
    if dev.type != "cuda" or any(x.device != dev for x in (*mats, k, t, cost, *out)):
        raise ValueError("gls_perturb: all tensors must be on one CUDA device")
    if not all(x.is_contiguous() for x in out):
        raise ValueError("gls_perturb: the trace and work must be contiguous")
    if not 1 <= n <= max_n(global_layout=True):
        raise ValueError(f"gls_perturb: n={n} outside the kernel's range "
                         f"[1, {max_n(global_layout=True)}]")
    t, cost, k = t.contiguous(), cost.contiguous(), k.contiguous()
    tours, costs = torch.empty_like(t), torch.empty_like(cost)
    rounds = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return tours, costs, 0
    ws = None  # the shared layout
    if n > max_n():
        ws = torch.empty((kernels.library().gls_perturb_workspace_bytes(B, n),),
                         dtype=torch.uint8, device=dev)
    err = kernels.library().gls_perturb_launch(
        D.data_ptr(), *D.stride(), Gm.data_ptr(), *Gm.stride(), P.data_ptr(), *P.stride(),
        k.data_ptr(), t.data_ptr(), cost.data_ptr(), tours.data_ptr(), costs.data_ptr(),
        None if trace.costs is None else trace.costs.data_ptr(),
        0 if trace.costs is None else trace.costs.shape[1], trace.n.data_ptr(),
        work.data_ptr(), rounds.data_ptr(), None if ws is None else ws.data_ptr(), B, n, pm,
        max_iters, int(first_improvement), dev.index, kernels.stream_of(D))
    kernels.check(err, "gls_perturb_launch")
    kernels.launches["gls_perturb"] += 1
    return tours, costs, int(rounds.max())
