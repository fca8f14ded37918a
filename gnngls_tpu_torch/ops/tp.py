"""Tensor-parallel FFN, Megatron's column/row split (gnngls_tpu/ops/tp.py).

The AttentionLayer FFN, Linear(embed, hidden) -> ReLU -> Linear(hidden,
embed), with the hidden units split over a mesh axis: each rank keeps a
slice of ffn1's output columns and the same slice of ffn2's input rows,
computes its partial output, and one all_reduce(SUM) over the axis sums
them.  The activations stay replicated.  Inference only: the all_reduce
has no backward here.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from .linear import Linear


def shard_ffn_params(ffn1: Linear, ffn2: Linear, mesh, axis: str = "model"
                     ) -> Tuple[Linear, Linear]:
    """This rank's slices: ffn1's weight columns and bias, ffn2's weight
    rows (weights are (C_in, C_out)); ffn2's bias whole."""
    ndev = mesh[axis].size()
    hidden = ffn1.w.shape[1]
    if hidden % ndev != 0:
        raise ValueError(f"hidden dim {hidden} not divisible by {ndev} '{axis}' devices")
    per = hidden // ndev
    lo = mesh.get_local_rank(axis) * per
    f1, f2 = Linear(ffn1.w.shape[0], per), Linear(per, ffn2.w.shape[1])
    with torch.no_grad():
        f1.w.copy_(ffn1.w[:, lo:lo + per])
        f1.b.copy_(ffn1.b[lo:lo + per])
        f2.w.copy_(ffn2.w[lo:lo + per])
        f2.b.copy_(ffn2.b)
    return f1.to(ffn1.w.device), f2.to(ffn2.w.device)


def ffn_tp(ffn1: Linear, ffn2: Linear, x: torch.Tensor, mesh, axis: str = "model"
           ) -> torch.Tensor:
    """x (..., C) -> (..., C): relu(x W1_i + b1_i) W2_i summed over the
    axis, then + b2; (ffn1, ffn2) are this rank's `shard_ffn_params`."""
    part = torch.matmul(torch.relu(ffn1(x)), ffn2.w)
    dist.all_reduce(part, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return part + ffn2.b
