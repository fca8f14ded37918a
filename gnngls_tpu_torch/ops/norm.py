"""BatchNorm with torch BatchNorm1d's semantics (gnngls_tpu/ops/norm.py).

The activations are (B, E, C); the reference normalises over all line-graph
nodes of a mini-batch, so every axis but the last is reduced.
  * training: normalise with the biased batch variance; update the running
    statistics in place with momentum 0.1, running_var taking the unbiased
    variance count / (count - 1) * var.
  * eval: normalise with the running statistics.
Written out rather than taken from nn.BatchNorm1d so that the expression
order is gnngls_tpu's: (x - mean) * rsqrt(var + eps) * scale + bias, eps 1e-5.

Data parallelism (parallel/train_dp.py) normalises over the global batch, as
the JAX package's sharded program does: inside `batch_norm_group(model,
group)` a train-mode BatchNorm sums over the group's ranks (the sum, then the
squared deviations from the global mean: the two-pass variance over the
global count), differentiably.  Without a group it computes what it always
did.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch import nn

EPS = 1e-5
MOMENTUM = 0.1


class _AllReduceSum(torch.autograd.Function):
    """The sum over a group's ranks; its backward sums the cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class BatchNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.group = None  # a process group: statistics over its ranks' batches

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            axes = tuple(range(x.dim() - 1))
            count = x.numel() // x.shape[-1]
            if self.group is None:
                mean = x.mean(dim=axes)
                var = x.var(dim=axes, correction=0)
            else:
                n = torch.tensor(count, dtype=torch.float64, device=x.device)
                dist.all_reduce(n, group=self.group)
                count = int(n)
                mean = _AllReduceSum.apply(x.sum(dim=axes), self.group) / count
                var = _AllReduceSum.apply(((x - mean) ** 2).sum(dim=axes), self.group) / count
            with torch.no_grad():
                unbiased = var * (count / max(count - 1, 1))
                self.mean.copy_((1 - MOMENTUM) * self.mean + MOMENTUM * mean)
                self.var.copy_((1 - MOMENTUM) * self.var + MOMENTUM * unbiased)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * torch.rsqrt(var + EPS) * self.scale + self.bias


@contextlib.contextmanager
def batch_norm_group(model: nn.Module, group):
    """Within the block every BatchNorm of `model` takes its train-mode
    statistics over `group` (None: this rank's batch alone)."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.group = group
    try:
        yield
    finally:
        for m in norms:
            m.group = None
