"""BatchNorm with torch BatchNorm1d's semantics (gnngls_tpu/ops/norm.py).

The activations are (B, E, C); the reference normalises over all line-graph
nodes of a mini-batch, so every axis but the last is reduced.
  * training: normalise with the biased batch variance; update the running
    statistics in place with momentum 0.1, running_var taking the unbiased
    variance count / (count - 1) * var.
  * eval: normalise with the running statistics.
Written out rather than taken from nn.BatchNorm1d so that the expression
order is gnngls_tpu's: (x - mean) * rsqrt(var + eps) * scale + bias, eps 1e-5.
"""

from __future__ import annotations

import torch
from torch import nn

EPS = 1e-5
MOMENTUM = 0.1


class BatchNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(dim=axes)
            var = x.var(dim=axes, correction=0)
            count = x.numel() // x.shape[-1]
            with torch.no_grad():
                unbiased = var * (count / max(count - 1, 1))
                self.mean.copy_((1 - MOMENTUM) * self.mean + MOMENTUM * mean)
                self.var.copy_((1 - MOMENTUM) * self.var + MOMENTUM * unbiased)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * torch.rsqrt(var + EPS) * self.scale + self.bias
