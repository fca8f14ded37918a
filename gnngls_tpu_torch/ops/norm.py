"""BatchNorm in eval mode with running statistics (torch BatchNorm1d, eps 1e-5).

Written out rather than taken from nn.BatchNorm1d so that the expression
order is gnngls_tpu/ops/norm.py's: (x - mean) * rsqrt(var + eps) * scale + bias.
Training-mode statistics wait for the training slice.
"""

from __future__ import annotations

import torch
from torch import nn

EPS = 1e-5


class BatchNormEval(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) * torch.rsqrt(self.var + EPS) * self.scale + self.bias
