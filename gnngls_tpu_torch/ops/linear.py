"""Dense layer in gnngls_tpu's layout: w is (C_in, C_out), y = x @ w + b."""

from __future__ import annotations

import torch
from torch import nn


class Linear(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(c_in, c_out))
        self.b = nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.w) + self.b
