"""Dense layer in gnngls_tpu's layout: w is (C_in, C_out), y = x @ w + b."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


class Linear(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(c_in, c_out))
        self.b = nn.Parameter(torch.zeros(c_out))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """torch.nn.Linear's default initialisation, as gnngls_tpu/ops/linear.py
        draws it: w and b from U(-1/sqrt(C_in), 1/sqrt(C_in))."""
        bound = 1.0 / math.sqrt(self.w.shape[0])
        with torch.no_grad():
            self.w.uniform_(-bound, bound, generator=generator)
            self.b.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.w) + self.b
