"""Edge-regret model, eval mode (gnngls_tpu/models/regret_gat.py).

  x -> Linear(in, embed)
    -> depth x [h = x + GATConv(x); BN; h = h + FFN(h); BN]
    -> Linear(embed, out)

As in the reference, the layer stack is built `for _ in range(n_heads)`, so
the depth is `n_heads` unless `depth_from_heads=False`; the shipped
checkpoints depend on it.

Numerics: the JAX model runs every matmul in full f32 (HIGHEST).  `forward`
therefore turns TF32 off for cuBLAS and cuDNN (torch.backends.cuda.matmul.
allow_tf32 = False, torch.backends.cudnn.allow_tf32 = False) before it runs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn

from ..core.graph import build_topology, n_from_edges
from ..ops.gat import GATParams
from ..ops.gat_group import gat_conv_group
from ..ops.linear import Linear
from ..ops.norm import BatchNormEval

HIDDEN_DIM = 512


@dataclasses.dataclass(frozen=True)
class RegretGNNConfig:
    in_dim: int = 1
    embed_dim: int = 128
    out_dim: int = 1
    n_layers: int = 3
    n_heads: int = 8
    hidden_dim: int = HIDDEN_DIM
    depth_from_heads: bool = True

    @property
    def depth(self) -> int:
        return self.n_heads if self.depth_from_heads else self.n_layers

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.n_heads


def exact_f32_matmuls() -> None:
    """Full-f32 products on the card, as the JAX model's HIGHEST precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class GATConvParams(nn.Module):
    def __init__(self, c_in: int, n_heads: int, head_dim: int):
        super().__init__()
        self.fc_w = nn.Parameter(torch.zeros(c_in, n_heads * head_dim))
        self.attn_l = nn.Parameter(torch.zeros(n_heads, head_dim))
        self.attn_r = nn.Parameter(torch.zeros(n_heads, head_dim))

    def params(self) -> GATParams:
        return GATParams(self.fc_w, self.attn_l, self.attn_r)


class AttentionLayer(nn.Module):
    def __init__(self, cfg: RegretGNNConfig):
        super().__init__()
        self.gat = GATConvParams(cfg.embed_dim, cfg.n_heads, cfg.head_dim)
        self.bn1 = BatchNormEval(cfg.embed_dim)
        self.ffn1 = Linear(cfg.embed_dim, cfg.hidden_dim)
        self.ffn2 = Linear(cfg.hidden_dim, cfg.embed_dim)
        self.bn2 = BatchNormEval(cfg.embed_dim)


class RegretGNN(nn.Module):
    """Eval-only model; its GATConv runs through the group kernel
    (`ops.gat_group.gat_conv_group`: the CUDA kernel on the card, the plain
    twin on the CPU)."""

    def __init__(self, cfg: RegretGNNConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = Linear(cfg.in_dim, cfg.embed_dim)
        self.layers = nn.ModuleList(AttentionLayer(cfg) for _ in range(cfg.depth))
        self.decision = Linear(cfg.embed_dim, cfg.out_dim)
        self.eval()

    def forward(self, x: torch.Tensor, taps: Optional[List[torch.Tensor]] = None
                ) -> torch.Tensor:
        """x (B, E, in_dim) -> (B, E, out_dim).  `taps` collects the embedding
        and every layer's output when a list is given."""
        if self.training:
            raise NotImplementedError("training mode waits for the training "
                                      "slice of the port; call .eval()")
        exact_f32_matmuls()
        topo = build_topology(n_from_edges(x.shape[-2]))
        h = self.embed(x)
        if taps is not None:
            taps.append(h)
        for layer in self.layers:
            h = h + gat_conv_group(layer.gat.params(), topo, h, self.cfg.n_heads)
            h = layer.bn1(h)
            h = h + layer.ffn2(torch.relu(layer.ffn1(h)))
            h = layer.bn2(h)
            if taps is not None:
                taps.append(h)
        return self.decision(h)
