"""Edge-regret model (gnngls_tpu/models/regret_gat.py).

  x -> Linear(in, embed)
    -> depth x [h = x + GATConv(x); BN; h = h + FFN(h); BN]
    -> Linear(embed, out)

As in the reference, the layer stack is built `for _ in range(n_heads)`, so
the depth is `n_heads` unless `depth_from_heads=False`; the shipped
checkpoints depend on it.

In train() mode each BatchNorm normalises with the batch statistics and
updates its running statistics; the GATConv must then be a route autograd
runs through (TRAIN_ROUTES): the kernel routes have no backward, in either
package.

Multi-device forwards, inference only: `forward_ring` (edge-sharded
activations, ops/gat_ring.py) and `forward_tp` (FFNs split over the hidden
units, ops/tp.py, on a copy from `shard_params_tp`).

Numerics: the JAX model runs every matmul in full f32 (HIGHEST).  `forward`
therefore turns TF32 off for cuBLAS and cuDNN (torch.backends.cuda.matmul.
allow_tf32 = False, torch.backends.cudnn.allow_tf32 = False) before it runs,
in either mode.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import List, Optional

import torch
from torch import nn

from ..core.graph import build_topology, n_from_edges
from ..ops.gat import GATParams, gat_conv, gat_conv_chunked, gat_conv_naive, init_gat_params
from ..ops.gat_group import gat_conv_group
from ..ops.gat_group_sep import gat_conv_group_sep
from ..ops.gat_sep import gat_conv_sep
from ..ops.linear import Linear
from ..ops.norm import BatchNorm

HIDDEN_DIM = 512
# GATConv routes that train (plain torch under autograd, gradients held to
# JAX's at 1e-4 of each leaf's scale); JAX's trainer runs "fast".
TRAIN_ROUTES = ("fast", "naive", "sep", "chunked")
# The bf16 routes round to bf16 where JAX rounds (their GATConv's gradients
# equal JAX's given the same inputs), but a rounding is a step: f32 noise of
# 1e-7 in the input features moves either package's own model gradients by
# 1e-3 to 1e-2 of a leaf's scale, so no second implementation holds them to
# the 1e-4 bar.  They refuse train mode (ROADMAP §3).
BF16_ROUTES = ("sep_fast", "bf16")


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
        self.bn1 = BatchNorm(cfg.embed_dim)
        self.ffn1 = Linear(cfg.embed_dim, cfg.hidden_dim)
        self.ffn2 = Linear(cfg.hidden_dim, cfg.embed_dim)
        self.bn2 = BatchNorm(cfg.embed_dim)


def gat_conv_for(gat_impl: str):
    """The GATConv that `gat_impl` names, as gnngls_tpu's `forward` routes
    it (models/regret_gat.py:123-165):

      auto, pallas              ops.gat_group.gat_conv_group (K2, or K3 past
                                the one-shot size)
      pallas_mxu                gat_conv_group(mxu=True) (K4)
      pallas_sep[_fast][@gc]    ops.gat_group_sep.gat_conv_group_sep (K5);
                                "_fast" takes bf16 payloads
      naive, fast               ops.gat.gat_conv_naive, ops.gat.gat_conv
      bf16                      ops.gat.gat_conv(fast=True)
      chunked                   ops.gat.gat_conv_chunked (large n)
      sep, sep_fast             ops.gat_sep.gat_conv_sep (sorted prefixes)

    "@gc" (an int >= 1) is the TPU kernel's city groups per grid cell: it is
    checked and then ignored, since it changes no number and the CUDA launch
    has no such grid.  Any other name raises ValueError (gnngls_tpu runs its
    dense path on an unknown name)."""
    if gat_impl in ("auto", "pallas"):
        return gat_conv_group
    if gat_impl == "pallas_mxu":
        return functools.partial(gat_conv_group, mxu=True)
    if gat_impl == "naive":
        return gat_conv_naive
    if gat_impl == "fast":
        return gat_conv
    if gat_impl == "bf16":
        return functools.partial(gat_conv, fast=True)
    if gat_impl == "chunked":
        return gat_conv_chunked
    if gat_impl in ("sep", "sep_fast"):
        return functools.partial(gat_conv_sep, fast=gat_impl == "sep_fast")
    base, at, gc = gat_impl.partition("@")
    if base in ("pallas_sep", "pallas_sep_fast"):
        if at and not (gc.isascii() and gc.isdigit() and int(gc) >= 1):
            raise ValueError(f"gat_impl {gat_impl!r}: the group chunk after '@' "
                             "must be an integer >= 1")
        return functools.partial(gat_conv_group_sep, fast=base == "pallas_sep_fast")
    raise ValueError(f"unknown gat_impl {gat_impl!r}")


class RegretGNN(nn.Module):
    """The model, made in eval mode.  Its GATConv runs through the route
    `gat_impl` names (`gat_conv_for`); the default is the group kernel (K2 or
    K3 on the card, the plain twin on the CPU), which has no backward: in
    train() mode pass one of TRAIN_ROUTES."""

    def __init__(self, cfg: RegretGNNConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = Linear(cfg.in_dim, cfg.embed_dim)
        self.layers = nn.ModuleList(AttentionLayer(cfg) for _ in range(cfg.depth))
        self.decision = Linear(cfg.embed_dim, cfg.out_dim)
        self.eval()

    def forward(self, x: torch.Tensor, taps: Optional[List[torch.Tensor]] = None,
                gat_impl: str = "auto") -> torch.Tensor:
        """x (B, E, in_dim) or (E, in_dim) -> (B, E, out_dim) or (E, out_dim).
        `taps` collects the embedding and every layer's output when a list is
        given, with x's batch axes."""
        conv = gat_conv_for(gat_impl)
        if self.training and gat_impl in BF16_ROUTES:
            raise NotImplementedError(
                f"training through gat_impl {gat_impl!r}: its bf16 rounding makes the "
                "gradients jump under f32 noise, so they cannot be held to JAX's "
                f"(ROADMAP §3); train through one of {TRAIN_ROUTES}")
        if self.training and gat_impl not in TRAIN_ROUTES:
            raise ValueError(f"gat_impl {gat_impl!r} has no backward; in train() mode "
                             f"use one of {TRAIN_ROUTES}")
        squeeze = x.dim() == 2
        if squeeze:
            x = x[None]
        exact_f32_matmuls()
        topo = build_topology(n_from_edges(x.shape[-2]))
        unbatch = (lambda t: t[0]) if squeeze else (lambda t: t)  # noqa: E731
        h = self.embed(x)
        if taps is not None:
            taps.append(unbatch(h))
        for layer in self.layers:
            h = h + conv(layer.gat.params(), topo, h, self.cfg.n_heads)
            h = layer.bn1(h)
            h = h + layer.ffn2(torch.relu(layer.ffn1(h)))
            h = layer.bn2(h)
            if taps is not None:
                taps.append(unbatch(h))
        return unbatch(self.decision(h))


def forward_ring(model: RegretGNN, x: torch.Tensor, n: int, *, mesh, axis: str = "model",
                 city_chunk: int = 8) -> torch.Tensor:
    """Edge-sharded inference over K_n: x (..., eper, in_dim), this rank's
    block of the edge axis padded over `axis` (ops.gat_ring.ring_pad, then
    edge_sharding) -> (..., eper, out_dim), the same block.  Every per-edge
    op stays local and the GATConvs exchange over the rings.  BatchNorm uses
    its running statistics, so the model must be in eval mode; padding lanes
    carry garbage (ops.gat_ring.ring_unpad strips them)."""
    from ..ops.gat_ring import gat_conv_ring

    if model.training:
        raise ValueError("forward_ring is inference only: call model.eval() first")
    exact_f32_matmuls()
    topo = build_topology(n)
    with torch.no_grad():
        h = model.embed(x)
        for layer in model.layers:
            h = h + gat_conv_ring(layer.gat.params(), topo, h, model.cfg.n_heads, mesh, axis,
                                  city_chunk=city_chunk)
            h = layer.bn1(h)
            h = h + layer.ffn2(torch.relu(layer.ffn1(h)))
            h = layer.bn2(h)
        return model.decision(h)


def shard_params_tp(model: RegretGNN, mesh, axis: str = "model") -> RegretGNN:
    """A copy of the model whose FFNs hold this rank's slices of the hidden
    units over `axis` (ops.tp.shard_ffn_params); everything else whole."""
    from ..ops.tp import shard_ffn_params

    tp = copy.deepcopy(model)
    for layer in tp.layers:
        layer.ffn1, layer.ffn2 = shard_ffn_params(layer.ffn1, layer.ffn2, mesh, axis)
    return tp


def forward_tp(model: RegretGNN, x: torch.Tensor, *, mesh, axis: str = "model",
               gat_impl: str = "fast") -> torch.Tensor:
    """The forward of a `shard_params_tp` copy: x (B, E, in_dim) replicated
    -> (B, E, out_dim) replicated.  The FFNs run split over `axis` with one
    all_reduce each (ops.tp.ffn_tp); the GATConv ("fast" or "naive"),
    BatchNorm (train or eval, as the model's mode; the running statistics
    update in train mode), embedding and decision run whole.  No gradient."""
    from ..ops.tp import ffn_tp

    conv = gat_conv_naive if gat_impl == "naive" else gat_conv
    exact_f32_matmuls()
    topo = build_topology(n_from_edges(x.shape[-2]))
    with torch.no_grad():
        h = model.embed(x)
        for layer in model.layers:
            h = h + conv(layer.gat.params(), topo, h, model.cfg.n_heads)
            h = layer.bn1(h)
            h = h + ffn_tp(layer.ffn1, layer.ffn2, h, mesh, axis)
            h = layer.bn2(h)
        return model.decision(h)


def init_params(cfg: RegretGNNConfig, generator: Optional[torch.Generator] = None) -> RegretGNN:
    """A `RegretGNN` with freshly drawn weights, from the distributions of
    gnngls_tpu's `init_params`: torch.nn.Linear's uniform for the embedding,
    the FFNs and the decision layer, DGL's Xavier-normal for each GATConv,
    BatchNorm at scale 1, bias 0, mean 0, var 1.  Torch cannot reproduce
    jax.random's draws, only their distributions."""
    model = RegretGNN(cfg)
    model.embed.reset_parameters(generator)
    with torch.no_grad():
        for layer in model.layers:
            for dst, src in zip(layer.gat.params(), init_gat_params(
                    cfg.embed_dim, cfg.n_heads, cfg.head_dim, generator)):
                dst.copy_(src)
            layer.ffn1.reset_parameters(generator)
            layer.ffn2.reset_parameters(generator)
    model.decision.reset_parameters(generator)
    return model


def count_params(model: nn.Module) -> int:
    """Trainable parameters (the BatchNorm running statistics are not)."""
    return sum(p.numel() for p in model.parameters())
