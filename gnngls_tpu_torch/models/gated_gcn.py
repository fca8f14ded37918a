"""The residual gated GCN of Joshi, Laurent & Bresson, "An Efficient Graph
Convolutional Network Technique for the Travelling Salesman Problem"
(arXiv:1906.01227; github.com/chaitjo/graph-convnet-tsp, `models/`), as an
edge scorer for the search: p_ij, the probability that edge (i, j) is in the
tour.

Inputs: coordinates c (B, n, 2), distances d (B, n, n) and k-NN tags
(B, n, n): 1 where j is one of the k nearest other cities of i, 2 on the
diagonal, 0 elsewhere (`knn_tags`), so the edge tensor is not symmetric.

    x_i  = W_n c_i                                     (no bias)
    e_ij = [W_v d_ij || T[tag_ij]]                     (H/2 each, no bias)
    L x  [ e^_ij = U_e e_ij + V_e x_i + V_e x_j
           g_ij  = sigmoid(e^_ij)
           x^_i  = U_n x_i + sum_j g_ij * V_n x_j / (1e-20 + sum_j g_ij)
           x <- x + relu(BN(x^));  e <- e + relu(BN(e^)) ]
    logits_ij = MLP(e_ij)       (mlp_layers - 1 H x H layers with ReLU, then H -> 2)

The aggregation is the published TSP configurations' "mean" (the published
code's other choice, "sum", is not ported).  BatchNorm keeps no running
statistics (the published `track_running_stats=False`): it normalises with
the batch's own biased statistics in eval mode too, nodes over (B, n) and
edges over (B, n, n), eps 1e-5, affine.  So an instance's logits depend on
the instances it is batched with.

The edge tensor is laid out (B, n, n, H) throughout, and BatchNorm reads it
as (B n n, H) rows, which gives the published BatchNorm2d's statistics
without its two transposed copies.  Module and parameter names are the
published ones, so a state dict of the published model loads as it is.
The one departure: `knn_tags` breaks equal distances toward the lower city
id, where the published `argpartition` leaves the order undefined.

`edge_guide` turns logits into the search's undirected guide,
1 - (p_ij + p_ji) / 2 with 0 on the diagonal: low where the model is
confident that the edge is in the tour.

Numerics: float32 products with TF32 off, under
`regret_gat.exact_f32_matmuls` (`evaluate.predict_edge_guide`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class GatedGCNConfig:
    """The widths of the published TSP100 configuration (configs/tsp100.json)."""

    hidden_dim: int = 300
    num_layers: int = 30
    mlp_layers: int = 3
    num_neighbors: int = 20
    node_dim: int = 2
    voc_edges_in: int = 3
    voc_edges_out: int = 2
    aggregation: str = "mean"

    def __post_init__(self):
        if self.aggregation != "mean":
            raise ValueError(f"aggregation {self.aggregation!r}: only 'mean' is ported")
        if self.hidden_dim % 2:
            raise ValueError(f"hidden_dim {self.hidden_dim} must be even (two edge halves)")


class BatchNorm(nn.Module):
    """BatchNorm over every axis but the last, with batch statistics in eval
    mode too (the published BatchNormNode and BatchNormEdge)."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        self.batch_norm = nn.BatchNorm1d(hidden_dim, track_running_stats=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.batch_norm(x.reshape(-1, x.shape[-1])).view_as(x)


class NodeFeatures(nn.Module):
    def __init__(self, hidden_dim: int):
        super().__init__()
        self.U = nn.Linear(hidden_dim, hidden_dim)
        self.V = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
        """x (B, n, H), gate (B, n, n, H) -> x^ (B, n, H)."""
        gate_vx = (gate * self.V(x).unsqueeze(1)).sum(2)
        return self.U(x) + gate_vx / (1e-20 + gate.sum(2))


class EdgeFeatures(nn.Module):
    def __init__(self, hidden_dim: int):
        super().__init__()
        self.U = nn.Linear(hidden_dim, hidden_dim)
        self.V = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
        """x (B, n, H), e (B, n, n, H) -> e^ (B, n, n, H): U e_ij + V x_i + V x_j."""
        vx = self.V(x)
        return self.U(e).add_(vx.unsqueeze(2)).add_(vx.unsqueeze(1))


class GatedGCNLayer(nn.Module):
    def __init__(self, hidden_dim: int):
        super().__init__()
        self.node_feat = NodeFeatures(hidden_dim)
        self.edge_feat = EdgeFeatures(hidden_dim)
        self.bn_node = BatchNorm(hidden_dim)
        self.bn_edge = BatchNorm(hidden_dim)

    def forward(self, x: torch.Tensor, e: torch.Tensor):
        e_hat = self.edge_feat(x, e)
        x_hat = self.node_feat(x, torch.sigmoid(e_hat))
        return x + self.bn_node(x_hat).relu_(), e + self.bn_edge(e_hat).relu_()


class MLP(nn.Module):
    def __init__(self, hidden_dim: int, output_dim: int, layers: int):
        super().__init__()
        self.U = nn.ModuleList(nn.Linear(hidden_dim, hidden_dim) for _ in range(layers - 1))
        self.V = nn.Linear(hidden_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for u in self.U:
            x = u(x).relu_()
        return self.V(x)


class GatedGCN(nn.Module):
    """The model (module docstring), made in eval mode."""

    def __init__(self, cfg: GatedGCNConfig = GatedGCNConfig()):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_dim
        self.nodes_coord_embedding = nn.Linear(cfg.node_dim, H, bias=False)
        self.edges_values_embedding = nn.Linear(1, H // 2, bias=False)
        self.edges_embedding = nn.Embedding(cfg.voc_edges_in, H // 2)
        self.gcn_layers = nn.ModuleList(GatedGCNLayer(H) for _ in range(cfg.num_layers))
        self.mlp_edges = MLP(H, cfg.voc_edges_out, cfg.mlp_layers)
        self.eval()

    def forward(self, coords: torch.Tensor, dists: torch.Tensor,
                tags: torch.Tensor) -> torch.Tensor:
        """coords (B, n, 2), dists (B, n, n) float32, tags (B, n, n) int64 ->
        logits (B, n, n, voc_edges_out)."""
        x = self.nodes_coord_embedding(coords)
        e = torch.cat((self.edges_values_embedding(dists.unsqueeze(3)),
                       self.edges_embedding(tags)), dim=3)
        for layer in self.gcn_layers:
            x, e = layer(x, e)
        return self.mlp_edges(e)


def knn_tags(D: torch.Tensor, k: int) -> torch.Tensor:
    """(B, n, n) distances -> (B, n, n) int64 tags on D's device: 1 for the
    min(k, n - 1) nearest other cities of each row, equal distances going to
    the lower city id, 2 on the diagonal, 0 elsewhere."""
    n = D.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=D.device)
    order = torch.sort(D.masked_fill(eye, float("inf")), dim=-1, stable=True).indices
    tags = torch.zeros(D.shape, dtype=torch.int64, device=D.device)
    tags.scatter_(-1, order[..., :min(k, n - 1)], 1)
    return tags.masked_fill_(eye, 2)


def edge_guide(logits: torch.Tensor) -> torch.Tensor:
    """(B, n, n, 2) logits -> (B, n, n) float32 guide 1 - (p + p^T) / 2, 0 on
    the diagonal, p = softmax(logits)[..., 1]."""
    p = torch.softmax(logits, dim=-1)[..., 1]
    guide = 1.0 - (p + p.transpose(1, 2)) / 2
    guide.diagonal(dim1=1, dim2=2).zero_()
    return guide


def load_model(path, cfg: GatedGCNConfig, device=None) -> GatedGCN:
    """A `GatedGCN` with the weights of an npz of arrays under its state-dict
    names (a path or a file object), every name required, on `device`:
    "cuda" unless the caller asks for "cpu" (`evaluate.resolve_device`)."""
    from ..evaluate import resolve_device

    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        state = {k: torch.from_numpy(np.array(z[k], np.float32)) for k in z.files}
    model = GatedGCN(cfg)
    model.load_state_dict(state, strict=True)
    return model.to(device)
