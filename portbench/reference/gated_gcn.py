"""The plain reference of the residual gated GCN (Joshi, Laurent & Bresson,
arXiv:1906.01227; github.com/chaitjo/graph-convnet-tsp), for the benchmark:
plain torch, op by op as the published code computes them, in its layout
((B, n, n, H) edges, BatchNorm through the published
`transpose(1, 3).contiguous()` copies).  It imports nothing of the program,
reads no checkpoint, and draws its weights from a seed.

The aggregation is the published TSP configurations' "mean"; the published
code's "sum" is not carried.  The one departure from the published code:
`knn_tags` breaks equal distances toward the lower city id (a stable sort),
where the published `argpartition` leaves the order undefined.  The guide,
1 - (p_ij + p_ji) / 2 with 0 on the diagonal, is the search's reading of p,
not the published model's (which is decoded by beam search).

Precision: "f32" holds float32 products without TF32; "tf32" computes the
products with TF32 operands, the next precision below (on the card through
cuBLAS's TF32 path; on the CPU by rounding each product's operands to TF32,
`to_tf32`, as the GAT's reference does).

The port's CPU tests (tests/test_torch_gated_gcn.py) hold the program to it
in "f32".  BatchNorm ties each instance to its batch, so `predict` runs whole batches:
the caller hands it the batches the program ran.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
PRECISIONS = ("f32", "tf32")


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """Every parameter's shape under the published state-dict names, in the
    order the weights are drawn."""
    H, out = cfg["hidden_dim"], cfg["voc_edges_out"]
    shapes = {"nodes_coord_embedding.weight": (H, cfg["node_dim"]),
              "edges_values_embedding.weight": (H // 2, 1),
              "edges_embedding.weight": (cfg["voc_edges_in"], H // 2)}
    for i in range(cfg["num_layers"]):
        p = f"gcn_layers.{i}."
        for feat in ("node_feat", "edge_feat"):
            for lin in ("U", "V"):
                shapes[f"{p}{feat}.{lin}.weight"] = (H, H)
                shapes[f"{p}{feat}.{lin}.bias"] = (H,)
        for bn in ("bn_node", "bn_edge"):
            shapes[f"{p}{bn}.batch_norm.weight"] = (H,)
            shapes[f"{p}{bn}.batch_norm.bias"] = (H,)
    for j in range(cfg["mlp_layers"] - 1):
        shapes[f"mlp_edges.U.{j}.weight"] = (H, H)
        shapes[f"mlp_edges.U.{j}.bias"] = (H,)
    shapes["mlp_edges.V.weight"] = (out, H)
    shapes["mlp_edges.V.bias"] = (out,)
    return shapes


def make_weights(cfg: dict, seed: int) -> Dict[str, np.ndarray]:
    """Float32 weights drawn from NumPy's generator seeded with `seed`, in
    `param_shapes`' order: a Linear's weight and bias uniform in
    +-1/sqrt(its fan-in), the tag embedding standard normal, BatchNorm's
    scale 1 and shift 0 (no draw)."""
    rng = np.random.default_rng(int(seed))
    out = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith("batch_norm.weight"):
            out[name] = np.ones(shape, np.float32)
        elif name.endswith("batch_norm.bias"):
            out[name] = np.zeros(shape, np.float32)
        elif name == "edges_embedding.weight":
            out[name] = rng.standard_normal(shape).astype(np.float32)
        else:
            fan_in = shape[1] if name.endswith(".weight") else out[name[:-4] + "weight"].shape[1]
            bound = 1.0 / np.sqrt(fan_in)
            out[name] = rng.uniform(-bound, bound, shape).astype(np.float32)
    return out


def distances(coords: np.ndarray) -> np.ndarray:
    """(..., n, 2) float32 coordinates -> (..., n, n) float32 distances."""
    d = coords[..., :, None, :] - coords[..., None, :, :]
    return np.sqrt((d * d).sum(-1)).astype(np.float32)


def knn_tags(D: np.ndarray, k: int) -> np.ndarray:
    """(B, n, n) distances -> int64 tags: 1 for the min(k, n - 1) nearest other
    cities of each row (ties to the lower id), 2 on the diagonal, else 0."""
    B, n, _ = D.shape
    masked = np.where(np.eye(n, dtype=bool), np.inf, D)
    near = np.argsort(masked, axis=-1, kind="stable")[..., :min(k, n - 1)]
    tags = np.zeros((B, n, n), np.int64)
    np.put_along_axis(tags, near, 1, axis=-1)
    tags[:, np.arange(n), np.arange(n)] = 2
    return tags


@contextlib.contextmanager
def precision(name: str):
    """The products' precision for the block (module docstring)."""
    if name not in PRECISIONS:
        raise ValueError(f"precision {name!r} not in {PRECISIONS}")
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high" if name == "tf32" else "highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest even), held in float32."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def _linear(t: torch.Tensor, w: torch.Tensor, b=None, prec: str = "f32") -> torch.Tensor:
    if prec == "tf32" and t.device.type == "cpu":
        y = torch.matmul(to_tf32(t), to_tf32(w).T)
        return y if b is None else y + b
    return F.linear(t, w, b)


def _bn(t: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.batch_norm(t, None, None, w, b, training=True, momentum=0.1, eps=BN_EPS)


def forward(weights: Dict[str, torch.Tensor], cfg: dict, coords: torch.Tensor,
            dists: torch.Tensor, tags: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    """coords (B, n, 2), dists (B, n, n), tags (B, n, n) -> logits (B, n, n, 2)."""
    w = weights
    x = _linear(coords, w["nodes_coord_embedding.weight"], prec=prec)
    e_vals = _linear(dists.unsqueeze(3), w["edges_values_embedding.weight"], prec=prec)
    e_tags = F.embedding(tags, w["edges_embedding.weight"])
    e = torch.cat((e_vals, e_tags), dim=3)
    for i in range(cfg["num_layers"]):
        p = f"gcn_layers.{i}."

        def lin(t, name):
            return _linear(t, w[p + name + ".weight"], w[p + name + ".bias"], prec)

        e_in, x_in = e, x
        # EdgeFeatures
        Ue = lin(e_in, "edge_feat.U")
        Vx = lin(x_in, "edge_feat.V")
        Wx = Vx.unsqueeze(1)
        Vx = Vx.unsqueeze(2)
        e_tmp = Ue + Vx + Wx
        edge_gate = torch.sigmoid(e_tmp)
        # NodeFeatures
        Ux = lin(x_in, "node_feat.U")
        Vx = lin(x_in, "node_feat.V").unsqueeze(1)
        gateVx = edge_gate * Vx
        x_tmp = Ux + torch.sum(gateVx, dim=2) / (1e-20 + torch.sum(edge_gate, dim=2))
        # BatchNormEdge, BatchNormNode
        e_tmp = _bn(e_tmp.transpose(1, 3).contiguous(), w[p + "bn_edge.batch_norm.weight"],
                    w[p + "bn_edge.batch_norm.bias"]).transpose(1, 3).contiguous()
        x_tmp = _bn(x_tmp.transpose(1, 2).contiguous(), w[p + "bn_node.batch_norm.weight"],
                    w[p + "bn_node.batch_norm.bias"]).transpose(1, 2).contiguous()
        e = e_in + F.relu(e_tmp)
        x = x_in + F.relu(x_tmp)
    for j in range(cfg["mlp_layers"] - 1):
        e = F.relu(_linear(e, w[f"mlp_edges.U.{j}.weight"], w[f"mlp_edges.U.{j}.bias"], prec))
    return _linear(e, w["mlp_edges.V.weight"], w["mlp_edges.V.bias"], prec)


def guides(logits: torch.Tensor) -> torch.Tensor:
    """(B, n, n, 2) logits -> (B, n, n) 1 - (p + p^T) / 2, 0 on the diagonal."""
    p = torch.softmax(logits, dim=-1)[..., 1]
    g = 1.0 - (p + p.transpose(1, 2)) / 2
    n = g.shape[-1]
    g[:, torch.arange(n), torch.arange(n)] = 0.0
    return g


@torch.no_grad()
def predict(weights: Dict[str, np.ndarray], cfg: dict, coords: np.ndarray, *,
            prec: str = "f32", device="cpu", batch: int = 1) -> np.ndarray:
    """(N, n, n) float32 guides for (N, n, 2) coordinates in precision
    `prec`, `batch` consecutive instances a forward (each forward one
    BatchNorm batch)."""
    w = {k: torch.as_tensor(v, device=device) for k, v in weights.items()}
    out = []
    with precision(prec):
        for s in range(0, len(coords), batch):
            c = np.asarray(coords[s:s + batch], np.float32)
            D = distances(c)
            tags = knn_tags(D, cfg["num_neighbors"])
            logits = forward(w, cfg, torch.as_tensor(c, device=device),
                             torch.as_tensor(D, device=device),
                             torch.as_tensor(tags, device=device), prec)
            out.append(guides(logits).cpu().numpy())
    return np.concatenate(out)
