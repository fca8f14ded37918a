"""The residual gated GCN's arithmetic for the yardstick (portbench/runners/
gated_gcn.py, readers/span_device.py): its counted FLOPs an instance and the
least operations and bytes a forward must move, from the configuration's
widths alone, so that a change to the program cannot move them."""

from __future__ import annotations


def _flops(n: int, m: dict) -> float:
    """The forward's matrix products for one instance of n cities: per layer
    the edge update U_e e on all n^2 edges and the three node products
    (U_n x, V_n x, V_e x), then the edge MLP (mlp_layers - 1 H x H layers and
    H -> voc_edges_out).  The embeddings (2 -> H and 1 -> H/2) are left out:
    under a thousandth of the count."""
    H, L = m["hidden_dim"], m["num_layers"]
    per_layer = 2 * H * H * n * n + 3 * 2 * H * H * n
    mlp = (m["mlp_layers"] - 1) * 2 * H * H * n * n + 2 * H * m["voc_edges_out"] * n * n
    return float(L * per_layer + mlp)


def gated_gcn_flops(cfg: dict) -> float:
    """The mfu reader's count: `_flops` at the configuration's n (59.23
    GFLOP at the published TSP100 widths)."""
    return _flops(cfg["instances"]["n"], cfg["model"])


def weights(m: dict) -> int:
    """The model's parameters."""
    H, L, out = m["hidden_dim"], m["num_layers"], m["voc_edges_out"]
    embed = H * m["node_dim"] + H // 2 + m["voc_edges_in"] * H // 2
    layer = 4 * (H * H + H) + 4 * H
    mlp = (m["mlp_layers"] - 1) * (H * H + H) + out * H + out
    return embed + L * layer + mlp


def gated_gcn_work(B: int, n: int, m: dict):
    """(operations, bytes) of one forward of a batch of B instances and the
    guide made from it: the products of `_flops`, and the least bytes the
    forward must move in float32: the inputs read once (coordinates,
    distances, int64 tags), each layer's edge stream read and written once
    and its node tensor read and written once, the final edges read once by
    the MLP, the logits and the guide written once, the weights read once a
    forward."""
    H, L = m["hidden_dim"], m["num_layers"]
    edges, nodes = B * n * n * H, B * n * H
    nbytes = (4 * B * n * 2 + 4 * B * n * n + 8 * B * n * n
              + 4 * L * (2 * edges + 2 * nodes)
              + 4 * edges + 4 * B * n * n * m["voc_edges_out"] + 4 * B * n * n
              + 4 * weights(m))
    return B * _flops(n, m), float(nbytes)
