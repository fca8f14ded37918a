"""DIFUSCO's arithmetic for the yardstick (portbench/runners/difusco.py,
readers/span_work.py): its counted FLOPs an instance and the least
operations and bytes a batch's prediction must move, from the
configuration's widths alone, so that a change to the program cannot move
them."""

from __future__ import annotations


def _forward_flops(n: int, m: dict) -> float:
    """One forward's matrix products for one instance of n cities and E = n K
    edges: per layer the two edge products (C e and per_layer_out's Linear,
    2 E H^2 each) and the four node products (U, V, A, B, 2 n H^2 each:
    V and A act on the n cities' rows, which the edges gather); node_embed
    (2 n H^2); the 1x1 output map (2 E H 2).  edge_embed maps the two rows
    that a state in {0, 1} gives its sine embedding (4 H^2), and the time
    embeddings one row each; both under a thousandth of the count, left
    out."""
    H, L = m["hidden_dim"], m["num_layers"]
    E = n * min(m["sparse_factor"], n)
    per_layer = 2 * 2 * E * H * H + 4 * 2 * n * H * H
    return float(L * per_layer + 2 * n * H * H + 2 * E * H * 2)


def difusco_flops(cfg: dict) -> float:
    """The mfu reader's count: `inference_steps` forwards at the
    configuration's n (4.094 TFLOP at the published TSP-500 setting)."""
    m = cfg["model"]
    return m["inference_steps"] * _forward_flops(cfg["instances"]["n"], m)


def weights(m: dict) -> int:
    """The model's parameters."""
    H, L = m["hidden_dim"], m["num_layers"]
    lin = H * H + H
    embed = 2 * lin + (H * H // 2 + H // 2) + (H * H // 4 + H // 2)
    layer = 5 * lin + 4 * H + (H * H // 2 + H) + 2 * H + lin
    return embed + L * layer + 2 * H + 2 * H + 2


def difusco_work(B: int, n: int, m: dict):
    """(operations, bytes) of one batch's prediction (`gnngls.predict`): B
    instances through `inference_steps` forwards, each with the products of
    `_forward_flops`, and the least bytes they must move in float32: the
    distances read once to form the edge list, then for each forward its
    edge list (int64), state (one byte an edge) and weights read once, each
    layer's edge stream read and written once and its node tensor read and
    written once, and p^ written once; then the guide written once."""
    H, L = m["hidden_dim"], m["num_layers"]
    E = n * min(m["sparse_factor"], n)
    per_forward = (8 * B * E + B * E + 4 * weights(m)
                   + 4 * L * (2 * B * E * H + 2 * B * n * H) + 4 * B * E)
    nbytes = 4 * B * n * n + m["inference_steps"] * per_forward + 4 * B * n * n
    return B * m["inference_steps"] * _forward_flops(n, m), float(nbytes)
