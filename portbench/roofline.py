"""The yardstick's arithmetic: the chip's peaks, the operations and bytes of
each kernel from its shapes or its work counters, and the model's FLOPs.

The kernel counts are those of the program's smoke script (its `bound`,
`gat_partials_work` and `gls_work`), copied here so that a change to the
program cannot move them.  A kernel's share of its roofline is the least
time the chip could take for the launches (the larger of operations over the
f32 peak and bytes over the memory rate, summed over launches) over the time
the launches took on the device.
"""

from __future__ import annotations

import json
import math
import pathlib

PEAKS_FILE = pathlib.Path(__file__).resolve().parent / "peaks.json"


def peaks(device_name: str) -> dict:
    """The published peaks of the card whose name contains a key of peaks.json."""
    table = json.loads(PEAKS_FILE.read_text())
    for key, row in table.items():
        if key in device_name:
            return row
    raise KeyError(f"no peaks for {device_name!r} in {PEAKS_FILE.name}")


def bound_s(ops: float, nbytes: float, pk: dict) -> float:
    """Seconds: the larger of the operations over the f32 peak and the bytes
    over the memory rate."""
    return max(ops / pk["f32_flops"], nbytes / pk["hbm_bytes_per_s"])


def gat_partials_work(B: int, n: int, H: int, F: int, h_bytes: int = 4):
    """(operations, bytes) of one launch of the group partials (K2, K3's route
    and K5 compute the same m, z, num) at this shape, the operations counted
    in the cheapest known form, the sorted prefix sums.  Per (batch, city,
    head) group of K = n-1 edges: a sort of el (K log2 K compares); per source
    two exps, the two payloads (2F products) and their prefix and suffix sums
    (2F+2 adds); per target a binary search (log2 K), m, B, D (10 operations),
    z and num from the sums less the self term (4F+7).  el, er and h
    (h_bytes an element) read once; m, z, num written once."""
    K, E = n - 1, n * (n - 1) // 2
    lg = math.ceil(math.log2(K))
    ops = B * n * H * K * (2 * lg + 8 * F + 21)
    nbytes = (4 * (2 * B * E * H + n * K + 2 * B * n * K * H + B * n * K * H * F)
              + h_bytes * B * E * H * F)
    return ops, nbytes


def gls_work(work, n: int, G: int, n_iters: int):
    """(operations, bytes) of one whole-GLS launch for its data: `work` is
    its (B, 2) counters (local-search rounds, perturbation rounds).  Each
    local-search round scans every 2-opt and relocate candidate; each
    perturbation round computes the utility, two one-to-all scans under
    D + k P per endpoint and the re-costs.  D and the G guides read once,
    tours, costs and traces written once."""
    ls = sum(float(w[0]) for w in work)
    pert = sum(float(w[1]) for w in work)
    B = len(work)
    per_ls = 3 * (n - 2) * (n - 3) / 2 + 5 * (n - 2) ** 2
    per_pert = 46 * n
    ops = ls * per_ls + pert * per_pert
    nbytes = 4 * (B * n * n * (1 + G) + 2 * B * (n + 1) + B * (4 + 2 * n_iters))
    return ops, nbytes


def model_flops_per_instance(n: int, embed: int, hidden: int, depth: int, in_dim: int = 1,
                             out_dim: int = 1) -> float:
    """The forward's matrix products that every GATConv route must do, per
    instance of n cities: per edge node and layer the embed x embed
    projection, the el and er dots (2 x embed products and adds), and the
    embed -> hidden -> embed FFN; plus the embedding and the output layer.
    The attention's aggregation over the 2(n-2) neighbours is left out: the
    sorted-prefix routes do not perform it, so counting it would overstate
    what those routes need."""
    E = n * (n - 1) // 2
    per_layer = 2 * embed * embed + 2 * 2 * embed + 2 * embed * hidden * 2
    return float(E * (depth * per_layer + 2 * in_dim * embed + 2 * embed * out_dim))


def regret_gat_flops(cfg: dict) -> float:
    """model_flops_per_instance of a configuration of the edge-regret GAT: its
    "model" widths and depth at its instances' n."""
    m = cfg["model"]
    depth = m["n_heads"] if m.get("depth_from_heads", True) else m["n_layers"]
    return model_flops_per_instance(cfg["instances"]["n"], m["embed_dim"], m["hidden_dim"],
                                    depth, m["in_dim"])
