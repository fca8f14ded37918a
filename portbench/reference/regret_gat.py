"""The plain reference of the edge-regret GAT (Hudson et al., ICLR 2022), in
plain PyTorch and NumPy.  It imports nothing of the program: it reads the
checkpoint's arrays itself, recomputes distances, edge features and their
scaling from the coordinates, and runs the model op by op in float32.

Model (the reference's `EdgePropertyPredictionModel`, DGL 0.6.1 GATConv):

    x (E, 1) edge weights, min-max scaled
    h = x W_embed + b
    depth x [ h = BN(h + GAT(h));  h = BN(h + W2 relu(W1 h + b1) + b2) ]
    y = h W_out + b                 (scaled regret; inverse-scaled, clamped at 0)

GAT over the line graph of K_n: the edge e = (u, v) attends over every other
edge that shares u or v (2(n-2) of them, never itself).  With the projection
p = h W_fc split into H heads of F, el = <p, a_l> per source, er = <p, a_r>
per target, the score of source s at target e is leaky(el_s + er_e, 0.2),
softmax over the sources, out_e = sum_s alpha_se p_s.  It is computed city by
city: the n-1 edges at a city u are one group, every pair of them scores
once, and the two groups of each edge are joined exactly (a softmax over a
union is the two groups' sums rescaled to one maximum).  BatchNorm uses the
running statistics (eval mode), or, in `forward(..., train=True)`, the
biased batch statistics as torch's BatchNorm1d does.

Precision: "f32" holds float32 products without TF32 on the card; "tf32"
computes the products with TF32 operands, the next precision below (on the
card through cuBLAS's TF32 path; on the CPU, which has none, by rounding each
product's operands to TF32 and multiplying in float32, which is what the
tensor cores compute).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch

LEAKY = 0.2
BN_EPS = 1e-5
BN_MOMENTUM = 0.1
PRECISIONS = ("f32", "tf32")


def load_weights(npz_path, device) -> Dict[str, torch.Tensor]:
    """The checkpoint's model arrays by their flat keys (`params::...`,
    `bn_state::...`) as float32 tensors on `device`."""
    with np.load(npz_path, allow_pickle=False) as z:
        return {k: torch.tensor(np.asarray(z[k], np.float32), device=device)
                for k in z.files if k.startswith(("params::", "bn_state::"))}


def load_adam(npz_path, device) -> dict:
    """The checkpoint's Adam state: {"count", "lr", "b1", "b2", "eps",
    "mu": {path: tensor}, "nu": {path: tensor}}; paths as in `params::<path>`."""
    with np.load(npz_path, allow_pickle=False) as z:
        pre = "opt_state::inner_state/0/"
        out = {"count": int(z[pre + "count"]), "mu": {}, "nu": {}}
        for name in ("b1", "b2", "eps", "learning_rate"):
            out[name] = float(z[f"opt_state::hyperparams/{name}"])
        for k in z.files:
            for m in ("mu", "nu"):
                if k.startswith(f"{pre}{m}/"):
                    out[m][k[len(pre) + len(m) + 1:]] = torch.tensor(
                        np.asarray(z[k], np.float32), device=device)
    return out


def distances(coords: np.ndarray) -> np.ndarray:
    """(..., n, 2) float32 coordinates -> (..., n, n) float32 Euclidean
    distances, summed and rooted in float32."""
    d = coords[..., :, None, :] - coords[..., None, :, :]
    return np.sqrt((d * d).sum(-1)).astype(np.float32)


def edge_pairs(n: int):
    """The edges (u, v), u < v, in lexicographic order: two (E,) arrays."""
    return np.triu_indices(n, k=1)


def scaled_features(coords: np.ndarray, scalers: dict) -> np.ndarray:
    """(B, n, 2) coordinates -> (B, E, 1) min-max scaled edge weights, float32.
    `scalers` is scalers.json's {"features": {"data_min", "data_max"}, ...}."""
    us, vs = edge_pairs(coords.shape[-2])
    w = distances(coords)[..., us, vs][..., None]
    scale, shift = minmax(scalers["features"])
    return w * scale.astype(np.float32) + shift.astype(np.float32)


def minmax(entry: dict):
    """(scale, shift) of x -> x * scale + shift, float64: sklearn's
    MinMaxScaler with feature range (0, 1), a zero range taken as 1."""
    lo = np.asarray(entry["data_min"], np.float64)
    hi = np.asarray(entry["data_max"], np.float64)
    r = hi - lo
    scale = 1.0 / np.where(r == 0.0, 1.0, r)
    return scale, -lo * scale


def unscale_regret(y: np.ndarray, scalers: dict) -> np.ndarray:
    """Scaled predictions (B, E) -> regret, clamped at 0, float32."""
    scale, shift = minmax(scalers["regret"])
    y = (y - shift.astype(np.float32)) / scale.astype(np.float32)
    return np.maximum(y, 0.0)


def scale_regret(r: np.ndarray, scalers: dict) -> np.ndarray:
    """Regret labels (B, E) -> scaled targets, float32."""
    scale, shift = minmax(scalers["regret"])
    return (r * scale.astype(np.float32) + shift.astype(np.float32)).astype(np.float32)


@contextlib.contextmanager
def precision(name: str, device):
    """The products' precision for the block (see the module's docstring)."""
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


class _TF32MatMul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, and the backward's products
    likewise: the CPU's stand-in for the card's TF32 products."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(to_tf32(a), to_tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = (to_tf32(t) for t in ctx.saved_tensors)
        g = to_tf32(g)
        ga = torch.matmul(g, b.transpose(-1, -2))
        if b.dim() == 2:  # a weight under a batch of rows
            gb = torch.matmul(a.reshape(-1, a.shape[-1]).T, g.reshape(-1, g.shape[-1]))
        else:
            gb = torch.matmul(a.transpose(-1, -2), g)
        return ga, gb


class Model:
    """The model on given arrays: `forward` for inference, and in train mode
    (`forward(..., train=True)`) differentiable in `self.params`."""

    def __init__(self, weights: Dict[str, torch.Tensor], n_heads: int, depth: int,
                 prec: str = "f32"):
        self.params = {k: v for k, v in weights.items() if k.startswith("params::")}
        self.stats = {k: v.clone() for k, v in weights.items() if k.startswith("bn_state::")}
        self.H, self.depth, self.prec = n_heads, depth, prec

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.prec == "tf32" and a.device.type == "cpu":
            return _TF32MatMul.apply(a, b)
        return torch.matmul(a, b)

    def p(self, path: str) -> torch.Tensor:
        return self.params["params::" + path]

    def linear(self, x, path):
        return self.mm(x, self.p(path + "/w")) + self.p(path + "/b")

    def bn(self, x, path, train):
        if train:
            axes = tuple(range(x.dim() - 1))
            mean, var = x.mean(dim=axes), x.var(dim=axes, correction=0)
            count = x.numel() // x.shape[-1]
            with torch.no_grad():
                m, v = self.stats[f"bn_state::{path}/mean"], self.stats[f"bn_state::{path}/var"]
                m.copy_((1 - BN_MOMENTUM) * m + BN_MOMENTUM * mean)
                v.copy_((1 - BN_MOMENTUM) * v + BN_MOMENTUM * var * (count / (count - 1)))
        else:
            mean = self.stats[f"bn_state::{path}/mean"]
            var = self.stats[f"bn_state::{path}/var"]
        scale, bias = self.p(path + "/scale"), self.p(path + "/bias")
        return (x - mean) / torch.sqrt(var + BN_EPS) * scale + bias

    def gat(self, x, path, n, city_chunk):
        """x (B, E, C) -> (B, E, H*F), the GATConv of the module's docstring."""
        B, E, _ = x.shape
        H = self.H
        proj = self.mm(x, self.p(path + "/fc_w"))
        F = proj.shape[-1] // H
        proj = proj.reshape(B, E, H, F)
        el = (proj * self.p(path + "/attn_l")).sum(-1)  # (B, E, H)
        er = (proj * self.p(path + "/attn_r")).sum(-1)
        eid = torch.as_tensor(_edge_ids(n), device=x.device)  # (n, n), -1 on the diagonal
        others = torch.as_tensor(_others(n), device=x.device)  # (n, n-1) the other ends
        ce = eid[torch.arange(n, device=x.device)[:, None], others]  # (n, n-1) group edges
        eye = torch.eye(n - 1, dtype=torch.bool, device=x.device)
        m_all = torch.empty((B, n, n - 1, H), device=x.device)
        z_all, num_all = torch.empty_like(m_all), torch.empty((B, n, n - 1, H, F), device=x.device)
        for c0 in range(0, n, city_chunk):
            g = ce[c0:c0 + city_chunk]  # (c, n-1)
            s = el[:, g][:, :, None, :, :] + er[:, g][:, :, :, None, :]  # (B, c, tgt, src, H)
            s = torch.where(s > 0, s, LEAKY * s)
            s = s.masked_fill(eye[:, :, None], float("-inf"))
            m = s.amax(dim=3)
            w = torch.exp(s - m[:, :, :, None, :])
            m_all[:, c0:c0 + city_chunk] = m
            z_all[:, c0:c0 + city_chunk] = w.sum(dim=3)
            # sum over sources of w * p_src, as one product per (batch, city, head)
            wp = w.permute(0, 1, 4, 2, 3)  # (B, c, H, tgt, src)
            pg = proj[:, g].permute(0, 1, 3, 2, 4)  # (B, c, H, src, F)
            num_all[:, c0:c0 + city_chunk] = self.mm(wp, pg).permute(0, 1, 3, 2, 4)
        us, vs = (torch.as_tensor(a, device=x.device) for a in edge_pairs(n))
        slot_u, slot_v = vs - 1, us  # edge (u, v) in u's group and in v's group
        mu, mv = m_all[:, us, slot_u], m_all[:, vs, slot_v]
        top = torch.maximum(mu, mv)
        au, av = torch.exp(mu - top), torch.exp(mv - top)
        z = z_all[:, us, slot_u] * au + z_all[:, vs, slot_v] * av
        num = num_all[:, us, slot_u] * au[..., None] + num_all[:, vs, slot_v] * av[..., None]
        return (num / z[..., None]).reshape(B, E, H * F)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                city_chunk: Optional[int] = None) -> torch.Tensor:
        """x (B, E, in_dim) scaled features -> (B, E) scaled predictions."""
        B, E, _ = x.shape
        n = int(round((1 + (1 + 8 * E) ** 0.5) / 2))
        if city_chunk is None:  # about 2**28 score elements a chunk
            city_chunk = max(1, min(n, 2 ** 28 // max(1, B * (n - 1) ** 2 * self.H)))
        h = self.linear(x, "embed")
        for i in range(self.depth):
            lp = f"layers/{i}"
            h = self.bn(h + self.gat(h, f"{lp}/gat", n, city_chunk), f"{lp}/bn1", train)
            ffn = self.linear(torch.relu(self.linear(h, f"{lp}/ffn1")), f"{lp}/ffn2")
            h = self.bn(h + ffn, f"{lp}/bn2", train)
        return self.linear(h, "decision")[..., 0]


def _edge_ids(n: int) -> np.ndarray:
    us, vs = edge_pairs(n)
    eid = np.full((n, n), -1, np.int64)
    eid[us, vs] = eid[vs, us] = np.arange(us.size)
    return eid


def _others(n: int) -> np.ndarray:
    a = np.arange(n)
    return np.stack([np.delete(a, u) for u in range(n)])


@torch.no_grad()
def predict(weights, coords: np.ndarray, scalers: dict, *, n_heads: int, depth: int,
            prec: str, device, batch: int = 1) -> np.ndarray:
    """Regret predictions (B, E), float32, for (B, n, 2) coordinates, `batch`
    instances at a time."""
    model = Model(weights, n_heads, depth, prec)
    out = []
    with precision(prec, device):
        for s in range(0, len(coords), batch):
            x = torch.as_tensor(scaled_features(coords[s:s + batch], scalers), device=device)
            out.append(model.forward(x).cpu().numpy())
    return unscale_regret(np.concatenate(out), scalers)
