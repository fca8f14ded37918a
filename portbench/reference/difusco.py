"""The plain reference of DIFUSCO's denoising GNN for the TSP (Sun & Yang,
arXiv:2302.08224; github.com/Edward-Sun/DIFUSCO: `difusco/models/
gnn_encoder.py`'s sparse forward, `difusco/utils/diffusion_schedulers.py`,
`pl_tsp_model.categorical_denoise_step` and `pl_meta_model.
categorical_posterior`), for the benchmark: plain torch and NumPy, one
instance at a time, op by op as the published code computes them, on the
edge list it builds itself ((E, H) edges, `edge_index` rows (i, j)).  It
imports nothing of the program, reads no checkpoint, and draws its weights
from a seed.

The published encoder calls each layer with mode="direct": the layer adds
no residual, the encoder adds h and e once.  Departures from the published
code:
  * weights from `make_weights`, the last Linear of `per_layer_out`
    included, which the published code initialises to zero;
  * equal distances in the k-NN edge list go to the lower city id (a
    stable sort; the published KD-tree leaves the order undefined);
  * the draws: `torch.rand` on a seeded generator (below), u < pi for the
    published `torch.bernoulli(pi)` and u < 1/2 for `randn > 0`; the first
    factor of the posterior's product Q[1, x] is read from Q, where the
    published code multiplies a one-hot row by Q^T; Q = I at s = 0, the
    branch of the published first release (a later commit drops it);
  * one trajectory an instance (the published greedy setting), GroupNorm
    over the one instance's edges, and the guide 1 - (h_ij + h_ji) / 2
    (0 on the diagonal) in place of greedy decoding and 2-opt.

The draws, as the program makes them: one generator on the device, seeded
with the call's seed; batch after batch of `batch` instances, one (B E,)
uniform tensor for x_T and then one for each step with s > 0, in that
order; instance b of a batch reads elements [b E, (b + 1) E).

Precision: "f32" holds float32 products with TF32 off
(`torch.backends.cuda.matmul.allow_tf32` and `torch.backends.cudnn.
allow_tf32` False for the block); "tf32" computes them with TF32 operands,
the next precision below (on the card through cuBLAS's and cuDNN's TF32
paths; on the CPU by rounding each product's operands to TF32, `to_tf32`).

The port's CPU tests (tests/test_torch_difusco.py) hold the program to it
in "f32", at every step of the program's own trajectory (`predict`'s
`states`).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

PRECISIONS = ("f32", "tf32")
EPS = 1e-5  # LayerNorm's and GroupNorm's


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """Every parameter's shape under the published state-dict names, in the
    order the weights are drawn."""
    H, L = cfg["hidden_dim"], cfg["num_layers"]
    shapes = {}

    def linear(name, fan_in, fan_out):
        shapes[f"{name}.weight"] = (fan_out, fan_in)
        shapes[f"{name}.bias"] = (fan_out,)

    def norm(name):
        shapes[f"{name}.weight"] = (H,)
        shapes[f"{name}.bias"] = (H,)

    linear("node_embed", H, H)
    linear("edge_embed", H, H)
    linear("time_embed.0", H, H // 2)
    linear("time_embed.2", H // 2, H // 2)
    norm("out.0")
    shapes["out.2.weight"] = (2, H, 1, 1)
    shapes["out.2.bias"] = (2,)
    for l in range(L):
        for lin in "UVABC":
            linear(f"layers.{l}.{lin}", H, H)
        norm(f"layers.{l}.norm_h")
        norm(f"layers.{l}.norm_e")
    for l in range(L):
        linear(f"time_embed_layers.{l}.1", H // 2, H)
    for l in range(L):
        norm(f"per_layer_out.{l}.0")
        linear(f"per_layer_out.{l}.2", H, H)
    return shapes


def make_weights(cfg: dict, seed: int) -> Dict[str, np.ndarray]:
    """Float32 weights drawn from NumPy's generator seeded with `seed`, in
    `param_shapes`' order: a Linear's or the 1x1 map's weight and bias
    uniform in +-1/sqrt(its fan-in), each norm's scale 1 and shift 0 (no
    draw)."""
    rng = np.random.default_rng(int(seed))
    shapes, out = param_shapes(cfg), {}
    for name, shape in shapes.items():
        base = name.rsplit(".", 1)[0]
        if base.endswith(("norm_h", "norm_e", "out.0")) or (
                base.startswith("per_layer_out") and base.endswith(".0")):
            out[name] = (np.ones if name.endswith("weight") else np.zeros)(shape, np.float32)
        else:
            fan_in = int(np.prod(shapes[f"{base}.weight"][1:]))
            bound = 1.0 / np.sqrt(fan_in)
            out[name] = rng.uniform(-bound, bound, shape).astype(np.float32)
    return out


def q_bar(T: int) -> np.ndarray:
    """(T + 1, 2, 2) float64: Q^_0 = I, Q^_t = Q^_{t-1} Q_t, Q_t = (1 - b_t) I
    + b_t / 2, b = linspace(1e-4, 0.02, T) (CategoricalDiffusion, linear)."""
    beta = np.linspace(1e-4, 2e-2, T).reshape((-1, 1, 1))
    Qs = (1 - beta) * np.eye(2).reshape((1, 2, 2)) + (beta / 2) * np.ones((1, 2, 2))
    out = [np.eye(2)]
    for Q in Qs:
        out.append(out[-1] @ Q)
    return np.stack(out, axis=0)


def schedule(T: int, steps: int) -> List[Tuple[int, int]]:
    """The published cosine InferenceSchedule: (t1, t2) of each step."""
    out = []
    for i in range(steps):
        t1 = T - int(np.sin((float(i) / steps) * np.pi / 2) * T)
        t2 = T - int(np.sin((float(i + 1) / steps) * np.pi / 2) * T)
        out.append((int(np.clip(t1, 1, T)), int(np.clip(t2, 0, T - 1))))
    return out


def distances(coords: np.ndarray) -> np.ndarray:
    """(..., n, 2) float32 coordinates -> (..., n, n) float32 distances."""
    d = coords[..., :, None, :] - coords[..., None, :, :]
    return np.sqrt((d * d).sum(-1)).astype(np.float32)


def edges(coords: np.ndarray, k: int) -> np.ndarray:
    """(n, 2) coordinates -> (n, min(k, n)) int64: each city's nearest
    cities, itself included, nearest first, ties to the lower id."""
    D = distances(np.asarray(coords, np.float32))
    return np.argsort(D, axis=-1, kind="stable")[:, :min(k, len(D))]


@contextlib.contextmanager
def precision(name: str):
    """The products' precision for the block (module docstring)."""
    if name not in PRECISIONS:
        raise ValueError(f"precision {name!r} not in {PRECISIONS}")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = name == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest even), held in float32."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def _cpu_tf32(prec: str, t: torch.Tensor) -> bool:
    return prec == "tf32" and t.device.type == "cpu"


def _linear(t, w, name, prec):
    weight, bias = w[f"{name}.weight"], w[f"{name}.bias"]
    if _cpu_tf32(prec, t):
        return torch.matmul(to_tf32(t), to_tf32(weight).T) + bias
    return F.linear(t, weight, bias)


def _layer_norm(t, w, name):
    return F.layer_norm(t, (t.shape[-1],), w[f"{name}.weight"], w[f"{name}.bias"], EPS)


def position_embedding(x: torch.Tensor, num_pos_feats: int, temperature=10000,
                       scale=2 * np.pi) -> torch.Tensor:
    """PositionEmbeddingSine(num_pos_feats, normalize=True) of (1, n, 2)."""
    y_embed = x[:, :, 0] * scale
    x_embed = x[:, :, 1] * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=x.device)
    dim_t = temperature ** (2.0 * (torch.div(dim_t, 2, rounding_mode="trunc")) / num_pos_feats)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = torch.stack((pos_x[:, :, 0::2].sin(), pos_x[:, :, 1::2].cos()), dim=3).flatten(2)
    pos_y = torch.stack((pos_y[:, :, 0::2].sin(), pos_y[:, :, 1::2].cos()), dim=3).flatten(2)
    return torch.cat((pos_y, pos_x), dim=2).contiguous()


def scalar_embedding(x: torch.Tensor, num_pos_feats: int, temperature=10000) -> torch.Tensor:
    """ScalarEmbeddingSine(num_pos_feats, normalize=False) of (1, 1, E)."""
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=x.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="trunc") / num_pos_feats)
    pos_x = x[:, :, :, None] / dim_t
    return torch.stack((pos_x[:, :, :, 0::2].sin(), pos_x[:, :, :, 1::2].cos()),
                       dim=4).flatten(3)


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period=10000) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-float(np.log(max_period)) * torch.arange(start=0, end=half, dtype=torch.float32)
                      / half).to(device=timesteps.device)
    args = timesteps[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def forward(weights: Dict[str, torch.Tensor], cfg: dict, coords: np.ndarray, x: torch.Tensor,
            t: int, prec: str = "f32", nbr: Optional[np.ndarray] = None) -> torch.Tensor:
    """One instance: coordinates (n, 2), the state x (E,) in the edge list's
    order (0/1), the time step t -> (E, 2) class probabilities.  The edge
    list is `edges(coords)` unless given."""
    w, H, dev = weights, cfg["hidden_dim"], x.device
    nbr = edges(coords, cfg["sparse_factor"]) if nbr is None else nbr
    n, K = nbr.shape
    src = torch.arange(n, device=dev).reshape((-1, 1)).repeat(1, K).reshape(-1)
    dst = torch.as_tensor(nbr.reshape(-1), device=dev)
    points = torch.as_tensor(np.asarray(coords, np.float32), device=dev)
    with precision(prec):
        h = _linear(position_embedding(points.unsqueeze(0), H // 2).squeeze(0), w,
                    "node_embed", prec)
        e = _linear(scalar_embedding(x.float().expand(1, 1, -1), H).squeeze(), w,
                    "edge_embed", prec)
        tau = _linear(timestep_embedding(torch.tensor([float(t)], device=dev), H), w,
                      "time_embed.0", prec)
        tau = _linear(F.relu(tau), w, "time_embed.2", prec)
        for l in range(cfg["num_layers"]):
            p = f"layers.{l}."
            h_in, e_in = h, e
            Uh = _linear(h, w, p + "U", prec)
            Vh = _linear(h[dst], w, p + "V", prec)
            Ah = _linear(h, w, p + "A", prec)
            Bh = _linear(h, w, p + "B", prec)
            Ce = _linear(e, w, p + "C", prec)
            e = Ah[dst] + Bh[src] + Ce
            gates = torch.sigmoid(e)
            h = Uh + torch.zeros_like(Uh).index_add_(0, src, gates * Vh)
            h = F.relu(_layer_norm(h, w, p + "norm_h"))
            e = F.relu(_layer_norm(e, w, p + "norm_e"))
            e = e + _linear(F.relu(tau), w, f"time_embed_layers.{l}.1", prec)
            h = h_in + h
            q = f"per_layer_out.{l}."
            e = e_in + _linear(F.silu(_layer_norm(e, w, q + "0")), w, q + "2", prec)
        e = e.reshape((1, n, -1, e.shape[-1])).permute((0, 3, 1, 2))
        e = F.relu(F.group_norm(e, 32, w["out.0.weight"], w["out.0.bias"], EPS))
        conv_w = w["out.2.weight"]
        if _cpu_tf32(prec, e):
            e, conv_w = to_tf32(e), to_tf32(conv_w)
        logits = F.conv2d(e, conv_w, w["out.2.bias"])
    return logits.reshape(-1, n * K).permute((1, 0)).softmax(dim=-1)


def posterior(probs: torch.Tensor, x: torch.Tensor, t: int, s: int,
              qbar: np.ndarray) -> torch.Tensor:
    """pi (E,): the probability that x_s is 1, from the class probabilities
    (E, 2) and the state x_t (E,), as `categorical_posterior` computes it
    in float32."""
    dev = probs.device
    if s > 0:
        Q_t = torch.from_numpy(np.linalg.inv(qbar[s]) @ qbar[t]).float().to(dev)
    else:
        Q_t = torch.eye(2).float().to(dev)
    source = torch.from_numpy(qbar[t]).float().to(dev)
    target = torch.from_numpy(qbar[s]).float().to(dev)
    xt = F.one_hot(x.long(), num_classes=2).float()
    part_1 = Q_t[:, x.long()].T  # row k: Q[:, x_k], the published xt @ Q^T
    part_3 = (source[0] * xt).sum(dim=-1, keepdim=True)
    pi = ((part_1 * target[0]) / part_3)[..., 1] * probs[..., 0]
    part_3_new = (source[1] * xt).sum(dim=-1, keepdim=True)
    return pi + ((part_1 * target[1]) / part_3_new)[..., 1] * probs[..., 1]


def guide(heat: torch.Tensor, nbr: np.ndarray) -> np.ndarray:
    """(E,) heatmap on the edge list -> (n, n) float32 1 - (h_ij + h_ji) / 2,
    h 0 off the edge list, 0 on the diagonal."""
    n, K = nbr.shape
    h = np.zeros((n, n), np.float32)
    h[np.repeat(np.arange(n), K), nbr.reshape(-1)] = heat.cpu().numpy()
    g = 1.0 - (h + h.T) / 2
    g[np.arange(n), np.arange(n)] = 0.0
    return g


def _draws(gen, sizes: Iterable[int], steps, device) -> Iterable[List[torch.Tensor]]:
    """For each batch size B in turn, its draws: one (B E,) tensor for x_T,
    then one for each step with s > 0 (`sizes` in units of B E)."""
    for size in sizes:
        yield [torch.rand(size, generator=gen, device=device)
               for _ in range(1 + sum(s > 0 for _, s in steps))]


@torch.no_grad()
def predict(weights: Dict[str, np.ndarray], cfg: dict, coords: np.ndarray, *, seed: int,
            batch: int, lanes=None, states=None, prec: str = "f32", device="cpu") -> dict:
    """The denoising of instances `lanes` (default: all) of coordinates (N, n,
    2), drawn as the program draws (module docstring) for `batch`
    instances a call of the model, with seed `seed`.

    `states`, where given, is the trajectory to follow: for each lane, the
    (S, E) states x_t at the S steps, used in place of its own draws.

    Returns numpy arrays: "guides" (L, n, n), and for each lane and step
    "p" (L, S, E) the probability of class 1, "pi" (L, S, E) the
    posterior, "u" (L, S, E) the draws (u[:, 0] for x_T, u[:, i] the one
    after step i - 1)."""
    N, n = coords.shape[:2]
    K = min(cfg["sparse_factor"], n)
    E = n * K
    T = cfg["diffusion_steps"]
    steps, qbar = schedule(T, cfg["inference_steps"]), q_bar(T)
    lanes = list(range(N)) if lanes is None else [int(l) for l in lanes]
    w = {k: torch.as_tensor(v, device=device) for k, v in weights.items()}
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [min(batch, N - b0) * E for b0 in range(0, N, batch)]
    out = {"guides": {}, "p": {}, "pi": {}, "u": {}}
    for b0, draws in zip(range(0, N, batch), _draws(gen, sizes, steps, device)):
        for lane in (l for l in lanes if b0 <= l < b0 + batch):
            j = lane - b0
            u = [d[j * E:(j + 1) * E] for d in draws]
            nbr = edges(coords[lane], cfg["sparse_factor"])
            x, drawn = u[0] < 0.5, 1
            ps, pis = [], []
            for i, (t, s) in enumerate(steps):
                if states is not None:
                    x = torch.as_tensor(states[lanes.index(lane)][i],
                                        device=device).bool().reshape(-1)
                probs = forward(w, cfg, coords[lane], x, t, prec, nbr)
                pi = posterior(probs, x, t, s, qbar)
                ps.append(probs[:, 1])
                pis.append(pi)
                if s > 0:
                    x, drawn = u[drawn] < pi.clamp(0, 1), drawn + 1
            out["guides"][lane] = guide(pis[-1].clamp(min=0), nbr)
            out["p"][lane] = torch.stack(ps).cpu().numpy()
            out["pi"][lane] = torch.stack(pis).cpu().numpy()
            out["u"][lane] = torch.stack(u).cpu().numpy()
    return {k: np.stack([v[l] for l in lanes]) for k, v in out.items()}
