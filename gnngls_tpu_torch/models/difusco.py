"""DIFUSCO's denoising GNN for the TSP (Sun & Yang, "DIFUSCO: Graph-based
Diffusion Solvers for Combinatorial Optimization", NeurIPS 2023,
arXiv:2302.08224; github.com/Edward-Sun/DIFUSCO: `difusco/models/
gnn_encoder.py`, `difusco/utils/diffusion_schedulers.py`,
`difusco/pl_tsp_model.py`), its sparse TSP-500 setting, as an edge scorer
for the search: categorical diffusion over the edges of each city's
`sparse_factor` nearest cities, denoised in `inference_steps` steps, whose
last posterior is the heatmap.

The graph (`edge_list`): for city i, its K = min(sparse_factor, n) nearest
cities by the distance matrix, i itself included (as the published KD-tree
query returns it), nearest first, equal distances to the lower city id.  So
there are E = n K directed edges k = (i -> j), laid out (B, n, K) with i
the row, and a state x in {0, 1}^E.

The network (`Difusco.forward`, H = hidden_dim, one time step t):

    h_i = node_embed(sine2(c_i))        DETR's PositionEmbeddingSine: H/2
                                        features a coordinate, scale 2 pi,
                                        temperature 1e4, sin on even features
                                        and cos on odd, coordinate 0 first
    e_k = edge_embed(sine1(x_k))        ScalarEmbeddingSine, H features
    tau = time_embed(temb(t))           the timestep embedding (cos half
                                        first, max period 1e4), then
                                        Linear(H, H/2), ReLU, Linear(H/2, H/2)
    L x [ e^_k = C e_k + A h_j + B h_i ;  g_k = sigmoid(e^_k)
          h^_i = U h_i + sum_{k = (i -> j)} g_k * V h_j      (sum aggregation)
          h'   = ReLU(LN(h^)) ;  e' = ReLU(LN(e^))           (the layer, "direct")
          h <- h + h'
          e <- e + per_layer_out(e' + time_embed_layers(ReLU(tau))) ]
    p^_k = softmax(out(e))[1]           out: GroupNorm(32, H), ReLU, 1x1 map H -> 2

The published encoder calls its layers with mode="direct", so a layer adds
no residual of its own: h and e each enter their update once.
`per_layer_out` is LayerNorm, SiLU, Linear(H, H).  x in {0, 1} gives sine1
two values, so `edge_embed` maps those two rows and each edge takes one of
them: the same function as the published Linear over E rows.

The diffusion (`CategoricalDiffusion`): Q_t = (1 - b_t) I + (b_t / 2) 1 1^T,
b linear from 1e-4 to 0.02 over T = diffusion_steps steps, Q^_0 = I and
Q^_t = Q^_{t-1} Q_t, in float64.  Step i of the cosine schedule runs from
t = clip(T - floor(sin(pi/2 i/S) T), 1, T) to s = clip(T - floor(sin(pi/2
(i+1)/S) T), 0, T - 1).  With Q = Q^_s^-1 Q^_t (I at s = 0):

    pi_k = (1 - p^_k) Q[1,x] Q^_s[0,1] / Q^_t[0,x] + p^_k Q[1,x] Q^_s[1,1] / Q^_t[1,x]

x_s = [u < clamp(pi, 0, 1)] for s > 0; at s = 0 the heatmap is max(pi, 0).
The draws and the loop are `evaluate.predict_diffusion_guide`'s.
`heatmap_guide` turns the heatmap into the search's (n, n) guide,
1 - (h_ij + h_ji) / 2 on the edge list's pairs, 1 elsewhere, 0 on the
diagonal.

Module and parameter names are the published `GNNEncoder`'s, so its state
dict loads as it is (`load_model`).  Departures from the published code:
  * GroupNorm normalises each instance's own E edges (the published test
    step runs one graph a batch);
  * equal distances in the edge list go to the lower city id;
  * the guide and GLS take the place of greedy decoding and 2-opt;
  * one trajectory an instance (the published greedy setting);
  * Q = I at s = 0, the published first release's branch (a later commit
    drops it, so that Q = Q^_t there and the heatmap is p^ itself).
Weights are the caller's: no trained checkpoint is in the repository.

`DifuscoConfig` raises for other values of schedule ("cosine"),
aggregation ("sum") and norm ("layer"), and for a hidden_dim that 32
groups and the sine halves cannot split (a multiple of 32).

Numerics: float32 products with TF32 off, under
`regret_gat.exact_f32_matmuls` (`evaluate.predict_diffusion_guide`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from .gated_gcn import nearest_cities


@dataclasses.dataclass(frozen=True)
class DifuscoConfig:
    """The published TSP-500 setting."""

    hidden_dim: int = 256
    num_layers: int = 12
    sparse_factor: int = 50
    diffusion_steps: int = 1000
    inference_steps: int = 50
    schedule: str = "cosine"
    aggregation: str = "sum"
    norm: str = "layer"

    def __post_init__(self):
        for key, only in (("schedule", "cosine"), ("aggregation", "sum"), ("norm", "layer")):
            if getattr(self, key) != only:
                raise ValueError(f"{key} {getattr(self, key)!r}: only {only!r} is ported")
        if self.hidden_dim % 32:
            raise ValueError(f"hidden_dim {self.hidden_dim} must be a multiple of 32 "
                             "(GroupNorm's 32 groups, the sine embeddings' halves)")


class CategoricalDiffusion:
    """The published two-state diffusion: Q^_t for t = 0..T in float64, the
    cosine inference schedule, and each step's posterior coefficients."""

    def __init__(self, T: int):
        self.T = T
        beta = np.linspace(1e-4, 2e-2, T).reshape(-1, 1, 1)
        Qs = (1 - beta) * np.eye(2) + (beta / 2) * np.ones((2, 2))
        q_bar = [np.eye(2)]
        for Q in Qs:
            q_bar.append(q_bar[-1] @ Q)
        self.q_bar = np.stack(q_bar)

    def steps(self, inference_steps: int) -> List[Tuple[int, int]]:
        """The (t, s) of each denoising step, in order."""
        T, S = self.T, inference_steps

        def at(i):
            return T - int(np.sin(i / S * np.pi / 2) * T)

        return [(int(np.clip(at(i), 1, T)), int(np.clip(at(i + 1), 0, T - 1)))
                for i in range(S)]

    def coefficients(self, t: int, s: int) -> np.ndarray:
        """(2, 2) float32 c with pi = (1 - p) c[0, x] + p c[1, x]:
        c[a, x] = Q[1, x] Q^_s[a, 1] / Q^_t[a, x]."""
        qt, qs = self.q_bar[t], self.q_bar[s]
        Q = np.linalg.inv(qs) @ qt if s > 0 else np.eye(2)
        return (Q[1][None, :] * qs[:, 1:2] / qt).astype(np.float32)


def position_sine(coords: torch.Tensor, num_feats: int) -> torch.Tensor:
    """(..., 2) coordinates -> (..., 2 num_feats): DETR's
    PositionEmbeddingSine with normalize=True, coordinate 0 first."""
    scaled = coords * (2 * math.pi)
    return torch.cat((scalar_sine(scaled[..., 0], num_feats),
                      scalar_sine(scaled[..., 1], num_feats)), dim=-1)


def scalar_sine(x: torch.Tensor, num_feats: int, temperature: float = 10000.0) -> torch.Tensor:
    """(...) -> (..., num_feats): sin(x / d_f) on even f, cos on odd f,
    d_f = temperature^(2 floor(f / 2) / num_feats)."""
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=x.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="trunc") / num_feats)
    pos = x[..., None] / dim_t
    return torch.stack((pos[..., 0::2].sin(), pos[..., 1::2].cos()), dim=-1).flatten(-2)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """(N,) time steps -> (N, dim): cos of t times each of dim/2
    frequencies, then sin."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class GNNLayer(nn.Module):
    """The published anisotropic gated layer on the sparse edge list, sum
    aggregation, LayerNorm, called in its "direct" mode."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        H = hidden_dim
        self.U, self.V, self.A, self.B, self.C = (nn.Linear(H, H) for _ in range(5))
        self.norm_h = nn.LayerNorm(H)
        self.norm_e = nn.LayerNorm(H)

    def forward(self, h: torch.Tensor, e: torch.Tensor, rows: torch.Tensor):
        """h (B, n, H), e (B, n, K, H), rows (B n K,) the row of each edge's
        target j in h viewed as (B n, H) -> (ReLU(LN(h^)), ReLU(LN(e^)))."""
        B, n, K, H = e.shape
        Vh_j = self.V(h).view(B * n, H).index_select(0, rows).view(B, n, K, H)
        Ah_j = self.A(h).view(B * n, H).index_select(0, rows).view(B, n, K, H)
        e_hat = self.C(e).add_(Ah_j).add_(self.B(h).unsqueeze(2))
        h_hat = self.U(h).add_((torch.sigmoid(e_hat).mul_(Vh_j)).sum(2))
        return F.relu_(self.norm_h(h_hat)), F.relu_(self.norm_e(e_hat))


class Difusco(nn.Module):
    """The published GNNEncoder's sparse forward (module docstring), made
    in eval mode, with the diffusion of its configuration."""

    def __init__(self, cfg: DifuscoConfig = DifuscoConfig()):
        super().__init__()
        self.cfg = cfg
        H, L = cfg.hidden_dim, cfg.num_layers
        self.node_embed = nn.Linear(H, H)
        self.edge_embed = nn.Linear(H, H)
        self.time_embed = nn.Sequential(nn.Linear(H, H // 2), nn.ReLU(), nn.Linear(H // 2, H // 2))
        self.out = nn.Sequential(nn.GroupNorm(32, H), nn.ReLU(), nn.Conv2d(H, 2, kernel_size=1))
        self.layers = nn.ModuleList(GNNLayer(H) for _ in range(L))
        self.time_embed_layers = nn.ModuleList(
            nn.Sequential(nn.ReLU(), nn.Linear(H // 2, H)) for _ in range(L))
        self.per_layer_out = nn.ModuleList(
            nn.Sequential(nn.LayerNorm(H), nn.SiLU(), nn.Linear(H, H)) for _ in range(L))
        self.diffusion = CategoricalDiffusion(cfg.diffusion_steps)
        self.eval()

    def steps(self) -> List[Tuple[int, int]]:
        """This configuration's (t, s) denoising steps, read at each call."""
        return self.diffusion.steps(self.cfg.inference_steps)

    def forward(self, coords: torch.Tensor, x: torch.Tensor, t: int,
                nbr: torch.Tensor) -> torch.Tensor:
        """coords (B, n, 2), x (B, n, K) bool state, t the time step, nbr
        (B, n, K) the edge list (`edge_list`) -> p^ (B, n, K) float32."""
        B, n, K = nbr.shape
        H = self.cfg.hidden_dim
        h = self.node_embed(position_sine(coords, H // 2))
        # the states 0 and 1 made on the device: a copy from the host would
        # wait for the previous step's work at every forward
        two = self.edge_embed(scalar_sine(
            torch.arange(2, dtype=torch.float32, device=coords.device), H))
        e = torch.where(x.unsqueeze(-1), two[1], two[0])
        tau = self.time_embed(timestep_embedding(
            torch.full((1,), t, dtype=torch.float32, device=coords.device), H))
        rows = (nbr + n * torch.arange(B, device=nbr.device).view(B, 1, 1)).view(-1)
        for layer, time_layer, out_layer in zip(self.layers, self.time_embed_layers,
                                                self.per_layer_out):
            dh, de = layer(h, e, rows)
            h = h + dh
            e = e + out_layer(de.add_(time_layer(tau)))
        return self._head(e)

    def _head(self, e: torch.Tensor) -> torch.Tensor:
        """`out` on each instance's own (n K) edges -> p^ (B, n, K)."""
        norm, conv = self.out[0], self.out[2]
        B, n, K, H = e.shape
        G = norm.num_groups
        v = e.view(B, n * K, G, H // G)
        var, mean = torch.var_mean(v, dim=(1, 3), unbiased=False, keepdim=True)
        y = ((v - mean) * torch.rsqrt(var + norm.eps)).view(B, n, K, H)
        y = F.relu_(torch.addcmul(norm.bias, y, norm.weight))
        logits = F.linear(y, conv.weight.view(2, H), conv.bias)
        return torch.softmax(logits, dim=-1)[..., 1]

    def posterior(self, p: torch.Tensor, x: torch.Tensor, t: int, s: int) -> torch.Tensor:
        """pi (module docstring) of every edge for the step t -> s."""
        c = self.diffusion.coefficients(t, s)
        a = torch.where(x, float(c[0, 1]), float(c[0, 0]))
        b = torch.where(x, float(c[1, 1]), float(c[1, 0]))
        return (1 - p) * a + p * b


def edge_list(D: torch.Tensor, k: int) -> torch.Tensor:
    """(B, n, n) distances -> (B, n, min(k, n)) int64: each city's nearest
    cities, itself included, nearest first, ties to the lower id."""
    return nearest_cities(D, k, include_self=True)


def heatmap_guide(heat: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """(B, n, K) heatmap on the edge list nbr -> (B, n, n) float32 guide
    1 - (h_ij + h_ji) / 2, with h 0 off the edge list, and 0 on the
    diagonal."""
    B, n, _ = nbr.shape
    h = torch.zeros((B, n, n), dtype=heat.dtype, device=heat.device).scatter_(2, nbr, heat)
    guide = 1.0 - (h + h.transpose(1, 2)) / 2
    guide.diagonal(dim1=1, dim2=2).zero_()
    return guide


def load_model(path, cfg: DifuscoConfig, device=None) -> Difusco:
    """A `Difusco` with the weights of an npz of arrays under its
    state-dict names (a path or a file object), every name required, on
    `device`: "cuda" unless the caller asks for "cpu"."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        state = {k: torch.from_numpy(np.array(z[k], np.float32)) for k in z.files}
    model = Difusco(cfg)
    model.load_state_dict(state, strict=True)
    return model.to(device)
