"""GAT over the K_n line graph: projection and the plain reference paths.

DGL 0.6.1 GATConv math as gnngls_tpu/ops/gat.py has it: a shared projection
without bias, score leaky(el[src] + er[dst], 0.2), softmax over the
destination's line-graph neighbours (never itself), weighted feature sum.

* `gat_conv_naive` gathers the explicit (E, 2(n-2)) neighbour lists.
* `gat_conv` is the dense city-group form: per city u, scores of the
  (n-1) x (n-1) group S_u with the self pair masked, stabilised by the max
  over both groups of each destination.
The main path runs `ops.gat_group.gat_conv_group` instead (the CUDA kernel).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..core.graph import LineGraphTopology

LEAKY_SLOPE = 0.2


class GATParams(NamedTuple):
    fc_w: torch.Tensor  # (C_in, H*F)
    attn_l: torch.Tensor  # (H, F)
    attn_r: torch.Tensor  # (H, F)


def leaky(s: torch.Tensor) -> torch.Tensor:
    return torch.where(s > 0, s, LEAKY_SLOPE * s)


def project(p: GATParams, x: torch.Tensor, n_heads: int):
    """x (..., E, C_in) -> h (..., E, H, F), el and er (..., E, H)."""
    h = torch.matmul(x, p.fc_w)
    h = h.reshape(h.shape[:-1] + (n_heads, -1))
    return h, (h * p.attn_l).sum(-1), (h * p.attn_r).sum(-1)


def topo_index(topo: LineGraphTopology, device, name: str,
               dtype: torch.dtype = torch.long) -> torch.Tensor:
    """A topology array as an index tensor on `device`, made once per
    (n, array, device, dtype): a host-to-device copy per layer would stall."""
    return _topo_tensor(topo.n, name, str(torch.device(device)), dtype)


@functools.lru_cache(maxsize=64)
def _topo_tensor(n: int, name: str, device: str, dtype: torch.dtype) -> torch.Tensor:
    from ..core.graph import build_topology

    return torch.as_tensor(getattr(build_topology(n), name), dtype=dtype, device=device)


def gat_conv_naive(p: GATParams, topo: LineGraphTopology, x: torch.Tensor,
                   n_heads: int) -> torch.Tensor:
    h, el, er = project(p, x, n_heads)
    nbr = topo_index(topo, x.device, "nbr")  # (E, K)
    s = leaky(el[..., nbr, :] + er[..., :, None, :])  # (..., E, K, H)
    alpha = torch.softmax(s, dim=-2)
    out = torch.einsum("...ekh,...ekhf->...ehf", alpha, h[..., nbr, :, :])
    return out.reshape(out.shape[:-2] + (-1,))


def gat_conv(p: GATParams, topo: LineGraphTopology, x: torch.Tensor,
             n_heads: int) -> torch.Tensor:
    n = topo.n
    h, el, er = project(p, x, n_heads)
    city = topo_index(topo, x.device, "city_edges")
    su, sv = topo_index(topo, x.device, "slot_u"), topo_index(topo, x.device, "slot_v")
    h_c, el_c, er_c = h[..., city, :, :], el[..., city, :], er[..., city, :]
    s = leaky(el_c[..., :, None, :, :] + er_c[..., :, :, None, :])  # (..., n, tgt, src, H)
    eye = torch.eye(n - 1, dtype=torch.bool, device=x.device)[:, :, None]
    s = s.masked_fill(eye, float("-inf"))
    m_g = s.amax(dim=-2)
    m_flat = m_g.reshape(m_g.shape[:-3] + (n * (n - 1),) + m_g.shape[-1:])
    m = torch.maximum(m_flat[..., su, :], m_flat[..., sv, :])
    p_ = torch.exp(s - m[..., city, :][..., :, :, None, :])
    z_g = p_.sum(dim=-2)
    num_g = torch.einsum("...uijh,...ujhf->...uihf", p_, h_c)
    z_flat = z_g.reshape(z_g.shape[:-3] + (n * (n - 1),) + z_g.shape[-1:])
    num_flat = num_g.reshape(num_g.shape[:-4] + (n * (n - 1),) + num_g.shape[-2:])
    z = z_flat[..., su, :] + z_flat[..., sv, :]
    num = num_flat[..., su, :, :] + num_flat[..., sv, :, :]
    out = num / z[..., None]
    return out.reshape(out.shape[:-2] + (-1,))
