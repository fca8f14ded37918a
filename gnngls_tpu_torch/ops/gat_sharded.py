"""City-sharded GAT message passing over a mesh axis
(gnngls_tpu/ops/gat_sharded.py).

The cities split evenly over the axis' ranks.  Each rank computes the dense
(n-1) x (n-1) groups of its own cities (the `gat_conv` formulation), then:
  1. an all_gather of the group maxima, and each edge's max over its two
     slots (the softmax stabiliser);
  2. an all_gather of the [num | z] partials offset by those maxima, summed
     per edge over its two slots.
x is replicated and so is the output.  Inference only: the all_gathers have
no backward here.
"""

from __future__ import annotations

import torch

from ..core.graph import LineGraphTopology
from ..parallel.mesh import all_gather_cat
from .gat import GATParams, leaky, project, topo_index


def gat_conv_sharded(p: GATParams, topo: LineGraphTopology, x: torch.Tensor,
                     n_heads: int, mesh, axis: str = "model") -> torch.Tensor:
    """x (..., E, C_in) -> (..., E, H*F), both replicated; n % (the axis'
    ranks) must be 0."""
    n = topo.n
    ndev = mesh[axis].size()
    if n % ndev != 0:
        raise ValueError(f"n={n} must divide evenly over {ndev} '{axis}' devices")
    per = n // ndev
    group = mesh.get_group(axis)
    lead = x.shape[:-2]
    h, el, er = project(p, x.reshape((-1,) + x.shape[-2:]), n_heads)
    B, _, H, F = h.shape
    d = mesh.get_local_rank(axis)
    city = topo_index(topo, x.device, "city_edges")
    su, sv = topo_index(topo, x.device, "slot_u"), topo_index(topo, x.device, "slot_v")
    ce = city[d * per:(d + 1) * per]
    s = leaky(el[:, ce][:, :, None] + er[:, ce][:, :, :, None])  # (B, per, tgt, src, H)
    eye = torch.eye(n - 1, dtype=torch.bool, device=x.device)[:, :, None]
    s = s.masked_fill(eye, float("-inf"))

    m_flat = all_gather_cat(s.amax(dim=-2), group, dim=1).reshape(B, n * (n - 1), H)
    m = torch.maximum(m_flat[:, su], m_flat[:, sv])  # (B, E, H)
    p_ = torch.exp(s - m[:, ce][..., None, :])
    zn = torch.cat([torch.einsum("buijh,bujhf->buihf", p_, h[:, ce]),
                    p_.sum(dim=-2)[..., None]], dim=-1)  # (B, per, n-1, H, F+1)
    zn = all_gather_cat(zn, group, dim=1).reshape(B, n * (n - 1), H, F + 1)
    zn_e = zn[:, su] + zn[:, sv]
    out = zn_e[..., :F] / zn_e[..., F:]
    return out.reshape(lead + (-1, H * F))
