"""Edge-sharded GAT message passing with ring exchanges
(gnngls_tpu/ops/gat_ring.py).

`gat_conv_sharded` replicates the edge activations; here they stay sharded
over a mesh axis, so each rank holds 1/ndev of the E-space tensors:
  * each rank owns a contiguous block of eper = Ep/ndev edge ids (the edge
    axis padded to Ep, `ring_pad`) and is home to per = n/ndev cities,
    whose dense groups it computes in chunks of `city_chunk` cities
    (flash-style: peak score memory city_chunk/n of `gat_conv`'s);
  * ring 1 passes the projected edge blocks around the ranks (each rank
    sends to rank+1 and receives from rank-1); each rank copies into its
    home groups the slots the visiting block holds;
  * an all_gather of the per-(group, target) score maxima pins every
    edge's stabiliser to its max over both groups before any exp;
  * ring 2 passes the groups' [num | z] partials around; each rank adds the
    two slots of every edge it owns.
With one rank on the axis the ring has one member: the local block is used
and nothing is sent.  Inference only (the exchanges have no backward here).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core.graph import LineGraphTopology
from ..parallel.mesh import all_gather_cat
from .gat import GATParams, leaky, topo_index


def padded_edges(E: int, ndev: int) -> int:
    """The edge count padded so that every rank owns an equal block."""
    return ndev * ((E + ndev - 1) // ndev)


def ring_pad(x, ndev: int, axis: int = -2):
    """x (numpy or torch) with its edge axis zero-padded to padded_edges."""
    E = x.shape[axis]
    Ep = padded_edges(E, ndev)
    if Ep == E:
        return x
    shape = list(x.shape)
    shape[axis] = Ep - E
    if torch.is_tensor(x):
        return torch.cat([x, x.new_zeros(shape)], dim=axis)
    return np.concatenate([x, np.zeros(shape, x.dtype)], axis=axis)


def ring_unpad(x, E: int, axis: int = -2):
    """x with the edge padding stripped back to E."""
    idx = [slice(None)] * x.ndim
    idx[axis % x.ndim] = slice(0, E)
    return x[tuple(idx)]


def edge_sharding(x, mesh, axis: str = "model", edge_axis: int = -2):
    """This rank's contiguous block of x's (padded) edge axis."""
    ndev = mesh[axis].size()
    Ep = x.shape[edge_axis]
    if Ep % ndev != 0:
        raise ValueError(f"edge axis {Ep} not divisible by {ndev} '{axis}' devices; "
                         "pad it with ring_pad")
    eper = Ep // ndev
    idx = [slice(None)] * x.ndim
    d = mesh.get_local_rank(axis)
    idx[edge_axis % x.ndim] = slice(d * eper, (d + 1) * eper)
    return x[tuple(idx)]


def _ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """x sent to rank+1 of the group; the block from rank-1 returned."""
    ndev, d = dist.get_world_size(group), dist.get_rank(group)
    if ndev == 1:
        return x
    x = x.contiguous()
    got = torch.empty_like(x)
    to = dist.get_global_rank(group, (d + 1) % ndev)
    frm = dist.get_global_rank(group, (d - 1) % ndev)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, to, group),
                                       dist.P2POp(dist.irecv, got, frm, group)]):
        req.wait()
    return got


def gat_conv_ring(p: GATParams, topo: LineGraphTopology, x: torch.Tensor, n_heads: int,
                  mesh, axis: str = "model", city_chunk: int = 8) -> torch.Tensor:
    """x (..., eper, C_in), this rank's block of the padded edge axis ->
    (..., eper, H*F), the same block.  Entries past the real E are padding
    (garbage out: strip with ring_unpad after gathering)."""
    n, E = topo.n, topo.n_edges
    ndev = mesh[axis].size()
    if n % ndev != 0:
        raise ValueError(f"n={n} must divide evenly over {ndev} '{axis}' devices")
    per = n // ndev
    if per % city_chunk != 0:
        city_chunk = max(c for c in range(1, city_chunk + 1) if per % c == 0)
    Ep = padded_edges(E, ndev)
    eper = Ep // ndev
    if x.shape[-2] != eper:
        raise ValueError(f"expected this rank's {eper} of {Ep} padded edges, "
                         f"got {x.shape[-2]}")
    group = mesh.get_group(axis)
    d = mesh.get_local_rank(axis)
    lead = x.shape[:-2]
    x = x.reshape((-1,) + x.shape[-2:])
    B = x.shape[0]
    H = n_heads
    F = p.fc_w.shape[1] // H
    g = n - 1
    gsz = per * g  # flat slots of this rank's home groups
    dev = x.device
    city = topo_index(topo, dev, "city_edges")
    pad = torch.zeros(Ep - E, dtype=torch.long, device=dev)
    slot_u = torch.cat([topo_index(topo, dev, "slot_u"), pad])
    slot_v = torch.cat([topo_index(topo, dev, "slot_v"), pad])
    ce = city[d * per:(d + 1) * per]  # (per, g) edge ids of the home groups

    # ring 1: the home groups' projected features from the visiting blocks
    vis = torch.matmul(x, p.fc_w).reshape(B, eper, H, F)
    h_c = torch.zeros((B, per, g, H, F), dtype=vis.dtype, device=dev)
    for t in range(ndev):
        o = (d - t) % ndev  # the block visiting at step t is rank o's
        mask = (ce >= o * eper) & (ce < (o + 1) * eper)
        idx = (ce - o * eper).clamp(0, eper - 1)
        h_c = torch.where(mask[..., None, None], vis[:, idx], h_c)
        if t + 1 < ndev:
            vis = _ring_shift(vis, group)
    el_c = (h_c * p.attn_l).sum(-1)  # (B, per, g, H)
    er_c = (h_c * p.attn_r).sum(-1)
    eye = torch.eye(g, dtype=torch.bool, device=dev)[:, :, None]
    chunks = range(0, per, city_chunk)

    def scores(c0):
        s = leaky(el_c[:, c0:c0 + city_chunk, None] + er_c[:, c0:c0 + city_chunk, :, None])
        return s.masked_fill(eye, float("-inf"))  # (B, chunk, tgt, src, H)

    # the stabiliser: every slot's group max, gathered, max over both slots
    m_g = torch.cat([scores(c0).amax(dim=-2) for c0 in chunks], dim=1)
    m_flat = all_gather_cat(m_g.reshape(B, gsz, H), group, dim=1)  # (B, n*g, H)
    m_c = torch.maximum(m_flat[:, slot_u[ce]], m_flat[:, slot_v[ce]])  # (B, per, g, H)

    zn = []
    for c0 in chunks:
        p_ = torch.exp(scores(c0) - m_c[:, c0:c0 + city_chunk, :, None])
        num = torch.einsum("buijh,bujhf->buihf", p_, h_c[:, c0:c0 + city_chunk])
        zn.append(torch.cat([num, p_.sum(dim=-2)[..., None]], dim=-1))
    vis = torch.cat(zn, dim=1).reshape(B, gsz, H, F + 1)

    # ring 2: each owned edge adds its two slots' partials from their home ranks
    su_own = slot_u[d * eper:(d + 1) * eper]
    sv_own = slot_v[d * eper:(d + 1) * eper]
    acc = torch.zeros((B, eper, H, F + 1), dtype=vis.dtype, device=dev)
    for t in range(ndev):
        o = (d - t) % ndev
        for own in (su_own, sv_own):
            hit = (own >= o * gsz) & (own < (o + 1) * gsz)
            acc = acc + torch.where(hit[:, None, None], vis[:, (own - o * gsz).clamp(0, gsz - 1)],
                                    0.0)
        if t + 1 < ndev:
            vis = _ring_shift(vis, group)
    out = acc[..., :F] / acc[..., F:]
    return out.reshape(lead + (eper, H * F))
