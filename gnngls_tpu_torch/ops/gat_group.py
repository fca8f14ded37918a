"""GAT group partials: the CUDA kernel that replaces K2, its plain twin, and
the merge of each edge's two groups.

For each (batch b, city u) group of g = n-1 edges and each head, with targets
i and sources j of the group (i == j excluded):

    s_ij = leaky(el_j + er_i, 0.2),  m_i = max_j s_ij,
    z_i = sum_j exp(s_ij - m_i),     num_i = sum_j exp(s_ij - m_i) h_j.

This is gnngls_tpu/ops/pallas_gat.py::_group_kernel without the TPU's lane
replication: m and z are (B, n, g, H), num is (B, n, g, H, F).  The two
groups of an edge are merged outside the kernel by max-rescaling, as the JAX
package does (pallas_gat.py:263-275): `merge_group_partials`.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..core.graph import LineGraphTopology
from .gat import GATParams, leaky, project, topo_index

KERNEL_F = (8, 16, 32)  # head widths the kernel is instantiated for
_SMEM_LIMIT = 227 * 1024


def gat_group_partials_plain(el, er, h, city_edges):
    """Dense (B, n, g, g, H) torch version of the kernel."""
    ce = city_edges.long()
    g = ce.shape[1]
    el_c, er_c, h_c = el[:, ce], er[:, ce], h[:, ce]
    s = leaky(er_c[:, :, :, None, :] + el_c[:, :, None, :, :])  # (B, n, tgt, src, H)
    eye = torch.eye(g, dtype=torch.bool, device=el.device)[:, :, None]
    s = s.masked_fill(eye, -3.0e38)
    m = s.amax(dim=3)
    p = torch.exp(s - m[:, :, :, None, :])
    return m, p.sum(dim=3), torch.einsum("bnijh,bnjhf->bnihf", p, h_c)


def _check_inputs(el, er, h, city_edges):
    if any(t.dtype != torch.float32 for t in (el, er, h)):
        raise TypeError("gat_group_partials: el, er and h must be float32")
    if city_edges.dtype != torch.int32:
        raise TypeError("gat_group_partials: city_edges must be int32")
    if el.dim() != 3 or h.dim() != 4 or city_edges.dim() != 2:
        raise ValueError("gat_group_partials: expected el/er (B,E,H), "
                         "h (B,E,H,F), city_edges (n,g)")
    n, g = city_edges.shape
    if er.shape != el.shape or h.shape[:3] != el.shape or g != n - 1 \
            or el.shape[1] != n * (n - 1) // 2:
        raise ValueError(f"gat_group_partials: inconsistent shapes el {tuple(el.shape)}, "
                         f"er {tuple(er.shape)}, h {tuple(h.shape)}, "
                         f"city_edges {tuple(city_edges.shape)}")


def gat_group_partials(el, er, h, city_edges):
    """el, er (B, E, H) f32, h (B, E, H, F) f32, city_edges (n, g) int32.

    CPU tensors take the plain twin; CUDA tensors launch the kernel, or raise.
    """
    _check_inputs(el, er, h, city_edges)
    tensors = (el, er, h, city_edges)
    if all(t.device.type == "cpu" for t in tensors):
        return gat_group_partials_plain(el, er, h, city_edges)
    dev = el.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("gat_group_partials: all tensors must be on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gat_group_partials: tensors must be contiguous")
    B, E, H = el.shape
    F = h.shape[3]
    n, g = city_edges.shape
    if F not in KERNEL_F:
        raise ValueError(f"gat_group_partials: head width F={F} not in {KERNEL_F}")
    if g * (F + 2) * 4 > _SMEM_LIMIT:
        raise ValueError(f"gat_group_partials: n={n} needs more shared memory "
                         "than a block has (source chunking is kernel K3, not ported)")
    m = torch.empty((B, n, g, H), device=dev, dtype=torch.float32)
    z = torch.empty_like(m)
    num = torch.empty((B, n, g, H, F), device=dev, dtype=torch.float32)
    if B == 0:
        return m, z, num
    err = kernels.library().gat_group_launch(
        el.data_ptr(), er.data_ptr(), h.data_ptr(), city_edges.data_ptr(),
        B, n, E, H, F, m.data_ptr(), z.data_ptr(), num.data_ptr(),
        dev.index, kernels.stream_of(el))
    kernels.check(err, "gat_group_launch")
    kernels.launches["gat_group"] += 1
    return m, z, num


def merge_group_partials(m, z, num, topo: LineGraphTopology):
    """Merge the u- and v-group partials of every edge: (B, E, H*F)."""
    B, n, g, H = m.shape
    su = topo_index(topo, m.device, "slot_u")
    sv = topo_index(topo, m.device, "slot_v")
    m_f, z_f = m.reshape(B, n * g, H), z.reshape(B, n * g, H)
    num_f = num.reshape(B, n * g, H, -1)
    m_u, m_v = m_f[:, su], m_f[:, sv]
    mm = torch.maximum(m_u, m_v)
    a_u, a_v = torch.exp(m_u - mm), torch.exp(m_v - mm)
    zz = z_f[:, su] * a_u + z_f[:, sv] * a_v
    nn_ = num_f[:, su] * a_u[..., None] + num_f[:, sv] * a_v[..., None]
    out = nn_ / zz[..., None]
    return out.reshape(B, out.shape[1], -1)


def gat_conv_group(p: GATParams, topo: LineGraphTopology, x: torch.Tensor,
                   n_heads: int) -> torch.Tensor:
    """GATConv through the group partials: x (B, E, C_in) -> (B, E, H*F)."""
    h, el, er = project(p, x, n_heads)
    city = topo_index(topo, x.device, "city_edges", torch.int32)
    m, z, num = gat_group_partials(el.contiguous(), er.contiguous(),
                                   h.contiguous(), city)
    return merge_group_partials(m, z, num, topo)
