"""Separable GAT through threshold masks: K5's plain twin and route, and the
conv (gnngls_tpu/ops/pallas_gat_sep.py::_sep_kernel).

For each (batch b, city u) group of K = n-1 edges and each head, with targets
i and sources j of the group, exp(leaky(el_j + er_i)) factors by the sign of
el_j + er_i, so the TPU kernel never forms a score:

    M = max_j el_j, j* its first argmax, M2 = max_{j != j*} el_j,
    m_i = leaky((i == j* ? M2 : M) + er_i),
    A_j = e^(el_j - M), C_j = e^(0.2 (el_j - M)),
    B_i = e^(er_i + M - m_i), D_i = e^(0.2 (er_i + M) - m_i),
    P = [el_j + er_i > 0, j != i], N = [el_j + er_i <= 0, j != i],
    z = B (P A) + D (N C),  num = B (P @ Ah) + D (N @ Ch).

The payloads Ah = A h and Ch = C h are f32, or with fast=True bf16: h is cast
to bf16 first and Ah = bf16(bf16(A) h), as the TPU kernel rounds them.  The
mask products accumulate in f32 and z uses the f32 A and C in both modes.  The
partials have the contract of ops/gat_group.py's (m, z (B, n, K, H), num
(B, n, K, H, F)), so `merge_group_partials` merges the two groups of an edge.
`gat_sep_partials` runs the same function as sorted prefix sums
(ops/gat_sorted.py, csrc/gat_sorted.cu on the card), with these payloads.
"""

from __future__ import annotations

import torch

from ..core.graph import LineGraphTopology
from .gat import LEAKY_SLOPE, GATParams, _empty_partials, leaky, project, topo_index
from .gat_group import merge_group_partials
from .gat_sorted import gat_sorted_partials

_NEG = -3.0e38
_MASK_ELEMENTS = 2 ** 25  # the twin's (B, cities, K, K, H) mask block, elements


def gat_sep_partials_plain(el, er, h, city_edges, fast: bool = False):
    """The TPU kernel's math in torch, a block of cities at a time so that
    the (B, cities, K, K, H) masks stay under _MASK_ELEMENTS elements.  Tests
    hold the sorted-prefix kernel against it; no wrapper runs it."""
    ce = city_edges.long()
    n, K = ce.shape
    B, _, H, F = h.shape
    hv = h.to(torch.bfloat16) if fast else h
    m, z, num = _empty_partials(h, city_edges)
    off = ~torch.eye(K, dtype=torch.bool, device=el.device)
    kk = torch.arange(K, device=el.device)[:, None]  # (K, 1): along K, over heads
    step = max(1, _MASK_ELEMENTS // max(1, B * K * K * H))
    for c0 in range(0, n, step):
        idx = ce[c0:c0 + step]
        el_c, er_c = el[:, idx], er[:, idx]  # (B, c, K, H)
        M = el_c.amax(dim=2, keepdim=True)
        star = torch.where(el_c == M, kk, K).amin(dim=2, keepdim=True)
        is_star = kk == star
        M2 = torch.where(is_star, _NEG, el_c).amax(dim=2, keepdim=True)
        m_c = leaky(torch.where(is_star, M2, M) + er_c)
        A = torch.exp(el_c - M)
        C = torch.exp(LEAKY_SLOPE * (el_c - M))
        Bf = torch.exp(er_c + M - m_c)
        D = torch.exp(LEAKY_SLOPE * (er_c + M) - m_c)
        hv_c = hv[:, idx]  # (B, c, K, H, F)
        if fast:
            Ah = (A.to(torch.bfloat16)[..., None] * hv_c).float()
            Ch = (C.to(torch.bfloat16)[..., None] * hv_c).float()
        else:
            Ah, Ch = A[..., None] * hv_c, C[..., None] * hv_c
        hm = lambda t: t.permute(0, 1, 3, 2)  # noqa: E731  (B, c, K, H) -> (B, c, H, K)
        X = hm(er_c)[..., :, None] + hm(el_c)[..., None, :]  # (B, c, H, tgt, src)
        pos = ((X > 0) & off).float()
        neg = ((X <= 0) & off).float()
        z_pos = torch.matmul(pos, hm(A)[..., None])[..., 0]
        z_neg = torch.matmul(neg, hm(C)[..., None])[..., 0]
        n_pos = torch.matmul(pos, Ah.permute(0, 1, 3, 2, 4))  # (B, c, H, K, F)
        n_neg = torch.matmul(neg, Ch.permute(0, 1, 3, 2, 4))
        Bh, Dh = hm(Bf), hm(D)
        m[:, c0:c0 + step] = m_c
        z[:, c0:c0 + step] = hm(Bh * z_pos + Dh * z_neg)
        num[:, c0:c0 + step] = (Bh[..., None] * n_pos + Dh[..., None] * n_neg).permute(
            0, 1, 3, 2, 4)
    return m, z, num


def gat_sep_partials(el, er, h, city_edges, fast: bool = False):
    """K5's route: el, er (B, E, H) f32, h (B, E, H, F) f32, city_edges (n, K)
    int32 -> m, z (B, n, K, H), num (B, n, K, H, F).  fast=True takes bf16
    payloads (h is cast to bf16, for the kernel and the twin alike).

    The partials of `gat_sep_partials_plain`, as the sorted prefix sums of
    ops/gat_sorted.py: CPU tensors take that twin, CUDA tensors launch
    csrc/gat_sorted.cu (counted as "gat_sep") or raise.
    """
    return gat_sorted_partials(el, er, h, city_edges, fast, counter="gat_sep")


def gat_conv_group_sep(p: GATParams, topo: LineGraphTopology, x: torch.Tensor,
                       n_heads: int, fast: bool = False) -> torch.Tensor:
    """GATConv through K5's route: x (B, E, C_in) -> (B, E, H*F).  The projection is
    f32 in both modes, as gnngls_tpu's is on the CPU."""
    h, el, er = project(p, x, n_heads)
    city = topo_index(topo, x.device, "city_edges", torch.int32)
    m, z, num = gat_sep_partials(el.contiguous(), er.contiguous(), h.contiguous(), city, fast)
    return merge_group_partials(m, z, num, topo)
