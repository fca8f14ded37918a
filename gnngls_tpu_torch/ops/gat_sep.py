"""Separable GAT by sorted prefix sums (gnngls_tpu/ops/gat_sep.py), plain torch.

s_ij = leaky(el_j + er_i) splits on the sign of el_j + er_i, and
el_j + er_i > 0 <=> el_j > -er_i, so for each target i the softmax sums
split at a threshold in el:

  z_i   = B_i sum_{el_j > -er_i} A_j     + D_i sum_{el_j <= -er_i} C_j
  num_i = B_i sum_{el_j > -er_i} A_j h_j + D_i sum_{el_j <= -er_i} C_j h_j

with A, C, B, D as in ops/gat_group_sep.py.  Each group's el is sorted once;
prefix sums of C and suffix sums of A (payloads as triangular matmuls in the
activations' dtype, the suffix taken directly, not as total minus prefix) are read
at each row's threshold, found by binary search.  The target's own term is
taken out in the linear domain, and the one row i = argmax el per (group,
head), whose factors are not bounded by 1, is computed directly.  fast=True
rounds the payloads to bf16 (`ops.gat.to_bf16`: held in the activations'
dtype, summed in it); the projection stays f32.

This is the `sep` / `sep_fast` route and a second reference for K5 in the
tests; K5's plain twin is the mask form in ops/gat_group_sep.py.
"""

from __future__ import annotations

import torch

from ..core.graph import LineGraphTopology
from .gat import LEAKY_SLOPE, GATParams, leaky, project, to_bf16, topo_index
from .gat_group import merge_group_partials


def _scan_payload(x: torch.Tensor, suffix: bool = False) -> torch.Tensor:
    """Inclusive prefix (or suffix) sums of (..., K, H, F) along K, as a
    (K, K) triangular matmul in x's dtype."""
    K, H, F = x.shape[-3:]
    ones = torch.ones((K, K), dtype=x.dtype, device=x.device)
    tri = torch.triu(ones) if suffix else torch.tril(ones)
    out = torch.matmul(tri, x.reshape(x.shape[:-3] + (K, H * F)))
    return out.reshape(x.shape)


def gat_conv_sep_partials(p: GATParams, topo: LineGraphTopology, x: torch.Tensor,
                          n_heads: int, fast: bool = False):
    """Per-group partials (m, z, num): (..., n, K, H[, F]), z and num offset
    by m, the contract of ops/gat_group.py's partials."""
    K = topo.n - 1
    h, el, er = project(p, x, n_heads)
    city = topo_index(topo, x.device, "city_edges")
    h_c, el_c, er_c = h[..., city, :, :], el[..., city, :], er[..., city, :]

    M = el_c.amax(dim=-2, keepdim=True)
    jmax = el_c.argmax(dim=-2, keepdim=True)  # the first argmax
    is_star = torch.arange(K, device=x.device)[:, None] == jmax
    M2 = torch.where(is_star, float("-inf"), el_c).amax(dim=-2, keepdim=True)
    m_g = leaky(torch.where(is_star, M2, M) + er_c)

    A = torch.exp(el_c - M)
    C = torch.exp(LEAKY_SLOPE * (el_c - M))
    Bf = torch.exp(er_c + M - m_g)
    Dn = torch.exp(LEAKY_SLOPE * (er_c + M) - m_g)

    pay = to_bf16 if fast else (lambda t: t)  # noqa: E731
    el_s, perm = torch.sort(el_c, dim=-2)
    A_s, C_s = A.gather(-2, perm), C.gather(-2, perm)
    Ah = pay(A[..., None] * h_c)
    Ch = pay(C[..., None] * h_c)
    perm_p = perm[..., None].expand(Ah.shape)
    PC = torch.cumsum(C_s, dim=-2)
    SA = torch.flip(torch.cumsum(torch.flip(A_s, (-2,)), dim=-2), (-2,))
    PCh = _scan_payload(Ch.gather(-3, perm_p))
    SAh = _scan_payload(Ah.gather(-3, perm_p), suffix=True)

    # pos_i = #{j : el_s[j] <= -er_i}; the negative branch is the prefix at
    # rank pos-1, the positive one the suffix at rank pos
    pos = torch.searchsorted(el_s.transpose(-1, -2).contiguous(),
                             (-er_c).transpose(-1, -2).contiguous(),
                             right=True).transpose(-1, -2)
    idx_lo, idx_hi = (pos - 1).clamp(min=0), pos.clamp(max=K - 1)
    nz_lo, nz_hi = (pos > 0).to(A.dtype), (pos < K).to(A.dtype)
    sum_neg = PC.gather(-2, idx_lo) * nz_lo
    sum_pos = SA.gather(-2, idx_hi) * nz_hi
    num_neg = PCh.gather(-3, idx_lo[..., None].expand(PCh.shape)) * nz_lo[..., None]
    num_pos = SAh.gather(-3, idx_hi[..., None].expand(SAh.shape)) * nz_hi[..., None]

    # the target's own term, taken out in the linear domain
    self_pos = (el_c + er_c) > 0
    Ah32, Ch32 = A[..., None] * h_c, C[..., None] * h_c
    sum_pos = sum_pos - torch.where(self_pos, A, 0.0)
    sum_neg = sum_neg - torch.where(self_pos, 0.0, C)
    num_pos = num_pos - torch.where(self_pos[..., None], Ah32, 0.0)
    num_neg = num_neg - torch.where(self_pos[..., None], 0.0, Ch32)
    z_g = Bf * sum_pos + Dn * sum_neg
    num_g = Bf[..., None] * num_pos + Dn[..., None] * num_neg

    # the row i = argmax el, directly
    er_star = er_c.gather(-2, jmax)
    m_star = leaky(M2 + er_star)
    p_star = torch.where(is_star, 0.0, torch.exp(leaky(el_c + er_star) - m_star))
    z_star = p_star.sum(dim=-2, keepdim=True)
    num_star = torch.einsum("...kh,...khf->...hf", pay(p_star), pay(h_c))
    z_g = torch.where(is_star, z_star, z_g)
    num_g = torch.where(is_star[..., None], num_star[..., None, :, :], num_g)
    return m_g, z_g, num_g


def gat_conv_sep(p: GATParams, topo: LineGraphTopology, x: torch.Tensor,
                 n_heads: int, fast: bool = False) -> torch.Tensor:
    """x (..., E, C_in) -> (..., E, H*F)."""
    lead = x.shape[:-2]
    m, z, num = gat_conv_sep_partials(p, topo, x.reshape((-1,) + x.shape[-2:]), n_heads, fast)
    out = merge_group_partials(m, z, num, topo)
    return out.reshape(lead + out.shape[-2:])
