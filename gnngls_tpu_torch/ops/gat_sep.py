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

Training repeats bit for bit on the card: the reads at rank are one
autograd Function (`_AtRank`), the same gathers forward, whose adjoint sums
each rank's cotangents in increasing target order (`rank_sums`: the kernel
csrc/rank_sums.cu on the card, torch's scatter-add on the CPU, which adds in
that order).  Autograd's adjoint of a gather is that scatter-add, and on
CUDA, where many targets share a rank, its atomics summed in no fixed order.
"""

from __future__ import annotations

import torch

from .. import kernels
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


def rank_sums_plain(idx, g, gh):
    """The twin of `rank_sums`: torch's scatter-add, autograd's adjoint of
    the gathers at rank."""
    return (torch.zeros_like(g).scatter_add_(-2, idx, g),
            torch.zeros_like(gh).scatter_add_(-3, idx[..., None].expand(gh.shape), gh))


def rank_sums(idx, g, gh):
    """The cotangents of the reads at rank summed into their ranks: idx
    (..., K, H) int64 in [0, K), g (..., K, H) and gh (..., K, H, F), f32 or
    f64 -> (gs, gsh) of g's and gh's shapes, gs[.., k, h] the sum of g[.., i,
    h] over the targets i with idx[.., i, h] == k in increasing i, gsh
    likewise.

    CPU tensors take the plain twin; CUDA tensors launch csrc/rank_sums.cu,
    which adds in the twin's order, or raise."""
    tensors = (idx, g, gh)
    if all(t.device.type == "cpu" for t in tensors):
        return rank_sums_plain(idx, g, gh)
    dev = g.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"rank_sums: all tensors must be on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if (idx.dtype != torch.int64 or g.dtype not in (torch.float32, torch.float64)
            or gh.dtype != g.dtype or idx.shape != g.shape or gh.shape[:-1] != g.shape):
        raise ValueError(f"rank_sums: expected idx (..., K, H) int64, g of its shape and gh "
                         f"(..., K, H, F) of g's dtype, f32 or f64; got {idx.dtype} "
                         f"{tuple(idx.shape)}, {g.dtype} {tuple(g.shape)}, {gh.dtype} "
                         f"{tuple(gh.shape)}")
    idx, g, gh = (t.contiguous() for t in tensors)
    K, H, F = gh.shape[-3:]
    gs, gsh = torch.empty_like(g), torch.empty_like(gh)
    err = kernels.library().rank_sums_launch(
        idx.data_ptr(), g.data_ptr(), gh.data_ptr(), g.numel() // (K * H), K, H, F,
        int(g.dtype == torch.float64), gs.data_ptr(), gsh.data_ptr(), dev.index,
        kernels.stream_of(g))
    kernels.check(err, "rank_sums_launch")
    kernels.launches["rank_sums"] += 1
    return gs, gsh


class _AtRank(torch.autograd.Function):
    """The scans read at rank: (s.gather(-2, idx), sh.gather(-3, idx)) for a
    sum s (..., K, H), a payload sh (..., K, H, F) and ranks idx (..., K, H),
    many targets to a rank; the adjoint is `rank_sums`."""

    @staticmethod
    def forward(ctx, s, sh, idx):
        ctx.save_for_backward(idx)
        return s.gather(-2, idx), sh.gather(-3, idx[..., None].expand(sh.shape))

    @staticmethod
    def backward(ctx, g, gh):
        (idx,) = ctx.saved_tensors
        return *rank_sums(idx, g, gh), None


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
    sum_neg, num_neg = _AtRank.apply(PC, PCh, idx_lo)
    sum_pos, num_pos = _AtRank.apply(SA, SAh, idx_hi)
    sum_neg, num_neg = sum_neg * nz_lo, num_neg * nz_lo[..., None]
    sum_pos, num_pos = sum_pos * nz_hi, num_pos * nz_hi[..., None]

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
