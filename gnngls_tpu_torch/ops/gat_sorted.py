"""GAT group partials by sorted prefix sums: the CUDA kernel that replaces
K3 and K5 on the card, and its plain twin.

For each (batch b, city u) group of K = n-1 edges and each head, with targets
i and sources j of the group, exp(leaky(el_j + er_i)) factors by the sign of
el_j + er_i, and el_j + er_i > 0 <=> el_j > -er_i (gnngls_tpu/ops/gat_sep.py):

    M = max_j el_j, j* its first argmax, M2 = max_{j != j*} el_j,
    m_i = leaky((i == j* ? M2 : M) + er_i),
    A_j = e^(el_j - M), C_j = e^(0.2 (el_j - M)),
    B_i = e^(er_i + M - m_i), D_i = e^(0.2 (er_i + M) - m_i),
    z_i   = B_i sum_{el_j > -er_i, j != i} A_j     + D_i sum_{el_j <= -er_i, j != i} C_j,
    num_i = B_i sum_{el_j > -er_i, j != i} A_j h_j + D_i sum_{el_j <= -er_i, j != i} C_j h_j.

Each group's el is sorted once; the suffix sums of A and Ah and the prefix
sums of C and Ch, read at pos_i = #{el_j <= -er_i}, give both sums of every
target.  The target's own term is taken out as the payload the scan holds.
The row i = j* is computed directly: with f32 payloads as
p_j = e^(leaky(el_j + er_j*) - m_j*) (K3's numerics), with bf16 payloads from
the payloads times B_j* and D_j* (K5's).  The payloads are f32, or with
fast=True h in bf16 and Ah = bf16(bf16(A) h), as the TPU kernel K5 rounds
them; every sum is f32.  m is bit for bit K3's m, the exact row max.

The partials have the contract of ops/gat_group.py's (m, z (B, n, K, H), num
(B, n, K, H, F)), so `merge_group_partials` merges the two groups of an
edge.  `gat_group_partials_chunked` (K3's route) and `gat_sep_partials` (K5's)
run them; the `sep` route (ops/gat_sep.py) keeps JAX's gat_sep.py rounding.
"""

from __future__ import annotations

import torch

from .. import kernels
from .gat import LEAKY_SLOPE, _card, _check_inputs, _empty_partials, leaky

_BLOCK_ELEMENTS = 2 ** 24  # the twin's (B, cities, H, K, F) tensors, elements


def _payload(a, hv):
    """(..., K) factors times (..., K, F) features as f32 values: an f32
    product, or bf16(bf16(a) h) for bf16 features."""
    if hv.dtype == torch.bfloat16:
        return (a.to(torch.bfloat16)[..., None] * hv).float()
    return a[..., None] * hv


def _suffix(x, dim):
    """Inclusive suffix sums along dim, summed from the end (never total
    minus prefix)."""
    return torch.flip(torch.cumsum(torch.flip(x, (dim,)), dim), (dim,))


def gat_sorted_partials_plain(el, er, h, city_edges, fast: bool = False):
    """The kernel's arithmetic step by step, a block of cities at a time so
    that each (B, cities, H, K, F) tensor stays under _BLOCK_ELEMENTS."""
    ce = city_edges.long()
    n, K = ce.shape
    B, _, H, F = h.shape
    hv = h.to(torch.bfloat16) if fast else h
    m, z, num = _empty_partials(h, city_edges)
    kk = torch.arange(K, device=el.device)
    step = max(1, _BLOCK_ELEMENTS // max(1, B * K * H * F))
    hk = lambda t: t.transpose(2, 3)  # noqa: E731  (B, c, K, H) <-> (B, c, H, K)
    for c0 in range(0, n, step):
        idx = ce[c0:c0 + step]
        el_c, er_c = hk(el[:, idx]).contiguous(), hk(er[:, idx]).contiguous()  # (B, c, H, K)
        h_c = hv[:, idx].permute(0, 1, 3, 2, 4)  # (B, c, H, K, F)
        M = el_c.amax(dim=-1, keepdim=True)
        star = torch.where(el_c == M, kk, K).amin(dim=-1, keepdim=True)
        is_star = kk == star
        M2 = torch.where(is_star, float("-inf"), el_c).amax(dim=-1, keepdim=True)
        m_c = leaky(torch.where(is_star, M2, M) + er_c)
        A = torch.exp(el_c - M)
        C = torch.exp(LEAKY_SLOPE * (el_c - M))
        Bf = torch.exp(er_c + M - m_c)
        D = torch.exp(LEAKY_SLOPE * (er_c + M) - m_c)
        Ah, Ch = _payload(A, h_c), _payload(C, h_c)

        el_s, perm = torch.sort(el_c, dim=-1)
        perm_f = perm[..., None].expand(Ah.shape)
        SA, PC = _suffix(A.gather(-1, perm), -1), torch.cumsum(C.gather(-1, perm), -1)
        SAh = _suffix(Ah.gather(-2, perm_f), -2)
        PCh = torch.cumsum(Ch.gather(-2, perm_f), -2)
        del perm_f
        # pos_i = #{el_j <= -er_i}: the positive sums are the suffix at rank
        # pos, the negative ones the prefix at rank pos - 1
        pos = torch.searchsorted(el_s, -er_c, right=True)
        has_hi, has_lo = pos < K, pos > 0
        hi, lo = pos.clamp(max=K - 1), (pos - 1).clamp(min=0)
        self_pos = el_c > -er_c
        sum_pos = torch.where(has_hi, SA.gather(-1, hi), 0.0) - torch.where(self_pos, A, 0.0)
        sum_neg = torch.where(has_lo, PC.gather(-1, lo), 0.0) - torch.where(self_pos, 0.0, C)
        num_pos = torch.where(has_hi[..., None], SAh.gather(-2, hi[..., None].expand(SAh.shape)),
                              0.0) - torch.where(self_pos[..., None], Ah, 0.0)
        del SAh
        num_neg = torch.where(has_lo[..., None], PCh.gather(-2, lo[..., None].expand(PCh.shape)),
                              0.0) - torch.where(self_pos[..., None], 0.0, Ch)
        del PCh
        z_c = Bf * sum_pos + D * sum_neg
        num_c = Bf[..., None] * num_pos + D[..., None] * num_neg
        del num_pos, num_neg

        # the row i = j*, directly
        er_star = er_c.gather(-1, star)
        m_star = leaky(M2 + er_star)
        if fast:
            up = el_c > -er_star
            P, N = up & ~is_star, ~up & ~is_star
            B_star = torch.exp(er_star + M - m_star)
            D_star = torch.exp(LEAKY_SLOPE * (er_star + M) - m_star)
            z_star = (B_star * torch.where(P, A, 0.0).sum(-1, keepdim=True)
                      + D_star * torch.where(N, C, 0.0).sum(-1, keepdim=True))
            num_star = (B_star[..., None] * torch.where(P[..., None], Ah, 0.0).sum(-2, True)
                        + D_star[..., None] * torch.where(N[..., None], Ch, 0.0).sum(-2, True))
        else:
            p = torch.where(is_star, 0.0, torch.exp(leaky(el_c + er_star) - m_star))
            z_star = p.sum(-1, keepdim=True)
            num_star = (p[..., None] * h_c).sum(-2, keepdim=True)
        m[:, c0:c0 + step] = hk(m_c)
        z[:, c0:c0 + step] = hk(torch.where(is_star, z_star, z_c))
        num[:, c0:c0 + step] = torch.where(is_star[..., None], num_star, num_c).permute(
            0, 1, 3, 2, 4)
    return m, z, num


def gat_sorted_partials(el, er, h, city_edges, fast: bool = False,
                        counter: str = "gat_sorted"):
    """el, er (B, E, H) f32, h (B, E, H, F) f32, city_edges (n, K) int32 ->
    m, z (B, n, K, H), num (B, n, K, H, F).  fast=True takes bf16 payloads
    (h is cast to bf16 here, for the kernel and the twin alike).  `counter`
    names the entry of `kernels.launches` that a launch adds to: the route
    that asked for these partials.

    CPU tensors take the plain twin; CUDA tensors launch the kernel
    (csrc/gat_sorted.cu), or raise: ValueError where even 4-column slices of
    the group's scans do not fit a block's shared memory (on an H100, n above
    2712 with f32 payloads and 2441 with bf16 ones; `gat_sorted_max_n` of the
    library says it for the device at hand).
    """
    _check_inputs(el, er, h, city_edges)
    dev = _card("gat_sorted_partials", el, er, h, city_edges)
    if dev is None:
        return gat_sorted_partials_plain(el, er, h, city_edges, fast)
    B, E, H, F = h.shape
    n = city_edges.shape[0]
    hv = h.to(torch.bfloat16).contiguous() if fast else h
    if hv.data_ptr() % 16:
        raise ValueError("gat_sorted_partials: h must start on a 16-byte boundary")
    m, z, num = _empty_partials(h, city_edges)
    if B == 0:
        return m, z, num
    err = kernels.library().gat_sorted_launch(
        el.data_ptr(), er.data_ptr(), hv.data_ptr(), city_edges.data_ptr(),
        B, n, E, H, F, int(fast), m.data_ptr(), z.data_ptr(), num.data_ptr(),
        dev.index, kernels.stream_of(el))
    if err == kernels.SMEM_EXCEEDED:
        top = kernels.library().gat_sorted_max_n(int(fast), dev.index)
        raise ValueError(f"gat_sorted_partials: n={n} is past the sorted-prefix kernel's "
                         f"range: a block holds the group's keys and scans in shared memory, "
                         f"n <= {top} on this device with {'bf16' if fast else 'f32'} payloads")
    kernels.check(err, "gat_sorted_launch")
    kernels.launches[counter] += 1
    return m, z, num
