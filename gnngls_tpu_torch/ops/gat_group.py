"""GAT group partials: the CUDA kernels that replace K2 and K4, the route of
K3, the plain twins of all three, and the merge of each edge's two groups.

For each (batch b, city u) group of g = n-1 edges and each head, with targets
i and sources j of the group (i == j excluded):

    s_ij = leaky(el_j + er_i, 0.2),  m_i = max_j s_ij,
    z_i = sum_j exp(s_ij - m_i),     num_i = sum_j exp(s_ij - m_i) h_j.

K2 (gnngls_tpu/ops/pallas_gat.py::_group_kernel) computes them in one shot;
K3 (`_group_kernel_chunked`) streams the sources in chunks of gs and merges
the chunks' partials online, flash-style; K4 (`_group_kernel_mxu`) computes
K2's partials with num as one (g x g) @ (g x F) product per head.  On the
card K2 and K4 have kernels of their own (K4's product on the tensor cores,
in 3xTF32), and K3's route runs the sorted-prefix kernel of
ops/gat_sorted.py, which gives the same partials.
All without the TPU's lane replication: m and z are (B, n, g, H), num is
(B, n, g, H, F).  The two groups of an edge are merged outside the kernels
by max-rescaling, as the JAX package does (pallas_gat.py:263-275):
`merge_group_partials`.
"""

from __future__ import annotations

import warnings

import torch

from .. import kernels
from ..core.graph import LineGraphTopology
from .gat import GATParams, _card, _check_inputs, _empty_partials, leaky, project, topo_index
from .gat_sorted import gat_sorted_partials


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


def gat_group_partials_mxu_plain(el, er, h, city_edges):
    """K4's partials as _group_kernel_mxu computes them: the score tile with
    the self pair at -3.0e38, its row max m, p = exp(s - m), z = sum_j p, and
    num as one (g x g) @ (g x F) product per head."""
    ce = city_edges.long()
    g = ce.shape[1]
    el_c, er_c = el[:, ce].transpose(2, 3), er[:, ce].transpose(2, 3)  # (B, n, H, g)
    s = leaky(er_c[..., :, None] + el_c[..., None, :])  # (B, n, H, tgt, src)
    s = s.masked_fill(torch.eye(g, dtype=torch.bool, device=el.device), -3.0e38)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    num = torch.matmul(p, h[:, ce].transpose(2, 3))  # (B, n, H, g, F)
    return m.transpose(2, 3), p.sum(dim=-1).transpose(2, 3), num.transpose(2, 3)


def source_chunk(n: int, hf: int) -> int:
    """The source chunk gs that gnngls_tpu's gat_conv_pallas picks at this n
    and width HF = H*F (pallas_gat.py:229-232), or 0 for the one-shot
    partials.  It is kept as a rule of numerics: at every n the port runs the
    same partials as the JAX package, one-shot or chunked with the same gs,
    so the two stay comparable.  Its 6 MiB and 4 MiB are TPU VMEM slab sizes,
    not H100 speed figures."""
    g = n - 1
    if g * g * hf * 4 <= 6 * 2 ** 20:
        return 0
    return max(8, (4 * 2 ** 20) // (g * hf * 4) // 8 * 8)


def gat_group_partials_chunked_plain(el, er, h, city_edges, gs: int):
    """K3's partials chunk by chunk, as _group_kernel_chunked computes them.

    The source axis is padded to gp = ceil(g/gs)*gs, el with -3.0e38 and h
    with zeros (pallas_gat.py:249-257); the self pair is masked at the global
    source index k*gs + j == i; chunk 0 sets the running (m, z, num) and
    every later chunk merges into it: m' = max(m, m_k),
    z' = z e^(m-m') + z_k e^(m_k-m'), likewise num.  A chunk whose only real
    source is the target gets a finite m_k from its padded lanes, and the
    merge weighs it by e^(m_k-m') = 0.  It is the plain arithmetic of the
    TPU kernel, which tests hold the sorted-prefix kernel against; no
    wrapper runs it."""
    ce = city_edges.long()
    g = ce.shape[1]
    K = -(-g // gs)
    pad = K * gs - g
    el_c, er_c, h_c = el[:, ce], er[:, ce], h[:, ce]  # (B, n, g, H[, F])
    el_c = torch.nn.functional.pad(el_c, (0, 0, 0, pad), value=-3.0e38)
    h_c = torch.nn.functional.pad(h_c, (0, 0, 0, 0, 0, pad))
    tgt = torch.arange(g, device=el.device)[:, None]
    m = z = num = None
    for k in range(K):
        src = slice(k * gs, (k + 1) * gs)
        s = leaky(er_c[:, :, :, None, :] + el_c[:, :, None, src, :])  # (B, n, g, gs, H)
        self_pair = (tgt == torch.arange(k * gs, (k + 1) * gs, device=el.device))
        s = s.masked_fill(self_pair[:, :, None], -3.0e38)
        m_k = s.amax(dim=3)
        p = torch.exp(s - m_k[:, :, :, None, :])
        z_k = p.sum(dim=3)
        num_k = torch.einsum("bnijh,bnjhf->bnihf", p, h_c[:, :, src])
        if k == 0:
            m, z, num = m_k, z_k, num_k
            continue
        m_new = torch.maximum(m, m_k)
        so, sk = torch.exp(m - m_new), torch.exp(m_k - m_new)
        m = m_new
        z = z * so + z_k * sk
        num = num * so[..., None] + num_k * sk[..., None]
    return m, z, num


def gat_group_partials(el, er, h, city_edges):
    """el, er (B, E, H) f32, h (B, E, H, F) f32, city_edges (n, g) int32.

    CPU tensors take the plain twin; CUDA tensors launch the kernel, or raise
    (ValueError where a block of this shape does not fit the device's shared
    memory; K3's route, the sorted-prefix partials, runs far past it).
    """
    _check_inputs(el, er, h, city_edges)
    dev = _card("gat_group_partials", el, er, h, city_edges)
    if dev is None:
        return gat_group_partials_plain(el, er, h, city_edges)
    B, E, H, F = h.shape
    n = city_edges.shape[0]
    m, z, num = _empty_partials(h, city_edges)
    if B == 0:
        return m, z, num
    err = kernels.library().gat_group_launch(
        el.data_ptr(), er.data_ptr(), h.data_ptr(), city_edges.data_ptr(),
        B, n, E, H, F, m.data_ptr(), z.data_ptr(), num.data_ptr(),
        dev.index, kernels.stream_of(el))
    kernels.check(err, "gat_group_launch")
    kernels.launches["gat_group"] += 1
    return m, z, num


def gat_group_partials_mxu(el, er, h, city_edges):
    """K4: K2's partials with num as per-head matrix products.  Inputs and
    outputs as `gat_group_partials`.

    CPU tensors take the plain twin; CUDA tensors launch the kernel
    (csrc/gat_group_mxu.cu), or raise (ValueError where a block of one head
    does not fit the device's shared memory: on an H100, n above 2073 at
    F=16, 4841 at F=8 and 1321 at F=32).
    """
    _check_inputs(el, er, h, city_edges)
    dev = _card("gat_group_partials_mxu", el, er, h, city_edges)
    if dev is None:
        return gat_group_partials_mxu_plain(el, er, h, city_edges)
    B, E, H, F = h.shape
    n = city_edges.shape[0]
    m, z, num = _empty_partials(h, city_edges)
    if B == 0:
        return m, z, num
    err = kernels.library().gat_group_mxu_launch(
        el.data_ptr(), er.data_ptr(), h.data_ptr(), city_edges.data_ptr(),
        B, n, E, H, F, m.data_ptr(), z.data_ptr(), num.data_ptr(),
        dev.index, kernels.stream_of(el))
    kernels.check(err, "gat_group_mxu_launch")
    kernels.launches["gat_group_mxu"] += 1
    return m, z, num


def gat_group_partials_chunked(el, er, h, city_edges, gs: int):
    """K3's route: the partials of `gat_group_partials_chunked_plain`, with
    inputs and outputs as `gat_group_partials`.

    They run as the sorted prefix sums of ops/gat_sorted.py, which give K3's
    m bit for bit and its z and num to f32 rounding: CPU tensors take that
    twin, CUDA tensors launch csrc/gat_sorted.cu (counted as
    "gat_group_chunked") or raise.  The chunk gs is checked (>= 1) and kept
    for parity with JAX's src_chunk; like pallas_sep's @gc it changes no
    number.
    """
    if gs < 1:
        raise ValueError(f"gat_group_partials_chunked: chunk gs={gs} must be >= 1")
    return gat_sorted_partials(el, er, h, city_edges, counter="gat_group_chunked")


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
                   n_heads: int, src_chunk: int = 0, mxu: bool = False) -> torch.Tensor:
    """GATConv through the group partials: x (B, E, C_in) -> (B, E, H*F).

    src_chunk dispatches as gat_conv_pallas does: 0 takes `source_chunk`'s
    rule (one-shot K2, or K3 with its gs); > 0 takes K3 with that gs.
    mxu=True takes K4 for the one-shot partials; where the rule picks a
    chunk it warns and takes K3, and an explicit src_chunk > 0 raises
    (pallas_gat.py:229-244): K4 has no chunked form."""
    h, el, er = project(p, x, n_heads)
    city = topo_index(topo, x.device, "city_edges", torch.int32)
    if mxu and src_chunk:
        raise ValueError("mxu=True is incompatible with src_chunk > 0: the per-head "
                         "matmul partials (K4) have no chunked form; pass src_chunk=0 "
                         "or mxu=False")
    gs = src_chunk or source_chunk(topo.n, h.shape[-2] * h.shape[-1])
    if mxu and gs:
        warnings.warn(f"pallas_mxu: n={topo.n} is past the one-shot partials; running "
                      "the source-chunked partials (K3): K4 has no chunked form",
                      stacklevel=2)
    args = (el.contiguous(), er.contiguous(), h.contiguous(), city)
    if gs:
        m, z, num = gat_group_partials_chunked(*args, gs)
    elif mxu:
        m, z, num = gat_group_partials_mxu(*args)
    else:
        m, z, num = gat_group_partials(*args)
    return merge_group_partials(m, z, num, topo)
