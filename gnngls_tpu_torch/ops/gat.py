"""GAT over the K_n line graph: projection and the plain reference paths.

DGL 0.6.1 GATConv math as gnngls_tpu/ops/gat.py has it: a shared projection
without bias, score leaky(el[src] + er[dst], 0.2), softmax over the
destination's line-graph neighbours (never itself), weighted feature sum.

* `gat_conv_naive` gathers the explicit (E, 2(n-2)) neighbour lists.
* `gat_conv` is the dense city-group form: per city u, scores of the
  (n-1) x (n-1) group S_u with the self pair masked, stabilised by the max
  over both groups of each destination.  fast=True is the `bf16` route:
  the attention weights p and the features are rounded to bf16 before the
  aggregation, which sums in f32 (`to_bf16`).
* `gat_conv_chunked` is the `chunked` route for large n: the groups in
  chunks of cities, each with its own max (flash partials), merged per
  edge, so the score tensor never exceeds one chunk.
The main path runs `ops.gat_group.gat_conv_group` instead (the CUDA kernel).
The checks of the group partials' inputs, shared by their kernels'
wrappers, sit at the end.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from ..core.graph import LineGraphTopology

LEAKY_SLOPE = 0.2
KERNEL_F = (8, 16, 32)  # head widths the group-partials kernels are instantiated for


class GATParams(NamedTuple):
    fc_w: torch.Tensor  # (C_in, H*F)
    attn_l: torch.Tensor  # (H, F)
    attn_r: torch.Tensor  # (H, F)


def init_gat_params(c_in: int, n_heads: int, head_dim: int,
                    generator: Optional[torch.Generator] = None) -> GATParams:
    """DGL GATConv's initialisation, as gnngls_tpu/ops/gat.py draws it:
    Xavier-normal with gain sqrt(2), std = gain * sqrt(2 / (fan_in + fan_out)),
    with fans (c_in, H*F) for fc_w and (F, F) for attn_l and attn_r."""
    def xavier_normal(shape, fan_in, fan_out):
        std = math.sqrt(2.0) * math.sqrt(2.0 / (fan_in + fan_out))
        return std * torch.randn(shape, generator=generator)

    hf = n_heads * head_dim
    return GATParams(xavier_normal((c_in, hf), c_in, hf),
                     xavier_normal((n_heads, head_dim), head_dim, head_dim),
                     xavier_normal((n_heads, head_dim), head_dim, head_dim))


def leaky(s: torch.Tensor) -> torch.Tensor:
    return torch.where(s > 0, s, LEAKY_SLOPE * s)


def to_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 and held in x's dtype.

    gnngls_tpu's bf16 routes cast operands to bf16 and contract them with
    f32 accumulation (preferred_element_type=f32).  A torch product of bf16
    operands returns bf16, which would round the sum too; products of
    bf16 values are exact in f32, so the port contracts these values in
    f32 (TF32 stays off: `exact_f32_matmuls`).  Under autograd the casts'
    backward rounds the cotangent to bf16 where JAX's transpose of the
    contraction does (its result is cast to the bf16 operand's dtype)."""
    return x.to(torch.bfloat16).to(x.dtype)


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
             n_heads: int, fast: bool = False) -> torch.Tensor:
    """x (..., E, C_in) -> (..., E, H*F).  fast=True rounds p and the
    features to bf16 before the aggregation; the projection stays f32 (as
    JAX's DEFAULT precision is on the CPU)."""
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
    if fast:
        p_, h_c = to_bf16(p_), to_bf16(h_c)
    num_g = torch.einsum("...uijh,...ujhf->...uihf", p_, h_c)
    z_flat = z_g.reshape(z_g.shape[:-3] + (n * (n - 1),) + z_g.shape[-1:])
    num_flat = num_g.reshape(num_g.shape[:-4] + (n * (n - 1),) + num_g.shape[-2:])
    z = z_flat[..., su, :] + z_flat[..., sv, :]
    num = num_flat[..., su, :, :] + num_flat[..., sv, :, :]
    out = num / z[..., None]
    return out.reshape(out.shape[:-2] + (-1,))


def gat_conv_chunked(p: GATParams, topo: LineGraphTopology, x: torch.Tensor,
                     n_heads: int, city_chunk: int = 16) -> torch.Tensor:
    """x (..., E, C_in) -> (..., E, H*F), the city groups `city_chunk` at a
    time (the largest divisor of n not above it when it does not divide n).
    Each chunk gives the groups' flash partials: own max m over the sources
    (the self pair masked), z and num offset by it; the two groups of each
    edge are merged by max-rescaling.  Peak score memory is city_chunk / n of
    `gat_conv`'s; autograd keeps each chunk's scores for the backward."""
    from .gat_group import merge_group_partials

    n = topo.n
    if n % city_chunk:
        city_chunk = max(c for c in range(1, city_chunk + 1) if n % c == 0)
    lead = x.shape[:-2]
    h, el, er = project(p, x.reshape((-1,) + x.shape[-2:]), n_heads)
    city = topo_index(topo, x.device, "city_edges")
    eye = torch.eye(n - 1, dtype=torch.bool, device=x.device)[:, :, None]
    parts = []
    for c0 in range(0, n, city_chunk):
        ce = city[c0:c0 + city_chunk]
        s = leaky(el[:, ce][:, :, None] + er[:, ce][:, :, :, None])  # (B, chunk, tgt, src, H)
        s = s.masked_fill(eye, float("-inf"))
        m = s.amax(dim=-2)
        p_ = torch.exp(s - m[..., None, :])
        parts.append((m, p_.sum(dim=-2), torch.einsum("buijh,bujhf->buihf", p_, h[:, ce])))
    m, z, num = (torch.cat(t, dim=1) for t in zip(*parts))
    out = merge_group_partials(m, z, num, topo)
    return out.reshape(lead + out.shape[-2:])


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


def _card(what, el, er, h, city_edges):
    """None when every tensor lies on the CPU (the plain twin runs), else the
    one CUDA device they all lie on; raises otherwise or on a head width the
    kernels are not built for."""
    tensors = (el, er, h, city_edges)
    if all(t.device.type == "cpu" for t in tensors):
        return None
    dev = el.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: all tensors must be on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: tensors must be contiguous")
    if h.shape[3] not in KERNEL_F:
        raise ValueError(f"{what}: head width F={h.shape[3]} not in {KERNEL_F}")
    return dev


def _empty_partials(h, city_edges):
    """Uninitialised m, z (B, n, g, H) and num (B, n, g, H, F) on h's device."""
    B, _, H, F = h.shape
    n, g = city_edges.shape
    m = torch.empty((B, n, g, H), device=h.device, dtype=torch.float32)
    num = torch.empty((B, n, g, H, F), device=h.device, dtype=torch.float32)
    return m, torch.empty_like(m), num
