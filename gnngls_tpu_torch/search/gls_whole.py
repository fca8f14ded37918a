"""The whole-GLS CUDA kernel that replaces K1
(gnngls_tpu/search/pallas_gls.py::_gls_kernel), and its wrapper.

`gls_whole` runs the fixed-budget GLS of search/local_search.py for every
instance, one thread block each.  CPU tensors take the plain twin
`gls_fixed_plain`; CUDA tensors launch the kernel (csrc/gls_whole.cu), or the
wrapper raises.  The kernel keeps D, the penalties and the current guide in
shared memory, which bounds n (`max_n()`, 138 on sm_90); past it the wrapper
raises rather than compute some other way.
"""

from __future__ import annotations

import torch

from .. import kernels
from .local_search import GLSOutput, gls_fixed_plain


def max_n() -> int:
    """Largest n whose search state fits one block's shared memory."""
    return kernels.library().gls_whole_max_n()


def _check_inputs(Ds, guides, init_tours, n_iters, perturbation_moves):
    if Ds.dtype != torch.float32 or guides.dtype != torch.float32:
        raise TypeError("gls_whole: Ds and guides must be float32")
    if init_tours.dtype != torch.int32:
        raise TypeError("gls_whole: init_tours must be int32")
    if Ds.dim() != 3 or guides.dim() != 4 or init_tours.dim() != 2:
        raise ValueError("gls_whole: expected Ds (B,n,n), guides (B,G,n,n), "
                         "init_tours (B,n+1)")
    B, n, n2 = Ds.shape
    if n2 != n or guides.shape[0] != B or guides.shape[2:] != (n, n) \
            or init_tours.shape != (B, n + 1) or guides.shape[1] < 1:
        raise ValueError(f"gls_whole: inconsistent shapes Ds {tuple(Ds.shape)}, "
                         f"guides {tuple(guides.shape)}, init_tours {tuple(init_tours.shape)}")
    if n_iters < 0 or perturbation_moves < 0:
        raise ValueError("gls_whole: n_iters and perturbation_moves must be >= 0")


def gls_whole(Ds: torch.Tensor, guides: torch.Tensor, init_tours: torch.Tensor,
              *, n_iters: int, perturbation_moves: int = 20) -> GLSOutput:
    """Ds (B, n, n) f32, guides (B, G, n, n) or (B, n, n) f32, init_tours
    (B, n+1) int32 -> GLSOutput."""
    if guides.dim() == 3:
        guides = guides[:, None]
    _check_inputs(Ds, guides, init_tours, n_iters, perturbation_moves)
    tensors = (Ds, guides, init_tours)
    if all(t.device.type == "cpu" for t in tensors):
        return gls_fixed_plain(Ds, guides, init_tours, n_iters=n_iters,
                               perturbation_moves=perturbation_moves)
    dev = Ds.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("gls_whole: all tensors must be on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gls_whole: tensors must be contiguous")
    B, n, _ = Ds.shape
    if not 3 <= n <= max_n():
        raise ValueError(f"gls_whole: n={n} outside the kernel's range [3, {max_n()}]: "
                         "its state lives in one block's shared memory")
    i32, f32 = torch.int32, torch.float32
    out = GLSOutput(
        best_tours=torch.empty((B, n + 1), dtype=i32, device=dev),
        best_costs=torch.empty((B,), dtype=f32, device=dev),
        moves=torch.empty((B,), dtype=i32, device=dev),
        trace_costs=torch.empty((B, n_iters), dtype=f32, device=dev),
        trace_moves=torch.empty((B, n_iters), dtype=i32, device=dev),
        work=torch.empty((B, 2), dtype=i32, device=dev))
    if B == 0:
        return out
    err = kernels.library().gls_whole_launch(
        Ds.data_ptr(), guides.data_ptr(), init_tours.data_ptr(), B, n,
        guides.shape[1], n_iters, perturbation_moves,
        *[t.data_ptr() for t in out], dev.index, kernels.stream_of(Ds))
    kernels.check(err, "gls_whole_launch")
    kernels.launches["gls_whole"] += 1
    return out
