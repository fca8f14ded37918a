"""The whole-GLS CUDA kernel that replaces K1
(gnngls_tpu/search/pallas_gls.py::_gls_kernel), and its wrapper.

`gls_whole` runs the fixed-budget GLS of search/local_search.py for every
instance, one thread block of 1024 threads each.  CPU tensors take the plain twin
`gls_fixed_plain`; CUDA tensors launch the kernel (csrc/gls_whole.cu), or the
wrapper raises.  The kernel has two state layouts, one body:

* "shared": D, the penalties and the current guide in one block's shared
  memory, for n <= `max_n()` (138 on sm_90);
* "global": D and the guides read in place from global memory, the penalties
  and a transposed copy of D in a (B, 2, n, n) workspace that the wrapper
  allocates zeroed for each launch, for n <= `MAX_N` (8192: the block keeps
  only its tour state in shared memory, and its threads stride over tour
  positions and candidate moves, so n may pass the block's 1024 threads).

"auto" takes the shared layout where it fits.  Both layouts give the same
bits.  Past `MAX_N` the wrapper raises rather than compute some other way.
"""

from __future__ import annotations

import torch

from .. import kernels
from .local_search import GLSOutput, gls_fixed_plain

MAX_N = 8192  # the global layout's range; csrc/gls_whole.cu's kMaxN
LAYOUTS = {"shared": 0, "global": 1}


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
              *, n_iters: int, perturbation_moves: int = 20, k=None,
              layout: str = "auto") -> GLSOutput:
    """Ds (B, n, n) f32, guides (B, G, n, n) or (B, n, n) f32, init_tours
    (B, n+1) int32 -> GLSOutput.  k: None (each instance's penalty scale is
    0.1 * its initial tour's cost on Ds / n) or a (B,) f32 tensor of scales
    on the same device.  `layout` ("auto", "shared", "global") picks the
    kernel's state layout; the plain twin ignores it."""
    if guides.dim() == 3:
        guides = guides[:, None]
    _check_inputs(Ds, guides, init_tours, n_iters, perturbation_moves)
    if layout not in ("auto", *LAYOUTS):
        raise ValueError(f"gls_whole: unknown layout {layout!r}")
    tensors = (Ds, guides, init_tours)
    if k is not None:
        if k.dtype != torch.float32 or k.shape != (Ds.shape[0],):
            raise ValueError(f"gls_whole: k must be a ({Ds.shape[0]},) float32 tensor, got "
                             f"{k.dtype} {tuple(k.shape)}")
        tensors += (k,)
    if all(t.device.type == "cpu" for t in tensors):
        return gls_fixed_plain(Ds, guides, init_tours, n_iters=n_iters,
                               perturbation_moves=perturbation_moves, k=k)
    dev = Ds.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("gls_whole: all tensors must be on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gls_whole: tensors must be contiguous")
    B, n, _ = Ds.shape
    if layout == "auto":
        layout = "shared" if n <= max_n() else "global"
    top = max_n() if layout == "shared" else MAX_N
    if not 3 <= n <= top:
        raise ValueError(f"gls_whole: n={n} outside the {layout} layout's range [3, {top}]")
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
    workspace = None
    if layout == "global":  # zeroed for each launch: the search starts from P = 0
        workspace = torch.zeros((B, 2, n, n), dtype=f32, device=dev)
    err = kernels.library().gls_whole_launch(
        Ds.data_ptr(), guides.data_ptr(), init_tours.data_ptr(),
        None if k is None else k.data_ptr(), B, n,
        guides.shape[1], n_iters, perturbation_moves, LAYOUTS[layout],
        None if workspace is None else workspace.data_ptr(),
        *[t.data_ptr() for t in out], dev.index, kernels.stream_of(Ds))
    kernels.check(err, "gls_whole_launch")
    kernels.launches["gls_whole"] += 1
    return out
