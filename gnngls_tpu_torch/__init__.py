"""gnngls_tpu_torch — the PyTorch and CUDA port of gnngls_tpu.

The same GNN-guided local search for the TSP as the JAX package beside it,
written for one NVIDIA H100 (sm_90a).  The main path is the reference's
evaluation pipeline (`cli/test.py` -> `evaluate.evaluate`): an 8-layer GAT
over the K_n line graph predicts per-edge regret, and a Guided Local Search
consumes it, for 10 s of wall clock (the reference's default) or a fixed
number of iterations.  Its hot spots are CUDA kernels written by hand,
each with a plain PyTorch twin in the same module that runs whenever the
tensors lie on the CPU: the GAT group partials, one-shot
(`csrc/gat_group.cu`) or, for large n, by sorted prefix sums
(`csrc/gat_sorted.cu`), the nearest-neighbour construction of the initial
tours (`csrc/nearest_neighbor.cu`, one launch a batch), and the whole GLS
(`csrc/gls_whole.cu`), whose state lives in shared memory up to n=138 and in
global memory up to n=8192.

Subpackages:
  core     static K_n line-graph topology, feature scalers
  data     instance generation with the GLS oracle, npz datasets with split
           files, the exact solvers and the regret labels
  ops      linear, batch norm, GAT (plain routes, chunked and bf16, and the
           group kernels), the city-sharded and ring GAT, the
           tensor-parallel FFN
  models   the edge-regret model (nn.Module; ring and tensor-parallel
           forwards), weight conversion, reference .pt checkpoints
  search   move semantics, construction (nearest neighbour, probabilistic,
           insertion), the whole-GLS kernel and twin, the per-move engine
           and the fixed-budget and wall-clock runs
  train    steps, the loop, checkpoints
  parallel device meshes over torch.distributed, data-parallel training,
           instance-sharded search, process bring-up
  utils    tour helpers; profiling (torch.profiler traces, named regions)
  cli      the reference-compatible entry points

Modules: evaluate (inference, search, gaps, progress rows, the 10 s
protocol), compat (the reference's API over networkx graphs), stats (paired
bootstrap and sign-flip tests), kernels.

The package imports torch and numpy only (compat imports networkx and
matplotlib inside the function that draws).  Kernels are built with nvcc at
their first CUDA launch (`kernels.py`).
"""

from .utils import is_equivalent_tour, is_valid_tour, tour_cost, tour_to_edge_vector

__version__ = "0.1.0"
