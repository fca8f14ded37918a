"""gnngls_tpu_torch — the PyTorch and CUDA port of gnngls_tpu.

The same GNN-guided local search for the TSP as the JAX package beside it,
written for one NVIDIA H100 (sm_90a).  The main path is the reference's
evaluation pipeline (`cli/test.py` -> `evaluate.evaluate`): an 8-layer GAT
over the K_n line graph predicts per-edge regret, and a fixed-budget Guided
Local Search consumes it.  Its hot spots are CUDA kernels written by hand,
each with a plain PyTorch twin in the same module that runs whenever the
tensors lie on the CPU: the GAT group partials, one-shot
(`csrc/gat_group.cu`) or, for large n, by sorted prefix sums
(`csrc/gat_sorted.cu`), and the whole GLS (`csrc/gls_whole.cu`), whose state
lives in shared memory up to n=138 and in global memory up to n=1024.

Subpackages:
  core     static K_n line-graph topology, feature scalers
  data     instance generation with the GLS oracle, npz datasets with split
           files
  ops      linear, batch norm, GAT (plain paths and the group kernels)
  models   the edge-regret model (nn.Module) and weight conversion
  search   move semantics, nearest neighbour, the whole-GLS kernel and twin
  train    the checkpoint reader
  cli      the reference-compatible test entry point

The package imports torch and numpy only.  Kernels are built with nvcc at
their first CUDA launch (`kernels.py`).
"""

from .utils import is_valid_tour, tour_cost

__version__ = "0.1.0"
