"""Build and load the port's CUDA kernels; count their launches.

Every `.cu` file under `csrc/` exposes a plain `extern "C"` launcher that
returns `cudaError_t`.  At the first CUDA use, one `nvcc` call compiles all of
them into one shared library for sm_90a under `build/gnngls_tpu_torch/` (next
to the package), named by a hash of the sources and flags, and `ctypes`
loads it.  No source includes PyTorch's headers, so the build takes seconds.

`-fmad=false` keeps nvcc from contracting a multiply and an add into one FMA:
the whole-GLS kernel must round `D + k*P` exactly as its plain twin does, or
accept decisions flip.  The GAT kernels ask for their FMAs explicitly.

`launches` counts kernel launches by name; a wrapper adds one exactly where it
launches its kernel, so a run can show that it went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("gat_group.cu", "gat_group_mxu.cu", "gat_sorted.cu", "gls_whole.cu", "rank_sums.cu",
           "nearest_neighbor.cu", "gls_perturb.cu")
HEADERS = ("smem.cuh",)
SMEM_EXCEEDED = 9000  # csrc/smem.cuh's kSmemExceeded: a block's shared memory does not fit
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

launches: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    launches.clear()


def build_dir() -> pathlib.Path:
    return CSRC.parent.parent / "build" / "gnngls_tpu_torch"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path(name: str, sources) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in [*sources, *(CSRC / s for s in HEADERS)]:
        h.update(s.read_bytes())
    return build_dir() / f"{name}_{h.hexdigest()[:16]}.so"


def build(sources=None) -> pathlib.Path:
    """Compile the kernels unless this exact build exists; return the path.

    `sources` (paths) default to the package's; another list, such as an
    older version of one kernel's source, builds a library of its own with
    `csrc/` on the include path.  Raises with nvcc's stderr when the build
    fails.  The ptxas report (registers, shared memory, spills) is kept
    beside the library as .log.
    """
    if sources is None:
        name, sources = "libgnngls_kernels", [CSRC / s for s in SOURCES]
    else:
        sources = [pathlib.Path(s) for s in sources]
        name = f"lib{sources[0].stem}"
    out = _library_path(name, sources)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gat_group_launch.argtypes = [P, P, P, P, I, I, I, I, I, P, P, P, I, P]
    lib.gat_group_launch.restype = I
    lib.gat_group_mxu_launch.argtypes = [P, P, P, P, I, I, I, I, I, P, P, P, I, P]
    lib.gat_group_mxu_launch.restype = I
    lib.gat_sorted_launch.argtypes = [P, P, P, P, I, I, I, I, I, I, P, P, P, I, P]
    lib.gat_sorted_launch.restype = I
    lib.gat_sorted_max_n.argtypes = [I, I]
    lib.gat_sorted_max_n.restype = I
    lib.gls_whole_launch.argtypes = [P, P, P, P, I, I, I, I, I, I, P,
                                     P, P, P, P, P, P, I, P]
    lib.gls_whole_launch.restype = I
    lib.gls_whole_max_n.argtypes = []
    lib.gls_whole_max_n.restype = I
    lib.rank_sums_launch.argtypes = [P, P, P, I, I, I, I, I, P, P, I, P]
    lib.rank_sums_launch.restype = I
    L = ctypes.c_int64
    lib.nearest_neighbor_launch.argtypes = [P, L, L, L, I, I, I, I, P, P, I, P]
    lib.nearest_neighbor_launch.restype = I
    lib.nearest_neighbor_workspace_bytes.argtypes = [I, I]
    lib.nearest_neighbor_workspace_bytes.restype = L
    lib.gls_perturb_launch.argtypes = [P, L, L, L, P, L, L, L, P, L, L, L, P, P, P, P, P,
                                       P, I, P, P, P, P, I, I, I, I, I, I, P]
    lib.gls_perturb_launch.restype = I
    lib.gls_perturb_max_n.argtypes = [I]
    lib.gls_perturb_max_n.restype = I
    lib.gls_perturb_workspace_bytes.argtypes = [I, I]
    lib.gls_perturb_workspace_bytes.restype = L
    lib.gnngls_cuda_error_string.argtypes = [I]
    lib.gnngls_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise when a launcher reports a CUDA error (refused or faulted launch):
    ValueError when the shape needs more shared memory than a block may
    have, RuntimeError otherwise."""
    if err == SMEM_EXCEEDED:
        raise ValueError(f"{what}: at this shape a block needs more shared memory than the "
                         "device allows")
    if err != 0:
        msg = library().gnngls_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
