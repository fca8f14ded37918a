"""ctypes bindings for the native C++ label oracle (gnngls_tpu/data/native_oracle.py).

The source is the port's own copy, `csrc/tsp_oracle.cc`: host code (exact
Held-Karp, big-M forced edges, nearest neighbour plus 2-opt/relocate descent),
not a GPU kernel.  One g++ call builds it at first use into
`build/gnngls_tpu_torch/`, named by a hash of the source and flags, and
ctypes loads it.  The flags are those of the JAX package's `native/build.sh`
without `-march=native`, and the library that package ships is never loaded.
The C calls release the GIL, so `regret_costs_batch` threads across
instances.  `available()` is False when the build fails, and the callers then
choose another oracle, as gnngls_tpu's do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np

from ..kernels import build_dir

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "tsp_oracle.cc"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lib = None


def _library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return build_dir() / f"libtsp_oracle_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> bool:
    """Compile the library unless this exact build exists.  Returns availability."""
    out = _library_path()
    if out.exists() and not force:
        return True
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                       capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False
    os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    return True


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not build():
        raise RuntimeError("native oracle unavailable (build failed)")
    lib = ctypes.CDLL(str(_library_path()))
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int32)
    lib.tsp_held_karp.restype = ctypes.c_double
    lib.tsp_held_karp.argtypes = [ctypes.c_int, dp, ip]
    lib.tsp_held_karp_fixed_edge.restype = ctypes.c_double
    lib.tsp_held_karp_fixed_edge.argtypes = [ctypes.c_int, dp, ctypes.c_int,
                                             ctypes.c_int, ip]
    lib.tsp_local_search.restype = ctypes.c_double
    lib.tsp_local_search.argtypes = [ctypes.c_int, dp, ip]
    lib.tsp_regret_costs.restype = ctypes.c_double
    lib.tsp_regret_costs.argtypes = [ctypes.c_int, dp, ctypes.c_int, dp]
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except RuntimeError:
        return False


def _as_c(D: np.ndarray):
    D = np.ascontiguousarray(D, dtype=np.float64)
    return D, D.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _tour_buffer(n: int):
    tour = np.zeros(n + 1, dtype=np.int32)
    return tour, tour.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def held_karp(D: np.ndarray) -> Tuple[np.ndarray, float]:
    """Exact optimal closed tour from city 0 and its cost."""
    lib = _load()
    D, dp = _as_c(D)
    tour, tp = _tour_buffer(D.shape[0])
    return tour, float(lib.tsp_held_karp(D.shape[0], dp, tp))


def held_karp_fixed_edge(D: np.ndarray, u: int, v: int) -> Tuple[np.ndarray, float]:
    """Exact optimal tour through edge (u, v) (big-M reduction) and its cost."""
    lib = _load()
    D, dp = _as_c(D)
    tour, tp = _tour_buffer(D.shape[0])
    return tour, float(lib.tsp_held_karp_fixed_edge(D.shape[0], dp, u, v, tp))


def local_search(D: np.ndarray) -> Tuple[np.ndarray, float]:
    """Nearest neighbour from city 0, then 2-opt/relocate descent."""
    lib = _load()
    D, dp = _as_c(D)
    tour, tp = _tour_buffer(D.shape[0])
    return tour, float(lib.tsp_local_search(D.shape[0], dp, tp))


def regret_costs(D: np.ndarray, max_exact_n: int = 16) -> Tuple[np.ndarray, float]:
    """Forced-edge costs for all E edges of one instance, and the base cost:
    exact for n <= max_exact_n, else big-M plus local search."""
    lib = _load()
    n = D.shape[0]
    D, dp = _as_c(D)
    costs = np.zeros(n * (n - 1) // 2, dtype=np.float64)
    base = lib.tsp_regret_costs(n, dp, max_exact_n,
                                costs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return costs, float(base)


def regret_costs_batch(Ds: np.ndarray, max_exact_n: int = 16,
                       workers: Optional[int] = None) -> np.ndarray:
    """(B, n, n) -> (B, E) forced-edge costs, threaded across instances."""
    _load()
    with ThreadPoolExecutor(max_workers=workers) as ex:
        outs = list(ex.map(lambda D: regret_costs(D, max_exact_n)[0], Ds))
    return np.stack(outs)
