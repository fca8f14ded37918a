"""Model inference and GLS evaluation (gnngls_tpu/evaluate.py; reference
scripts/test.py).

  1. predict scaled regret for every edge, inverse-transform, clamp at 0;
  2. initial tours: nearest neighbour on 'regret_pred' (on D without a model);
  3. fixed-budget GLS on the whole-search kernel;
  4. gap = (best_cost / opt_cost - 1) * 100, and search-progress rows.

Everything runs on `device`, "cuda" unless the caller asks for "cpu"; without
a card and without device="cpu" the entry points raise.  On the CPU the
kernels' plain twins run.  The JAX package's TPU routing (the n >= 50 engine
cutoff) does not apply: the kernel engine runs for every n.
"""

from __future__ import annotations

import datetime
import pathlib
import time
import uuid
from typing import List, Optional

import numpy as np
import torch

from .core.graph import edge_vector_to_matrix
from .data.dataset import TSPDataset
from .data.generate import coords_to_distance_matrix
from .models.regret_gat import RegretGNN, exact_f32_matmuls
from .search import batched


def resolve_device(device=None) -> torch.device:
    """"cuda" by default; raise when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to "
                           "run the plain PyTorch twins on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@torch.no_grad()
def predict_regret(model: RegretGNN, dataset: TSPDataset, *, batch_size: int = 64,
                   device=None, gat_impl: str = "auto") -> np.ndarray:
    """Unscaled, non-negative per-edge regret predictions, (N, E).  gat_impl
    names the GATConv route (`models.regret_gat.gat_conv_for`)."""
    dev = resolve_device(device)
    exact_f32_matmuls()
    model = model.to(dev).eval()
    outs = []
    for s in range(0, len(dataset), batch_size):
        idx = np.arange(s, min(s + batch_size, len(dataset)))
        x = torch.as_tensor(dataset.get_scaled_batch(idx)["features"], device=dev)
        outs.append(model(x, gat_impl=gat_impl)[..., 0].cpu().numpy())
    y_scaled = np.concatenate(outs, axis=0)
    y = dataset.scalers["regret"].inverse_transform(y_scaled[..., None])[..., 0]
    return np.maximum(y, 0.0)


def evaluate(dataset: TSPDataset, *, model: Optional[RegretGNN] = None,
             guides: List[str] = ("regret_pred",),
             time_limit: Optional[float] = None,
             n_iters: Optional[int] = None,
             perturbation_moves: int = 20,
             first_improvement: bool = False,
             batch_size: int = 64,
             device=None) -> dict:
    """Evaluate GLS, guided by the model's predictions when 'regret_pred' is
    among `guides` (cycled per outer iteration).  Needs a fixed `n_iters`."""
    if n_iters is None:
        raise NotImplementedError(
            f"time_limit={time_limit}: the wall-clock mode waits for a later "
            "slice of the port; pass a fixed n_iters")
    if first_improvement:
        raise NotImplementedError("first-improvement search waits for a later "
                                  "slice of the port")
    dev = resolve_device(device)
    guides = list(guides)
    n = dataset.n_nodes
    Ds = coords_to_distance_matrix(dataset.coords).astype(np.float32)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.time()
    regret_mats = None
    if "regret_pred" in guides:
        if model is None:
            raise ValueError("guide 'regret_pred' needs a model")
        preds = predict_regret(model, dataset, batch_size=batch_size, device=dev)
        regret_mats = edge_vector_to_matrix(preds.astype(np.float32), n)
        init_guide = regret_mats
    else:
        init_guide = Ds
    t1 = time.time()

    init_tours = batched.nearest_neighbor_batch(
        torch.as_tensor(init_guide, device=dev)).cpu().numpy()
    guide_stack = batched.make_guide_stack(Ds, guides, regret_mats)
    result = batched.run_fixed_kernel(Ds, guide_stack, init_tours, n_iters=n_iters,
                                      perturbation_moves=perturbation_moves,
                                      device=dev)
    t2 = time.time()

    opt = np.asarray(dataset.opt_cost, dtype=np.float64)
    gaps = (result.best_costs / opt - 1.0) * 100.0
    init_costs = Ds[np.arange(len(dataset))[:, None],
                    init_tours[:, :-1], init_tours[:, 1:]].sum(-1)
    return {
        "gaps": gaps,
        "mean_gap": float(gaps.mean()),
        "best_costs": result.best_costs,
        "best_tours": result.best_tours,
        "trace_mode": "per-iteration",
        "engine": "kernel" if dev.type == "cuda" else "plain",
        "device": str(dev),
        "init_costs": init_costs,
        "init_tours": init_tours,
        "guide_stack": guide_stack,
        "opt_costs": opt,
        "moves": result.chunk_moves[:, -1],
        "timings": {"inference_s": t1 - t0,
                    "search_s": result.chunk_times[1] - result.chunk_times[0],
                    "total_s": t2 - t0,
                    # torch.cuda.max_memory_allocated over the call; None on the CPU
                    "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                                          if dev.type == "cuda" else None)},
        "result": result,
    }


def search_on_predictions(preds: np.ndarray, coords: np.ndarray, *, n_iters: int,
                          perturbation_moves: int = 20, device=None):
    """The search on given regret predictions, (N, E), as
    benchmarks/tsp500_e2e.py runs it: nearest neighbour on the regret
    matrix, then the whole-GLS kernel with that matrix as the only guide.
    Returns the search's result and its seconds (the kernel's synchronised
    window)."""
    dev = resolve_device(device)
    R = edge_vector_to_matrix(preds.astype(np.float32), coords.shape[1])
    inits = batched.nearest_neighbor_batch(torch.as_tensor(R, device=dev)).cpu().numpy()
    res = batched.run_fixed_kernel(coords_to_distance_matrix(coords), R[:, None], inits,
                                   n_iters=n_iters, perturbation_moves=perturbation_moves,
                                   device=dev)
    return res, res.chunk_times[1] - res.chunk_times[0]


def search_progress_records(dataset: TSPDataset, out: dict,
                            instance_names: Optional[List[str]] = None) -> list:
    """Reference-format search-progress rows {instance, time, cost, opt_cost}:
    one per outer iteration, timestamps interpolated by cumulative moves
    across the launch window."""
    res: batched.BatchResult = out["result"]
    names = instance_names or [f"instance_{i}" for i in range(len(dataset))]
    t0, t1 = res.chunk_times[0], res.chunk_times[-1]
    rows = []
    for b in range(len(dataset)):
        total = max(int(res.chunk_moves[b, -1]), 1)
        for m in range(int(res.trace_n[b])):
            frac = int(res.trace_moves[b, m]) / total
            rows.append({
                "instance": names[b],
                "time": t0 + frac * (t1 - t0),
                "cost": float(res.trace_costs[b, m]),
                "opt_cost": float(out["opt_costs"][b]),
            })
    return rows


def write_run_dataframe(rows: list, run_dir) -> pathlib.Path:
    """The reference's pickled DataFrame: cummin best_cost, gap, dt."""
    import pandas as pd

    run_dir = pathlib.Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    df = pd.DataFrame.from_records(rows)
    if len(df):
        df["best_cost"] = df.groupby("instance")["cost"].cummin()
        df["gap"] = (df["best_cost"] / df["opt_cost"] - 1) * 100
        df["dt"] = df["time"] - df.groupby("instance")["time"].transform("min")
    timestamp = datetime.datetime.now().strftime("%b%d_%H-%M-%S")
    path = run_dir / f"{timestamp}_{uuid.uuid4().hex}.pkl"
    df.to_pickle(path)
    return path
