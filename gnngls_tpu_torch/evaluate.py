"""Model inference and GLS evaluation (gnngls_tpu/evaluate.py; reference
scripts/test.py).

  1. predict scaled regret for every edge, inverse-transform, clamp at 0;
  2. initial tours: nearest neighbour on 'regret_pred' (on D without a model);
  3. GLS under a wall-clock budget (the default, 10 s for the whole batch) or
     a fixed number of outer iterations, on one of two engines:
     "pallas", the whole-search kernel (its plain twin on the CPU), or
     "xla", the per-move engine (search/local_search.py);
  4. gap = (best_cost / opt_cost - 1) * 100, and search-progress rows.

Everything runs on `device`, "cuda" unless the caller asks for "cpu"; without
a card and without device="cpu" the entry points raise.  `evaluate` builds
the distance matrices there, the bits of `coords_to_distance_matrix`, and
keeps them there for the GAT's input features, the construction, the search
and the tour costs.  On the CPU the kernels' plain twins run.  The engine
names are gnngls_tpu's.
"auto" takes the whole-search engine wherever it can run (a fixed budget,
best-improvement, n within its range), on the card and on the CPU alike; the
JAX package's TPU-only routing (the n >= 50 cutoff) does not apply.

Two models guide the search: the edge-regret GAT (`RegretGNN`, through
`predict_regret`: scaled regret per edge, placed into (n, n) matrices) and
the residual gated GCN (`GatedGCN`, through `predict_edge_guide`: (n, n)
guides from its edge probabilities, computed on the device from the
distance matrices).  `evaluate` dispatches on the model's type; either
model's matrices are the "regret_pred" guide.

Each step of `evaluate`, `predict_regret` and `predict_edge_guide` is a
named span ("gnngls.*", utils/profiling.py lists the tree), which a profiler
records and the benchmark reads.
"""

from __future__ import annotations

import datetime
import pathlib
import time
import uuid
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .core.graph import edge_vector_to_matrix
from .data.dataset import TSPDataset, scaled_edge_features
from .data.generate import coords_to_distance_matrix, coords_to_distance_tensor
from .models.gated_gcn import GatedGCN, edge_guide, knn_tags
from .models.regret_gat import RegretGNN, exact_f32_matmuls
from .search import batched, gls_whole
from .utils.profiling import annotate

ENGINES = ("auto", "pallas", "xla")


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
@annotate("gnngls.predict")
def predict_regret(model: RegretGNN, dataset: TSPDataset, *, batch_size: int = 64,
                   device=None, gat_impl: str = "auto", distances=None,
                   counts: Optional[dict] = None) -> np.ndarray:
    """Unscaled, non-negative per-edge regret predictions, (N, E).  gat_impl
    names the GATConv route (`models.regret_gat.gat_conv_for`).

    Where the dataset's features are its edge weights and no column is
    dropped, each batch's scaled features are formed on `device` from the
    (N, n, n) distance matrices `distances` (a tensor there, as `evaluate`
    holds them; built there a batch at a time when None), with the bits that
    `get_scaled_batch` gives; else the host scales them and they are copied
    up.  `counts`, when given, gets "host_feature_batches": the batches whose
    features came from the host."""
    dev = resolve_device(device)
    model = model.to(dev).eval()
    on_device = dataset.features_are_edge_weights and not dataset.feat_drop_idx
    host_batches = 0
    outs = []
    with exact_f32_matmuls():
        for s in range(0, len(dataset), batch_size):
            idx = np.arange(s, min(s + batch_size, len(dataset)))
            if on_device:
                with annotate("gnngls.predict.features"):
                    D = (coords_to_distance_tensor(dataset.coords[idx], dev) if distances is None
                         else distances[s:s + len(idx)])
                    x = scaled_edge_features(D, dataset.scalers["features"])
            else:
                x = dataset.get_scaled_batch(idx)["features"]
                host_batches += 1
            with annotate("gnngls.predict.forward"):
                y = model(torch.as_tensor(x, device=dev), gat_impl=gat_impl)[..., 0]
            with annotate("gnngls.predict.fetch"):
                outs.append(y.cpu().numpy())
    if counts is not None:
        counts["host_feature_batches"] = host_batches
    with annotate("gnngls.predict.unscale"):
        y_scaled = np.concatenate(outs, axis=0)
        y = dataset.scalers["regret"].inverse_transform(y_scaled[..., None])[..., 0]
        return np.maximum(y, 0.0)


@torch.no_grad()
@annotate("gnngls.predict")
def predict_edge_guide(model: GatedGCN, dataset: TSPDataset, Ds: torch.Tensor, *,
                       batch_size: int = 64, device=None) -> np.ndarray:
    """The gated GCN's (N, n, n) float32 guides, 1 - (p + p^T) / 2 with 0 on
    the diagonal (`gated_gcn.edge_guide`), from the coordinates and the
    (N, n, n) distance matrices Ds.  The k-NN tags are formed from Ds on
    `device` and the forward runs `batch_size` instances at a time: its
    BatchNorm's statistics are each batch's own."""
    dev = resolve_device(device)
    model = model.to(dev).eval()
    outs = []
    with exact_f32_matmuls():
        for s in range(0, len(dataset), batch_size):
            with annotate("gnngls.predict.inputs"):
                D = torch.as_tensor(Ds[s:s + batch_size], device=dev)
                coords = torch.as_tensor(dataset.coords[s:s + batch_size], device=dev)
                tags = knn_tags(D, model.cfg.num_neighbors)
            with annotate("gnngls.predict.forward"):
                logits = model(coords, D, tags)
            with annotate("gnngls.predict.guide"):
                guide = edge_guide(logits)
            with annotate("gnngls.predict.fetch"):
                outs.append(guide.cpu().numpy())
    return np.concatenate(outs, axis=0)


@annotate("gnngls.evaluate")
def evaluate(dataset: TSPDataset, *, model: Union[RegretGNN, GatedGCN, None] = None,
             guides: List[str] = ("regret_pred",),
             time_limit: Optional[float] = 10.0,
             n_iters: Optional[int] = None,
             perturbation_moves: int = 20,
             first_improvement: bool = False,
             batch_size: int = 64,
             engine: str = "auto",
             device=None) -> dict:
    """Evaluate GLS, guided by the model's predictions when 'regret_pred' is
    among `guides` (cycled per outer iteration): the GAT's regret matrices,
    or the gated GCN's guides.

    The budget is `n_iters` outer iterations when given, else `time_limit`
    seconds of wall clock for the whole batch (one deadline, as in
    gnngls_tpu; the reference gives each instance its own 10 s).

    engine: "pallas" (the whole-search kernel: a fixed n_iters,
    best-improvement, one trace row per outer iteration), "xla" (the
    per-move engine: wall clock or n_iters, first-improvement, one trace row
    per accepted move), or "auto" ("pallas" when n_iters is set,
    first_improvement is off and n <= gls_whole.MAX_N, else "xla").
    "pallas" without n_iters or with first_improvement raises ValueError.

    `timings` holds inference_s (predictions and their matrices), search_s
    (the search's chunk stamps), total_s (the whole call), predict_batches
    (the model's forwards as they ran, each one batch of `batch_size`
    instances; 0 without a model), the peak device memory and, from the per-move engine,
    search_rounds: the lock-step rounds the batch ran (local search,
    perturbation); None from the kernel;
    d_host_copies: the whole distance tensors that crossed between host and
    device (1 where a "weight" guide brings D to the host, else 0);
    host_feature_batches: the GAT's batches whose features the host scaled
    and copied up (0 where `predict_regret` forms them from D on the device,
    `predict_batches` for a dataset with features of its own or dropped
    columns, 0 for the gated GCN and without a model).
    """
    t_start = time.time()
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    if n_iters is None and time_limit is None:
        raise ValueError("set time_limit or n_iters")
    if engine == "pallas" and n_iters is None:
        raise ValueError("engine='pallas' needs a fixed n_iters budget "
                         "(the kernel has no wall-clock chunking)")
    if engine == "pallas" and first_improvement:
        raise ValueError("engine='pallas' has no first-improvement mode; use engine='xla'")
    dev = resolve_device(device)
    guides = list(guides)
    n = dataset.n_nodes
    use_kernel = engine == "pallas" or (engine == "auto" and n_iters is not None
                                        and not first_improvement and n <= gls_whole.MAX_N)
    with annotate("gnngls.evaluate.distances"):
        Ds = coords_to_distance_tensor(dataset.coords, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.time()
    regret_mats = None
    forwards = []  # one entry per call of the model, each one batch
    counts = {"host_feature_batches": 0}
    if "regret_pred" in guides:
        if model is None:
            raise ValueError("guide 'regret_pred' needs a model")
        counter = model.register_forward_pre_hook(lambda *_: forwards.append(1))
        try:
            if isinstance(model, GatedGCN):
                regret_mats = predict_edge_guide(model, dataset, Ds, batch_size=batch_size,
                                                 device=dev)
            else:
                preds = predict_regret(model, dataset, batch_size=batch_size, device=dev,
                                       distances=Ds, counts=counts)
                with annotate("gnngls.evaluate.to_matrix"):
                    regret_mats = edge_vector_to_matrix(preds.astype(np.float32), n)
        finally:
            counter.remove()
        init_guide = regret_mats
    else:
        init_guide = Ds
    t1 = time.time()

    with annotate("gnngls.construct"):
        init_t = batched.nearest_neighbor_batch(torch.as_tensor(init_guide, device=dev))
        init_tours = init_t.cpu().numpy()
    with annotate("gnngls.evaluate.guide_stack"):
        # the guide stack stays on the host; only a "weight" guide fetches D
        D_host = Ds.cpu().numpy() if "weight" in guides else None
        guide_stack = batched.make_guide_stack(D_host, guides, regret_mats)
    search = dict(perturbation_moves=perturbation_moves, device=dev)
    if use_kernel:
        result = batched.run_fixed_kernel(Ds, guide_stack, init_tours, n_iters=n_iters,
                                          **search)
    elif n_iters is not None:
        result = batched.run_fixed(Ds, guide_stack, init_tours, n_iters=n_iters,
                                   first_improvement=first_improvement, **search)
    else:
        result = batched.run_wall_clock(Ds, guide_stack, init_tours, time_limit_s=time_limit,
                                        first_improvement=first_improvement, **search)

    with annotate("gnngls.evaluate.finish"):
        opt = np.asarray(dataset.opt_cost, dtype=np.float64)
        gaps = (result.best_costs / opt - 1.0) * 100.0
        init_costs = batched.edge_lengths(Ds, init_t).sum(-1)
        return {
            "gaps": gaps,
            "mean_gap": float(gaps.mean()),
            "best_costs": result.best_costs,
            "best_tours": result.best_tours,
            # the kernel traces once per outer iteration, the per-move engine per move
            "trace_mode": "per-iteration" if use_kernel else "per-move",
            "engine": "pallas" if use_kernel else "xla",  # the engine that ran
            "device": str(dev),
            "init_costs": init_costs,
            "init_tours": init_tours,
            "guide_stack": guide_stack,
            "opt_costs": opt,
            "moves": result.chunk_moves[:, -1],
            "timings": {"inference_s": t1 - t0,
                        "search_s": result.chunk_times[-1] - result.chunk_times[0],
                        "total_s": time.time() - t_start,
                        "predict_batches": len(forwards),
                        # torch.cuda.max_memory_allocated over the call; None on the CPU
                        "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                                              if dev.type == "cuda" else None),
                        "search_rounds": result.rounds,
                        "d_host_copies": int(D_host is not None),
                        "host_feature_batches": counts["host_feature_batches"]},
            "result": result,
        }


# Accepted moves an instance makes under the reference's 10 s/instance
# protocol (scripts/test.py), as gnngls_tpu/evaluate.py records them: the
# reference's single-thread Python GLS run verbatim on the host where
# gnngls_tpu was built (BASELINE.md), weight-guided, 20 perturbation moves,
# best-improvement, mean over 3 seeds of uniform instances.
REFERENCE_10S_MOVES = {20: 32717.0, 50: 7322.0, 100: 1605.0}


def calibrate_protocol_iters(dataset: TSPDataset, *, target_moves: float,
                             probe_budgets: Tuple[int, int] = (5, 25),
                             max_iters: int = 2000, verify: bool = True,
                             **eval_kw) -> int:
    """A fixed n_iters whose mean accepted moves an instance reaches
    `target_moves` on `dataset` (gnngls_tpu's calibration, step for step).

    Two probes measure mean moves against n_iters.  A target below the
    first probe returns it; one between the probes interpolates and, with
    `verify`, re-measures (else returns the second probe); one above them
    extrapolates linearly and, with `verify`, bumps the budget by x1.6 steps
    until the measured mean meets the target or `max_iters` is reached.  A
    search that saturates below the target returns `max_iters`.  `eval_kw`
    goes to `evaluate` (guides, device, engine, ...)."""
    measured = {}

    def mean_moves(b: int) -> float:
        if b not in measured:
            out = evaluate(dataset, n_iters=b, **eval_kw)
            measured[b] = float(np.mean(out["result"].chunk_moves[:, -1]))
        return measured[b]

    b0, b1 = probe_budgets
    if mean_moves(b0) >= target_moves:
        return b0
    if mean_moves(b1) >= target_moves:
        frac = (target_moves - measured[b0]) / (measured[b1] - measured[b0])
        need = int(np.ceil(b0 + frac * (b1 - b0)))
        need = max(b0 + 1, min(need, b1))
        if not verify or mean_moves(need) >= target_moves:
            return need
        return b1
    slope = (measured[b1] - measured[b0]) / (b1 - b0)
    if slope <= 0:
        return max_iters
    need = int(np.ceil(b0 + (target_moves - measured[b0]) / slope))
    need = int(max(b1 + 1, min(need, max_iters)))
    if not verify:
        return need
    b = need
    for _ in range(8):
        if mean_moves(b) >= target_moves or b >= max_iters:
            break
        b = min(max_iters, max(b + 1, int(np.ceil(b * 1.6))))
    return b


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
    """Reference-format search-progress rows {instance, time, cost, opt_cost},
    one per trace row (gnngls_tpu's general form).

    A trace row's cumulative move count is its index + 1 for per-move traces
    and `trace_moves` for per-iteration ones; its time interpolates by that
    count within the chunk it fell in.  Warns when a per-move trace
    saturated (moves past its cap overwrote the last row)."""
    res: batched.BatchResult = out["result"]
    names = instance_names or [f"instance_{i}" for i in range(len(dataset))]
    times = np.asarray(res.chunk_times, dtype=np.float64)
    cap = res.trace_costs.shape[1]
    n_over = int(np.sum(np.asarray(res.trace_n) > cap))
    if n_over:
        import warnings
        warnings.warn(
            f"search trace buffer saturated for {n_over} instance(s) (cap={cap}): moves "
            "beyond the cap overwrote the last slot and the progress DataFrame "
            "under-reports them; raise trace_cap for full traces", stacklevel=2)
    rows = []
    last_t, last_c = len(times) - 1, res.chunk_moves.shape[1] - 1
    for b in range(len(dataset)):
        n_tr = int(min(res.trace_n[b], cap))
        cum = np.asarray(res.chunk_moves[b], dtype=np.int64)
        mv = (np.arange(1, n_tr + 1) if res.trace_moves is None
              else np.asarray(res.trace_moves[b, :n_tr], dtype=np.int64))
        c = np.minimum(np.searchsorted(cum[1:], mv, side="left"), len(times) - 2)
        lo, hi = cum[c], cum[np.minimum(c + 1, last_c)]
        frac = (mv - lo) / np.maximum(hi - lo, 1)
        t = times[c] + frac * (times[np.minimum(c + 1, last_t)] - times[c])
        opt = float(out["opt_costs"][b])
        rows += [{"instance": names[b], "time": float(tm), "cost": float(cost),
                  "opt_cost": opt} for tm, cost in zip(t, res.trace_costs[b, :n_tr])]
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
