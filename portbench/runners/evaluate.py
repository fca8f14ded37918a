"""The evaluate runner: one request is one `gnngls_tpu_torch.evaluate.evaluate`
call on a `TSPDataset` built from the coordinates the harness hands over,
with the model loaded from the configuration's checkpoint, in a closed loop.

Every request keeps, for the check, `lanes` of its instances drawn from the
seed and its index: the program's guide matrices, initial tours, best tours
and f32 best costs.  After the window the check takes `requests` of the
requests the window completed, drawn from the seed, so that its sample
spans the whole window and many lanes of the batch.

The check after the window (see `check`):
  * every request: its best and initial tours are closed tours through every
    city from the depot, and the engine that ran is the traffic's;
  * the sampled instances, stage by stage, against the plain reference's own
    pipeline from the coordinates: its predictions, its guide matrices, its
    nearest-neighbour tours, its GLS for as many outer iterations as the
    program ran:
      pred_err            the program's guide matrices (all n x n entries)
                          against the reference's: the largest gap over the
                          largest reference value, the worst instance;
      own_guide_differ    instances whose initial tour, best tour or f32 best
                          cost the reference's own pipeline does not
                          reproduce;
      init_tours_differ   of those, the initial tours that differ again when
                          the reference's construction runs on the program's
                          guide matrices (exact);
      search_differ       and the best tours or f32 best costs that differ
                          again when the reference's search then runs from
                          there (exact).
    Predictions a few ulps apart can break a tie in the construction or in
    a perturbation's choice of edge, after which the two searches part for
    good: a few sound instances in a hundred do so, and a lower precision's
    predictions part most of them.  Hence the limit on own_guide_differ,
    set from both readings, and the second run on the program's guide
    matrices, held to the reference's by pred_err, where only an exact
    match will do.

What is the edge-regret GAT's here is three hooks on `Runner` and three
declarations beside it; all else is shared by every model:
  load_model                the program's model;
  reference_guides          the reference's guide matrices for the sampled
                            lanes, from the coordinates;
  model_flops_per_instance  the model's FLOPs an instance (the mfu readers);
  LIMITS                    the names `check` returns, which a cell's limits
                            name;
  PUBLISHED                 the model widths a configuration run here keeps,
                            unless its entry in BENCHMARK.json lists the key
                            under `reduced`;
  faults                    the cell's faults and control (portbench/faults.py).
A configuration of another model comes with a module of its own under
portbench/runners/, which subclasses `Runner`, overrides the hooks and
declares the three names for its model, and a reference of its own under
portbench/reference/.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, List, Optional

import numpy as np
from torch.profiler import record_function

from portbench import faults as F
from portbench import roofline
from portbench import traffic as gen
from portbench.reference import gls as ref_gls
from portbench.reference import regret_gat as ref_model

LIMITS = ("pred_err", "own_guide_differ", "init_tours_differ", "search_differ")
PUBLISHED = {"embed_dim": 128, "hidden_dim": 512, "n_heads": 8}


def faults(config: dict, root, batch: int) -> dict:
    """The faults of an evaluate cell of the GAT, and its control: the GAT's
    reference with TF32 products predicting `batch` instances at a time in
    `predict_regret`'s place."""
    from gnngls_tpu_torch import evaluate
    from gnngls_tpu_torch.search import batched, local_search

    return {
        "half_batch": [(evaluate, "predict_regret", F.half_predict(evaluate.predict_regret))],
        "unchanged_state": [(batched, "gls_whole", F.search_unchanged(batched.gls_whole)),
                            (local_search, "gls_iteration", F.iteration_unchanged)],
        "altered_answer": [(batched, "gls_whole", F.altered(batched.gls_whole))],
        "control_tf32": [(evaluate, "predict_regret", _tf32_predict(config, root, batch))],
    }


def _tf32_predict(config: dict, root, batch: int):
    def predict(model, dataset, *, device=None, **kw):
        dev = device or "cuda"
        weights = ref_model.load_weights(root / config["checkpoint"], dev)
        scalers = json.loads((root / config["scalers"]).read_text())
        return ref_model.predict(weights, dataset.coords, scalers,
                                 n_heads=config["model"]["n_heads"], depth=config["depth"],
                                 prec="tf32", device=dev, batch=batch)
    return predict


def guide_matrices(pred: np.ndarray, n: int) -> np.ndarray:
    """Edge predictions (L, E), edges (u, v) u < v in lexicographic order ->
    (L, n, n) float32 guide matrices, symmetric, 0 on the diagonal."""
    us, vs = ref_model.edge_pairs(n)
    guide = np.zeros((len(pred), n, n), np.float32)
    guide[:, us, vs] = guide[:, vs, us] = pred
    return guide


@dataclasses.dataclass
class Request:
    index: int
    start: float
    end: float
    instances: int
    dataset_s: float = 0.0
    timings: dict = dataclasses.field(default_factory=dict)
    chunks: int = 0
    search_s: float = 0.0
    work: Any = None
    peak_bytes: int = 0
    engine: str = ""
    best_tours: Any = None
    init_tours: Any = None
    kept: Optional[dict] = None  # the seed's lanes of the output, for the check


class Runner:
    def __init__(self, root, cell, seed: int, device):
        self.root, self.cell, self.seed, self.dev = root, cell, int(seed), device
        self.cfg, self.tr = cell.config, cell.traffic
        self.check_spec = cell.check
        self.weights, self.sample_info = None, {}

    # -- set-up -------------------------------------------------------------
    def setup(self) -> None:
        import torch

        from gnngls_tpu_torch.core.scaler import load_scalers
        from gnngls_tpu_torch.data.dataset import TSPDataset
        from gnngls_tpu_torch.evaluate import evaluate

        self.torch = torch
        self.TSPDataset, self.evaluate = TSPDataset, evaluate
        self.model = self.load_model()
        self.scalers = load_scalers(self.root / self.cfg["scalers"])
        self.reseed(self.seed)
        N, n = self.src.size, self.src.n
        E = n * (n - 1) // 2
        self.zeros = (np.zeros((N, E), np.float32), np.zeros((N, E), bool))
        for w in range(int(self.tr.get("warmup_requests", 1))):
            self.request(-1 - w, warmup=True)

    def load_model(self):
        """The program's model: the GAT with the configuration's checkpoint."""
        from gnngls_tpu_torch.models.convert import load_model
        from gnngls_tpu_torch.models.regret_gat import RegretGNNConfig

        return load_model(self.root / self.cfg["checkpoint"],
                          RegretGNNConfig(**self.cfg["model"]), device=self.dev)

    def model_flops_per_instance(self) -> float:
        """The model's forward FLOPs an instance (the mfu reader's count)."""
        return roofline.regret_gat_flops(self.cfg)

    def reseed(self, seed: int) -> None:
        """Draw the requests from `seed`."""
        self.seed = int(seed)
        self.src = gen.Requests(self.root, self.cfg, self.tr, self.seed)

    def kwargs(self, warmup: bool) -> dict:
        t = self.tr
        kw = dict(guides=t["guides"], perturbation_moves=t["perturbation_moves"],
                  batch_size=t["batch_size"], engine=t.get("engine", "auto"))
        if "n_iters" in t:
            kw.update(n_iters=t["n_iters"], time_limit=None)
        else:
            kw.update(time_limit=t["warmup_time_limit"] if warmup else t["time_limit"])
        return kw

    # -- one request ----------------------------------------------------------
    def request(self, r: int, warmup: bool = False) -> Request:
        coords = self.src.coords_of(abs(r) + 10 ** 6 if warmup else r)
        opt = self.src.opt_of(r) if r >= 0 and self.src.kind == "split" else None
        opt = np.ones(len(coords)) if opt is None else opt
        t0 = time.time()
        with record_function("portbench.dataset"):
            ds = self.TSPDataset.from_arrays(
                {"coords": coords, "regret": self.zeros[0], "in_solution": self.zeros[1],
                 "opt_cost": opt}, scalers=self.scalers)
        t1 = time.time()
        with record_function("portbench.evaluate"):
            out = self.evaluate(ds, model=self.model, device=self.dev, **self.kwargs(warmup))
        t2 = time.time()
        res = out["result"]
        q = Request(
            index=r, start=t0, end=t2, instances=len(coords), dataset_s=t1 - t0,
            timings=dict(out["timings"]), chunks=len(res.chunk_times) - 1,
            search_s=res.chunk_times[-1] - res.chunk_times[0], work=res.work,
            peak_bytes=out["timings"].get("peak_device_bytes") or 0, engine=out["engine"],
            best_tours=out["best_tours"], init_tours=out["init_tours"])
        if not warmup:
            idx = gen.lanes(self.seed, r, len(coords), int(self.check_spec["lanes"]))
            q.kept = {"lanes": idx, "guides": out["guide_stack"][idx],
                      "init": out["init_tours"][idx], "best": out["best_tours"][idx],
                      "costs": np.asarray(res.search_costs, np.float32)[idx]}
        return q

    def iteration_hook(self, step):
        """Call `step` after every outer iteration of the per-move engine
        (the trace's steps); returns the undo."""
        from gnngls_tpu_torch.search import batched

        orig = batched.batch_chunk

        def hooked(*a, **k):
            out = orig(*a, **k)
            step()
            return out

        batched.batch_chunk = hooked
        return lambda: setattr(batched, "batch_chunk", orig)

    def memory_peak(self, requests: List[Request]) -> int:
        cur = int(self.torch.cuda.max_memory_allocated()) if self.torch.cuda.is_available() else 0
        return max([cur] + [int(r.peak_bytes) for r in requests])

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.model = None
        if self.torch.cuda.is_available():
            self.torch.cuda.empty_cache()

    # -- after the window -------------------------------------------------------
    def gaps(self, requests: List[Request]) -> Optional[np.ndarray]:
        """The gap (%) of every instance's best tour, its length recomputed
        in float64 from the coordinates; None where there is no optimum."""
        if self.src.kind != "split":
            return None
        out = []
        for q in requests:
            c = self.src.coords_of(q.index).astype(np.float64)
            t = q.best_tours.astype(np.int64)
            seg = c[np.arange(len(c))[:, None], t[:, 1:]] - c[np.arange(len(c))[:, None], t[:, :-1]]
            length = np.sqrt((seg * seg).sum(-1)).sum(-1)
            out.append((length / self.src.opt_of(q.index) - 1.0) * 100.0)
        return np.concatenate(out)

    def malformed(self, q: Request) -> Optional[str]:
        n, want = self.src.n, self.tr.get("engine_expected")
        if want and q.engine != want:
            return f"request {q.index}: engine {q.engine}, the traffic asks for {want}"
        for name, tours in (("best", q.best_tours), ("initial", q.init_tours)):
            if tours is None or len(tours) != q.instances or not all(
                    ref_gls.is_tour(np.asarray(t), n) for t in tours):
                return f"request {q.index}: a {name} tour is not a tour"
        return None

    def reference_guides(self, chosen: List[Request], prec: str) -> np.ndarray:
        """The reference's (L, n, n) float32 guide matrices for the kept lanes
        of the `chosen` requests, in their order: the GAT's predictions from
        the coordinates in precision `prec`, `reference_batch` instances at a
        time, placed by `guide_matrices`."""
        coords = np.concatenate([self.src.coords_of(q.index)[q.kept["lanes"]] for q in chosen])
        if self.weights is None:
            self.weights = ref_model.load_weights(self.root / self.cfg["checkpoint"], self.dev)
        scalers = json.loads((self.root / self.cfg["scalers"]).read_text())
        m = self.cfg["model"]
        depth = m["n_heads"] if m.get("depth_from_heads", True) else m["n_layers"]
        pred = ref_model.predict(self.weights, coords, scalers, n_heads=m["n_heads"], depth=depth,
                                 prec=prec, device=self.dev,
                                 batch=int(self.check_spec.get("reference_batch", 1)))
        return guide_matrices(pred, self.src.n)

    def search(self, D: np.ndarray, stack: np.ndarray, n_iters: List[int]):
        """The reference's construction and GLS on guide stacks (L, G, n, n):
        (initial tours, best tours, f32 best costs), lane l run for
        n_iters[l] outer iterations."""
        torch = self.torch
        guides = list(self.tr["guides"])  # evaluate builds on the predictions, else on D
        first = stack[:, guides.index("regret_pred")] if "regret_pred" in guides else D
        init = ref_gls.nearest_neighbour(first)
        tours, costs = np.empty_like(init), np.empty(len(init), np.float32)
        for it in sorted(set(n_iters)):
            sel = np.flatnonzero(np.asarray(n_iters) == it)
            t, c = ref_gls.guided_local_search(
                torch.as_tensor(D[sel], device=self.dev),
                torch.as_tensor(stack[sel], device=self.dev),
                torch.as_tensor(init[sel], device=self.dev),
                n_iters=it, perturbation_moves=self.tr["perturbation_moves"])
            tours[sel], costs[sel] = t.cpu().numpy(), c.cpu().numpy()
        return init, tours, costs

    def check(self, requests: List[Request], n_done: Optional[int] = None) -> dict:
        """The compared numbers over the instances kept by the requests that
        the seed picks among the first `n_done` (by default all of them;
        module docstring)."""
        done = {q.index: q for q in requests}
        n_done = len(requests) if n_done is None else n_done
        chosen = [done[int(r)] for r in gen.picks(self.seed, n_done,
                                                  int(self.check_spec["requests"]))]
        coords = np.concatenate([self.src.coords_of(q.index)[q.kept["lanes"]] for q in chosen])
        prog = {k: np.concatenate([q.kept[k] for q in chosen])
                for k in ("guides", "init", "best", "costs")}
        n_iters = [int(self.tr.get("n_iters", q.chunks)) for q in chosen
                   for _ in q.kept["lanes"]]
        names = list(self.tr["guides"])
        D = ref_model.distances(coords)
        guide = self.reference_guides(chosen, "f32") if "regret_pred" in names else D
        stack = np.stack([guide if g == "regret_pred" else D for g in names], axis=1)
        pred_err = float(max(np.abs(prog["guides"][i] - stack[i]).max() / np.abs(stack[i]).max()
                             for i in range(len(stack))))

        def differ(sel, init, tours, costs):
            return (np.any(init != prog["init"][sel], axis=1),
                    np.any(tours != prog["best"][sel], axis=1) | (costs != prog["costs"][sel]))

        every = np.arange(len(coords))
        init_d, search_d = differ(every, *self.search(D, stack, n_iters))
        own = ~(init_d | search_d)
        again = np.flatnonzero(~own)
        if len(again):  # a tie that the predictions' last bits broke
            init_d[again], search_d[again] = differ(again, *self.search(
                D[again], prog["guides"][again], [n_iters[i] for i in again]))
        self.sample_info = {"requests": [q.index for q in chosen], "instances": len(coords)}
        return {"pred_err": pred_err, "own_guide_differ": int(len(again)),
                "init_tours_differ": int(init_d.sum()), "search_differ": int(search_d.sum())}

    def readings(self, seed: int) -> dict:
        """The check's numbers for `seed` in a window of the check's
        `window_requests`: the requests it picks, run one at a time as the
        window runs them."""
        self.reseed(seed)
        n_done = int(self.check_spec["window_requests"])
        picked = gen.picks(self.seed, n_done, int(self.check_spec["requests"]))
        return self.check([self.request(int(r)) for r in picked], n_done)
