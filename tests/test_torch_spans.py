"""The program's spans and its lock-step round counter, on the CPU.

`evaluate` runs under torch.profiler on the whole-search kernel's twin (a
fixed n_iters, guided by the GAT or by the gated GCN) and on the per-move
engine (a deadline, read on a clock that advances a fixed tick a reading, so
that it runs the same iterations however loaded the CPU), and the recorded
"gnngls.*" regions must form utils/profiling.py's tree: the names, each
one's parent (the GAT's features formed on the device, or, for a dataset
given features of its own, scaled on the host), no torch operator left in
`gnngls.evaluate`'s own time, no span inside a round of the per-move engine
or the model.  The counter
`timings["search_rounds"]` is set on the per-move engine only, bounds each
instance's `work`, and equals it for a batch of one.  The profiler changes
no tour or cost.
"""

import dataclasses
import pathlib
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gnngls_tpu_torch import evaluate as tev
from gnngls_tpu_torch.data import dataset as tds
from gnngls_tpu_torch.models.gated_gcn import GatedGCN, GatedGCNConfig
from gnngls_tpu_torch.models.regret_gat import RegretGNN, RegretGNNConfig
from gnngls_tpu_torch.search import batched

ROOT = pathlib.Path(__file__).resolve().parent.parent
TSP10 = ROOT / "data" / "tsp10"

# span -> its parent span ("" for none), on both engines
TREE = {
    "gnngls.dataset": "",
    "gnngls.evaluate": "",
    "gnngls.evaluate.distances": "gnngls.evaluate",
    "gnngls.predict": "gnngls.evaluate",
    "gnngls.predict.features": "gnngls.predict",
    "gnngls.predict.forward": "gnngls.predict",
    "gnngls.predict.fetch": "gnngls.predict",
    "gnngls.predict.unscale": "gnngls.predict",
    "gnngls.evaluate.to_matrix": "gnngls.evaluate",
    "gnngls.construct": "gnngls.evaluate",
    "gnngls.evaluate.guide_stack": "gnngls.evaluate",
    "gnngls.search": "gnngls.evaluate",
    "gnngls.search.perturb": "gnngls.search.iteration",
    "gnngls.search.ls": "gnngls.search.iteration",
    "gnngls.evaluate.finish": "gnngls.evaluate",
}
KERNEL = {"gnngls.search.upload": "gnngls.search", "gnngls.search.kernel": "gnngls.search",
          "gnngls.search.fetch": "gnngls.search",
          # the kernel's CPU twin runs the per-move engine's iterations
          "gnngls.search.iteration": "gnngls.search.kernel"}
PER_MOVE = {"gnngls.search.iteration": "gnngls.search"}
# features of the dataset's own (here its edge weights, read before evaluate):
# built on the host at that read and scaled there a batch at a time
HOST = dict({k: v for k, v in TREE.items() if k != "gnngls.predict.features"},
            **{"gnngls.dataset.features": "", "gnngls.dataset.batch": "gnngls.predict"})
# the gated GCN's predict: its own four steps, and no edge vectors to place
GCN = dict({k: v for k, v in TREE.items()
            if k not in ("gnngls.predict.features", "gnngls.predict.unscale",
                         "gnngls.evaluate.to_matrix")},
           **{"gnngls.predict.inputs": "gnngls.predict",
              "gnngls.predict.guide": "gnngls.predict"})
ROUNDS = ("gnngls.search.perturb", "gnngls.search.ls")
TICK = 0.125  # s a reading of the per-move engine's clock: 2 iterations in 0.3 s


class TickClock:
    """A clock that advances TICK at every reading, from a whole second."""

    def __init__(self):
        self.t = float(int(time.time()))

    def time(self):
        self.t += TICK
        return self.t


def _model(engine="kernel"):
    torch.manual_seed(0)
    if engine == "gcn":
        return GatedGCN(GatedGCNConfig(hidden_dim=8, num_layers=2, num_neighbors=3))
    return RegretGNN(RegretGNNConfig(embed_dim=8, n_heads=2)).eval()


def _dataset(k):
    data = dict(np.load(TSP10 / "instances.npz"))
    idx = np.loadtxt(TSP10 / "test.txt", dtype=np.int64)[:k]
    return tds.TSPDataset.from_arrays(data, idx, tds.load_scalers(TSP10 / "scalers.json"))


def _spans(prof):
    """(name, nearest gnngls ancestor's name or "") for every recorded event."""
    out = []
    for ev in prof.events():
        up = ev.cpu_parent
        while up is not None and not up.name.startswith("gnngls."):
            up = up.cpu_parent
        out.append((ev.name, "" if up is None else up.name))
    return out


def _profiled(k, engine, **kw):
    model = _model(engine)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ds = _dataset(k)
        if engine == "host_features":
            ds = dataclasses.replace(ds, features=ds.features)
        out = tev.evaluate(ds, model=model, perturbation_moves=3, device="cpu", **kw)
    return out, _spans(prof)


@pytest.mark.parametrize("engine", ["kernel", "per_move", "gcn", "host_features"])
def test_span_tree_and_rounds(engine, monkeypatch):
    kw = dict(time_limit=0.3) if engine == "per_move" else dict(n_iters=3)
    if engine == "per_move":
        monkeypatch.setattr(batched, "time", TickClock())
    out, spans = _profiled(3, engine, **kw)
    res = out["result"]
    tree = {"gcn": GCN, "host_features": HOST}.get(engine, TREE)
    want = dict(tree, **(PER_MOVE if engine == "per_move" else KERNEL))
    gnngls = [(n, p) for n, p in spans if n.startswith("gnngls.")]
    assert {n for n, _ in gnngls} == set(want)
    for name, parent in gnngls:
        assert parent == want[name], (name, parent)
    # every torch operator inside evaluate runs in a named step
    assert not [n for n, p in spans if n.startswith("aten::") and p == "gnngls.evaluate"]
    # no span opens inside a round of the per-move engine or in the model
    assert not [n for n, p in gnngls if p in ROUNDS + ("gnngls.predict.forward",)]
    iters = sum(n == "gnngls.search.iteration" for n, _ in gnngls)
    chunks = len(res.chunk_times) - 1
    assert iters == (chunks if engine == "per_move" else 3)
    assert sum(n == "gnngls.search.ls" for n, _ in gnngls) == iters
    assert sum(n == "gnngls.evaluate" for n, _ in gnngls) == 1

    rounds = out["timings"]["search_rounds"]
    if engine != "per_move":
        assert rounds is None and res.rounds is None
        again = tev.evaluate(_dataset(3), model=_model(engine), perturbation_moves=3,
                             device="cpu", **kw)
    else:
        assert isinstance(rounds, tuple) and all(isinstance(r, int) for r in rounds)
        assert rounds == res.rounds
        for kind in (0, 1):  # the batch runs as many rounds as its slowest instance, or more
            assert rounds[kind] >= res.work[:, kind].max() > 0
        assert res.work.sum() <= len(res.work) * sum(rounds)
        # as many iterations with the profiler off: the same bits and rounds
        again = tev.evaluate(_dataset(3), model=_model(), perturbation_moves=3, device="cpu",
                             n_iters=chunks, engine="xla")
        assert again["timings"]["search_rounds"] == rounds
    for key in ("best_tours", "best_costs", "init_tours", "guide_stack"):
        np.testing.assert_array_equal(out[key], again[key])
    np.testing.assert_array_equal(res.work, again["result"].work)


def test_rounds_of_one_instance_equal_its_work():
    out = tev.evaluate(_dataset(1), model=_model(), perturbation_moves=3, device="cpu",
                       n_iters=4, engine="xla")
    assert out["timings"]["search_rounds"] == tuple(int(w) for w in out["result"].work[0])


def test_total_s_covers_the_whole_call(monkeypatch):
    real = tev.coords_to_distance_tensor

    def slow(coords, device):
        time.sleep(0.2)
        return real(coords, device)

    monkeypatch.setattr(tev, "coords_to_distance_tensor", slow)
    ds = _dataset(2)
    t0 = time.time()
    out = tev.evaluate(ds, model=_model(), perturbation_moves=3, device="cpu", n_iters=2)
    wall = time.time() - t0
    tm = out["timings"]
    assert tm["total_s"] >= 0.2 + tm["inference_s"] + tm["search_s"]
    assert tm["total_s"] <= wall

