"""The GAT's input features formed on the evaluate's device from its distance
matrices, and the split's lazy features.

`scaled_edge_features` gathers the edge weights from D and scales them with
the features scaler's f32 scale_ and min_, a multiply and then an add: the
bits of `get_scaled_batch(idx)["features"]`, on the CPU and on the card, at
the benchmark's tsp100 and tsp500 request shapes, at n = 3 and with two
cities in one place.  A split made from coordinates alone builds its
features on their first read, once, with the bits of `edge_features`.
`evaluate` gives the same guides, tours, costs and gaps whether the features
come from D on the device or, for a split given features of its own, from
the host; the tests count the latter as the calls of
`TSPDataset.get_scaled_batch`, the host's scaling.

The `gpu` cases skip without a CUDA device.  The file imports neither jax nor
gnngls_tpu, so on the card it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_features.py
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from gnngls_tpu_torch import evaluate as tev
from gnngls_tpu_torch.core.scaler import load_scalers
from gnngls_tpu_torch.data import dataset as tds
from gnngls_tpu_torch.data.dataset import TSPDataset, edge_features, scaled_edge_features
from gnngls_tpu_torch.data.generate import coords_to_distance_tensor
from gnngls_tpu_torch.models.gated_gcn import GatedGCN, GatedGCNConfig
from gnngls_tpu_torch.models.regret_gat import RegretGNN, RegretGNNConfig

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCALERS = ROOT / "data" / "tsp100" / "scalers.json"  # the tsp100 and tsp500 cells' range
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU: keep torch to one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(name)


def _coords(B, n, seed):
    return np.random.default_rng(seed).random((B, n, 2), dtype=np.float32)


def _coincident():
    c = _coords(4, 12, 11)
    c[:, 5] = c[:, 2]
    return c


SHAPES = {"tsp100_request": lambda: _coords(64, 100, 3100000007),
          "tsp500_request": lambda: _coords(16, 500, 2200000001),
          "n3": lambda: _coords(5, 3, 7),
          "coincident": _coincident}


def _split(coords, seed=0, scalers=None):
    """A split from coordinates alone, as the benchmark's requests make it."""
    B, n = coords.shape[:2]
    E = n * (n - 1) // 2
    opt = np.random.default_rng(seed).uniform(3.0, 4.0, B)
    return TSPDataset.from_arrays(
        {"coords": coords, "regret": np.zeros((B, E), np.float32),
         "in_solution": np.zeros((B, E), bool), "opt_cost": opt},
        scalers=load_scalers(SCALERS) if scalers is None else scalers)


def _explicit(ds):
    """The same split with its features given: the host path."""
    return dataclasses.replace(ds, features=edge_features(ds.coords))


def _host_batches(monkeypatch) -> list:
    """A list that gets an entry for every batch the host scales."""
    calls = []
    real = TSPDataset.get_scaled_batch

    def counted(self, idx):
        calls.append(1)
        return real(self, idx)

    monkeypatch.setattr(TSPDataset, "get_scaled_batch", counted)
    return calls


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("case", list(SHAPES))
def test_device_features_match_the_host_batch(device, case):
    dev = _device(device)
    ds = _split(SHAPES[case]())
    idx = np.arange(len(ds))
    got = scaled_edge_features(coords_to_distance_tensor(ds.coords, dev),
                               ds.scalers["features"])
    assert got.dtype == torch.float32 and got.device.type == dev.type
    want = ds.get_scaled_batch(idx)["features"]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    if case == "coincident":  # a weight of 0 off the diagonal scales to min_
        assert (got.cpu().numpy()[:, tds.build_topology(12).edges.tolist().index([2, 5])]
                == np.float32(ds.scalers["features"].min_[0])).all()


def test_lazy_features_are_the_edge_weights_built_once(monkeypatch):
    calls = []
    real = tds.edge_features
    monkeypatch.setattr(tds, "edge_features", lambda c: calls.append(1) or real(c))
    coords = _coords(6, 15, 4)
    ds = _split(coords)
    assert ds.features_are_edge_weights and not calls  # nothing built yet
    f = ds.features
    assert isinstance(f, np.ndarray) and f.dtype == np.float32 and f.shape == (6, 105, 1)
    np.testing.assert_array_equal(f, real(coords))
    assert ds.features is f and ds.feat_dim == 1 and len(calls) == 1
    assert ds.features_are_edge_weights  # read, still its own edge weights
    ds.fit_scalers()
    np.testing.assert_array_equal(ds.get_scaled_batch([0, 5])["features"],
                                  ds.scalers["features"].transform(f[[0, 5]]))
    assert len(calls) == 1

    # replace and positional construction keep the array, as given features
    rep = dataclasses.replace(ds, regret=ds.regret + 1)
    pos = TSPDataset(ds.coords, ds.features, ds.regret, ds.in_solution, ds.opt_cost)
    for other in (rep, pos, dataclasses.replace(ds, features=f.copy())):
        np.testing.assert_array_equal(other.features, f)
        assert not other.features_are_edge_weights
    assert len(calls) == 1
    # features=None is the lazy form in every call form
    lazy = TSPDataset(coords, None, ds.regret, ds.in_solution, ds.opt_cost)
    assert lazy.features_are_edge_weights
    np.testing.assert_array_equal(lazy.features, f)
    assert dataclasses.replace(ds, features=None).features_are_edge_weights
    with pytest.raises(TypeError):
        TSPDataset(coords)  # features stays a required field


def _gat():
    torch.manual_seed(0)
    return RegretGNN(RegretGNNConfig(embed_dim=16, n_heads=2)).eval()  # F = 8, in K2's range


def _gcn():
    torch.manual_seed(0)
    return GatedGCN(GatedGCNConfig(hidden_dim=8, num_layers=2, num_neighbors=3))


CASES = {"gat_kernel": (_gat, "pallas"), "gat_per_move": (_gat, "xla"),
         "gcn": (_gcn, "pallas")}


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("case", list(CASES))
def test_evaluate_same_on_device_and_host_features(device, case, monkeypatch):
    dev = _device(device)
    make, engine = CASES[case]
    kw = dict(n_iters=3, perturbation_moves=4, batch_size=2, engine=engine, device=dev)
    lazy = _split(_coords(5, 20, 21), seed=22)
    explicit = _explicit(lazy)
    calls = _host_batches(monkeypatch)
    a = tev.evaluate(lazy, model=make(), **kw)
    device_batches = len(calls)
    b = tev.evaluate(explicit, model=make(), **kw)
    host = len(calls) - device_batches
    for key in ("guide_stack", "init_tours", "init_costs", "best_tours", "best_costs",
                "gaps"):
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    batches = a["timings"]["predict_batches"]
    assert batches == b["timings"]["predict_batches"] == 3
    assert device_batches == 0
    assert host == (0 if case == "gcn" else batches)
    # neither the device path nor the gated GCN reads them: the lazy split builds none
    assert lazy._features is None


@pytest.mark.parametrize("device", DEVICES)
def test_predict_regret_builds_d_without_distances(device, monkeypatch):
    """Without `distances` D is built on the device a batch at a time; the
    predictions are the host path's."""
    dev = _device(device)
    ds = _split(_coords(5, 16, 31))
    model = _gat()
    calls = _host_batches(monkeypatch)
    own = tev.predict_regret(model, ds, batch_size=2, device=dev)
    assert len(calls) == 0
    given = tev.predict_regret(model, ds, batch_size=2, device=dev,
                               distances=coords_to_distance_tensor(ds.coords, dev))
    assert len(calls) == 0
    host = tev.predict_regret(model, _explicit(ds), batch_size=2, device=dev)
    assert len(calls) == 3
    np.testing.assert_array_equal(own, given)
    np.testing.assert_array_equal(own, host)


class _Width(torch.nn.Module):
    """A stand-in model that reports its input's feature width."""

    def __init__(self):
        super().__init__()
        self.widths = []

    def forward(self, x, gat_impl="auto"):
        self.widths.append(x.shape[-1])
        return torch.zeros(x.shape[:-1] + (1,), device=x.device)


def test_dropped_columns_take_the_host_path(monkeypatch):
    ds = _split(_coords(3, 8, 41))
    ds.feat_drop_idx = [0]
    model, calls = _Width(), _host_batches(monkeypatch)
    tev.predict_regret(model, ds, batch_size=2, device="cpu")
    assert len(calls) == 2 and model.widths == [0, 0]
