"""The distance matrices built on the evaluate's device, and their consumers.

`coords_to_distance_tensor` gives `coords_to_distance_matrix`'s bits on the
CPU and on the card: at the benchmark's tsp100 and tsp500 request shapes, at
n = 3, and with two cities in one place (a 0 off the diagonal).  Its square
root runs in f64 because torch's f32 root on the CPU is not always correctly
rounded: one case shows that it differs from NumPy's where it does.

The consumers keep D where it was built and give the bits that the NumPy
matrices gave: `run_fixed_kernel` takes D as an array or as a tensor alike,
and `evaluate` returns the tours, costs, gaps and guide stack of the same
pipeline run on `coords_to_distance_matrix`, with the tour costs summed on
the host.  `timings["d_host_copies"]` counts the D that crossed to the host.

The `gpu` cases skip without a CUDA device.  The file imports neither jax nor
gnngls_tpu, so on the card it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_entry.py
"""

import numpy as np
import pytest
import torch

from gnngls_tpu_torch import evaluate as tev
from gnngls_tpu_torch.core.graph import edge_vector_to_matrix
from gnngls_tpu_torch.core.scaler import MinMaxScaler
from gnngls_tpu_torch.data.dataset import TSPDataset
from gnngls_tpu_torch.data.generate import coords_to_distance_matrix, coords_to_distance_tensor
from gnngls_tpu_torch.models.regret_gat import RegretGNN, RegretGNNConfig
from gnngls_tpu_torch.search import batched
from gnngls_tpu_torch.search.gls_whole import gls_whole

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


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("case", list(SHAPES))
def test_distance_tensor_matches_numpy(device, case):
    dev = _device(device)
    coords = SHAPES[case]()
    got = coords_to_distance_tensor(coords, dev)
    assert got.dtype == torch.float32 and got.device.type == dev.type
    want = coords_to_distance_matrix(coords)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    if case == "coincident":
        assert (got[:, 2, 5] == 0).all() and (got[:, 5, 2] == 0).all()


def test_plain_f32_sqrt_on_the_cpu_differs_from_numpy():
    """The f64 root is needed: torch's f32 root on the CPU misses NumPy's
    correctly rounded one at the tsp100 request shape."""
    coords = SHAPES["tsp100_request"]()
    c = torch.as_tensor(coords)
    d = c[:, :, None] - c[:, None]
    sq = d * d
    plain = (sq[..., 0] + sq[..., 1]).sqrt().numpy()
    want = coords_to_distance_matrix(coords)
    if np.array_equal(plain, want):
        pytest.skip("this build's f32 sqrt agrees with NumPy's here")
    assert (plain != want).sum() > 0
    np.testing.assert_array_equal(coords_to_distance_tensor(coords, "cpu").numpy(), want)


def _host_costs(D, tours):
    """f32 tour costs as a host gather sums them."""
    return D[np.arange(len(D))[:, None], tours[:, :-1], tours[:, 1:]].sum(-1)


@pytest.mark.parametrize("device", DEVICES)
def test_run_fixed_kernel_takes_d_as_array_or_tensor(device):
    dev = _device(device)
    coords = _coords(4, 20, 5)
    D = coords_to_distance_matrix(coords)
    guide = np.random.default_rng(6).random(D.shape, dtype=np.float32)
    stack = np.stack([D, guide + guide.transpose(0, 2, 1)], axis=1)
    init = batched.nearest_neighbor_batch(torch.as_tensor(D, device=dev)).cpu().numpy()
    kw = dict(n_iters=3, perturbation_moves=4, device=dev)
    a = batched.run_fixed_kernel(D, stack, init, **kw)
    t = batched.run_fixed_kernel(coords_to_distance_tensor(coords, dev), stack, init, **kw)
    for key in ("best_tours", "best_costs", "search_costs", "trace_costs"):
        np.testing.assert_array_equal(getattr(a, key), getattr(t, key))
    np.testing.assert_array_equal(a.best_costs, _host_costs(D, a.best_tours).astype(np.float64))


def _dataset(B, n, seed):
    scalers = {"features": MinMaxScaler([0.0], [1.5]), "regret": MinMaxScaler([0.0], [2.0])}
    E = n * (n - 1) // 2
    opt = np.random.default_rng(seed + 1).uniform(3.0, 4.0, B)
    return TSPDataset.from_arrays({"coords": _coords(B, n, seed), "regret": np.zeros((B, E)),
                                   "in_solution": np.zeros((B, E), bool), "opt_cost": opt},
                                  scalers=scalers)


def _model():
    torch.manual_seed(0)
    return RegretGNN(RegretGNNConfig(embed_dim=16, n_heads=2)).eval()  # F = 8, in K2's range


def _numpy_pipeline(ds, model, guides, n_iters, pm, dev):
    """evaluate's steps on the host-built matrices: D from
    `coords_to_distance_matrix`, the tour costs gathered and summed on the
    host."""
    D = coords_to_distance_matrix(ds.coords)
    R = None
    if "regret_pred" in guides:
        preds = tev.predict_regret(model, ds, device=dev)
        R = edge_vector_to_matrix(preds.astype(np.float32), ds.n_nodes)
    init = batched.nearest_neighbor_batch(
        torch.as_tensor(D if R is None else R, device=dev)).cpu().numpy()
    stack = np.stack([D if g == "weight" else R for g in guides], axis=1)
    out = gls_whole(*(torch.as_tensor(x, device=dev) for x in (D, stack, init)),
                    n_iters=n_iters, perturbation_moves=pm)
    best = _host_costs(D, out.best_tours.cpu().numpy()).astype(np.float64)
    return {"init_tours": init, "init_costs": _host_costs(D, init),
            "best_tours": out.best_tours.cpu().numpy(), "best_costs": best,
            "gaps": (best / ds.opt_cost - 1.0) * 100.0, "guide_stack": stack}


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("guides,with_model,copies", [(["regret_pred"], True, 0),
                                                      (["weight", "regret_pred"], True, 1),
                                                      (["weight"], False, 1)])
def test_evaluate_matches_the_numpy_distances(device, guides, with_model, copies):
    dev = _device(device)
    ds = _dataset(3, 20, 9)
    model = _model() if with_model else None
    out = tev.evaluate(ds, model=model, guides=guides, n_iters=3, perturbation_moves=4,
                       device=dev)
    assert out["engine"] == "pallas"
    want = _numpy_pipeline(ds, model, guides, 3, 4, dev)
    for key, value in want.items():
        assert out[key].dtype == value.dtype, key
        np.testing.assert_array_equal(out[key], value, err_msg=key)
    assert out["timings"]["d_host_copies"] == copies


@pytest.mark.parametrize("device", DEVICES)
def test_evaluate_per_move_engine_takes_the_device_d(device):
    """The per-move engine gets the tensor as it is; no D crosses."""
    dev = _device(device)
    ds = _dataset(2, 12, 4)
    out = tev.evaluate(ds, model=_model(), n_iters=2, perturbation_moves=3, engine="xla",
                       device=dev)
    D = coords_to_distance_matrix(ds.coords)
    want = batched.run_fixed(D, out["guide_stack"], out["init_tours"], n_iters=2,
                             perturbation_moves=3, device=dev)
    np.testing.assert_array_equal(out["best_tours"], want.best_tours)
    np.testing.assert_array_equal(out["best_costs"], want.best_costs)
    np.testing.assert_array_equal(out["init_costs"], _host_costs(D, out["init_tours"]))
    assert out["timings"]["d_host_copies"] == 0
