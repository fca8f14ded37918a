"""Nearest-neighbour construction: the plain twin and the kernel.

On the CPU, `nearest_neighbor_plain` is held to JAX's construction
(`gnngls_tpu.search.batched.nearest_neighbor_batch`) and to the benchmark's
NumPy reference (`portbench/reference/gls.py::nearest_neighbour`) on guides
that stress its picks: uniform values, integer values with many ties, rows
with +inf and -inf entries (one row whose unvisited entries are all +inf,
which goes back to city 0), and signed zeros, which tie.

The `gpu` cases hold `csrc/nearest_neighbor.cu` to the twin bit for bit on
the card (f32 and f64, the register flags and the workspace past 8192
cities, strided guides, another depot), and show that each caller on the
card launches it once a call and returns what the twin's path returns.
The file imports jax only inside the JAX comparison, so its `gpu` cases run
on the card without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_construct.py
"""

import numpy as np
import pytest
import torch

from gnngls_tpu_torch import evaluate as tev
from gnngls_tpu_torch import kernels
from gnngls_tpu_torch.core.scaler import MinMaxScaler
from gnngls_tpu_torch.data import solvers
from gnngls_tpu_torch.data.dataset import TSPDataset
from gnngls_tpu_torch.data.generate import coords_to_distance_matrix
from gnngls_tpu_torch.models.gated_gcn import GatedGCN, GatedGCNConfig
from gnngls_tpu_torch.models.regret_gat import RegretGNN, RegretGNNConfig
from gnngls_tpu_torch.search import batched, construct
from gnngls_tpu_torch.search.construct import nearest_neighbor_batch, nearest_neighbor_plain
from portbench.reference.gls import nearest_neighbour as reference_nearest_neighbour

gpu = pytest.mark.gpu


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU: keep torch to one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _guides(case, B, n, seed, dtype=np.float32):
    """(B, n, n) guides of one kind."""
    rng = np.random.default_rng(seed)
    if case == "uniform":
        W = rng.random((B, n, n))
    elif case == "integer_ties":
        W = rng.integers(0, 3, (B, n, n)).astype(np.float64)
    elif case == "infinities":
        W = rng.random((B, n, n))
        W[rng.random((B, n, n)) < 0.1] = np.inf
        W[rng.random((B, n, n)) < 0.02] = -np.inf
        W[0, n // 2] = np.inf  # reached at some step: every unvisited entry +inf
        if B > 1:
            W[1] = np.inf
    elif case == "signed_zeros":
        W = rng.choice([-0.0, 0.0, 0.5], (B, n, n))
    else:
        raise ValueError(case)
    return W.astype(dtype)


CASES = ("uniform", "integer_ties", "infinities", "signed_zeros")


@pytest.mark.parametrize("n", [1, 2, 3, 100, 500])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_and_reference(case, n):
    import jax.numpy as jnp

    from gnngls_tpu.search import batched as jbatched

    W = _guides(case, 4, n, seed=n)
    got = nearest_neighbor_plain(torch.as_tensor(W)).numpy()
    assert got.dtype == np.int32 and got.shape == (4, n + 1)
    np.testing.assert_array_equal(got, reference_nearest_neighbour(W))
    np.testing.assert_array_equal(got, np.asarray(jbatched.nearest_neighbor_batch(jnp.asarray(W))))
    W64 = _guides(case, 4, n, seed=n, dtype=np.float64)
    np.testing.assert_array_equal(nearest_neighbor_plain(torch.as_tensor(W64)).numpy(),
                                  reference_nearest_neighbour(W64))
    if case == "infinities" and n > 2:
        assert (got[1, 1:] == 0).all()  # a row of +inf alone picks city 0, visited or not


def test_plain_takes_another_depot():
    import jax
    import jax.numpy as jnp

    from gnngls_tpu.search import construct as jconstruct

    W = _guides("integer_ties", 5, 30, seed=2)
    for depot in (1, 29):
        got = nearest_neighbor_plain(torch.as_tensor(W), depot).numpy()
        np.testing.assert_array_equal(got, reference_nearest_neighbour(W, depot))
        want = jax.vmap(lambda w: jconstruct.nearest_neighbor(w, depot))(jnp.asarray(W))
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.float16, torch.int64])
def test_cpu_tensors_take_the_twin(dtype):
    W = torch.as_tensor(_guides("integer_ties", 3, 12, seed=5)).to(dtype)
    before = dict(kernels.launches)
    got = nearest_neighbor_batch(W, 2)
    assert dict(kernels.launches) == before
    np.testing.assert_array_equal(got.numpy(), nearest_neighbor_plain(W, 2).numpy())


# --- the kernel on the card --------------------------------------------------


def _on(cuda, W):
    return torch.as_tensor(W, device=cuda)


def _launched_once(W, depot=0):
    before = kernels.launches["nearest_neighbor"]
    tours = nearest_neighbor_batch(W, depot)
    torch.cuda.synchronize()
    assert kernels.launches["nearest_neighbor"] == before + 1
    return tours


@gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [2, 100, 139, 500, 1100])
@pytest.mark.parametrize("B", [1, 16, 64, 128, 500])
def test_kernel_matches_twin(cuda, B, n, dtype):
    W = _on(cuda, _guides("uniform", B, n, seed=B * n, dtype=dtype))
    got = _launched_once(W)
    assert got.dtype == torch.int32 and got.shape == (B, n + 1) and got.device == W.device
    assert torch.equal(got, nearest_neighbor_plain(W))


@gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [1, 3, 33, 100, 1100])
@pytest.mark.parametrize("case", ["integer_ties", "infinities", "signed_zeros"])
def test_kernel_matches_twin_on_ties_and_infinities(cuda, case, n, dtype):
    W = _on(cuda, _guides(case, 16, n, seed=n, dtype=dtype))
    assert torch.equal(_launched_once(W), nearest_neighbor_plain(W))


@gpu
@pytest.mark.parametrize("n", [2100, 4500, 8192, 8200])
def test_kernel_matches_twin_at_large_n(cuda, n):
    """Eight words of register flags, the last n they hold, and the
    workspace past it."""
    W = _on(cuda, _guides("integer_ties", 2, n, seed=n))
    assert torch.equal(_launched_once(W), nearest_neighbor_plain(W))


@gpu
@pytest.mark.parametrize("view", ["transposed", "corner", "expanded", "stack_slice"])
def test_kernel_reads_strided_guides_in_place(cuda, view):
    big = _on(cuda, _guides("integer_ties", 8, 140, seed=7))
    W = {"transposed": lambda: big.transpose(1, 2),
         "corner": lambda: big[2:6, 10:110, 20:120],
         "expanded": lambda: big[3].expand(5, 140, 140),
         "stack_slice": lambda: torch.stack([big, big.flip(0)], dim=1)[:, 1]}[view]()
    assert not W.is_contiguous()
    assert torch.equal(_launched_once(W), nearest_neighbor_plain(W.contiguous()))


@gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_kernel_takes_another_depot(cuda, dtype):
    W = _on(cuda, _guides("integer_ties", 16, 100, seed=4, dtype=dtype))
    for depot in (1, 37, 99):
        got = _launched_once(W, depot)
        assert (got[:, 0] == depot).all() and (got[:, -1] == depot).all()
        assert torch.equal(got, nearest_neighbor_plain(W, depot))


@gpu
def test_kernel_refuses_a_depot_outside_and_takes_an_empty_batch(cuda):
    W = _on(cuda, _guides("uniform", 2, 10, seed=1))
    for depot in (-1, 10):
        with pytest.raises(ValueError, match="depot"):
            nearest_neighbor_batch(W, depot)
    assert nearest_neighbor_batch(W[:0]).shape == (0, 11)


@gpu
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.int64])
def test_other_dtypes_on_the_card_raise(cuda, dtype):
    W = _on(cuda, _guides("integer_ties", 3, 20, seed=3)).to(dtype)
    before = dict(kernels.launches)
    with pytest.raises(TypeError, match="float32 or float64"):
        nearest_neighbor_batch(W)
    assert dict(kernels.launches) == before


@gpu
@pytest.mark.parametrize("shape", [(2, 10, 9), (2, 9, 10), (10, 10)])
def test_kernel_refuses_guides_that_are_not_square(cuda, shape):
    W = torch.rand(shape, device=cuda)
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match=r"\(B, n, n\)"):
        nearest_neighbor_batch(W)
    assert dict(kernels.launches) == before


@pytest.mark.parametrize("shape", [(2, 10, 9), (2, 9, 10), (10, 10)])
def test_cpu_guides_that_are_not_square_raise(shape):
    with pytest.raises(ValueError, match=r"\(B, n, n\)"):
        nearest_neighbor_batch(torch.rand(shape))


# --- the callers on the card --------------------------------------------------


def _dataset(B, n, seed):
    scalers = {"features": MinMaxScaler([0.0], [1.5]), "regret": MinMaxScaler([0.0], [2.0])}
    E = n * (n - 1) // 2
    rng = np.random.default_rng(seed)
    arrays = {"coords": rng.random((B, n, 2), dtype=np.float32), "regret": np.zeros((B, E)),
              "in_solution": np.zeros((B, E), bool), "opt_cost": rng.uniform(3.0, 4.0, B)}
    return TSPDataset.from_arrays(arrays, scalers=scalers)


def _gat():
    torch.manual_seed(0)
    return RegretGNN(RegretGNNConfig(embed_dim=16, n_heads=2)).eval()


def _gcn():
    torch.manual_seed(0)
    return GatedGCN(GatedGCNConfig(hidden_dim=8, num_layers=2, num_neighbors=3))


@gpu
@pytest.mark.parametrize("B,n", [(64, 100), (16, 500)], ids=["tsp100", "tsp500"])
@pytest.mark.parametrize("make", [_gat, _gcn], ids=["gat", "gated_gcn"])
def test_evaluate_launches_once_and_returns_the_twins_tours(cuda, make, B, n, monkeypatch):
    ds, model = _dataset(B, n, seed=n), make().to(cuda)
    kw = dict(model=model, n_iters=2, perturbation_moves=3, batch_size=B, device=cuda)
    before = kernels.launches["nearest_neighbor"]
    got = tev.evaluate(ds, **kw)
    assert kernels.launches["nearest_neighbor"] == before + 1
    monkeypatch.setattr(batched, "nearest_neighbor_batch", construct.nearest_neighbor_plain)
    want = tev.evaluate(ds, **kw)
    assert kernels.launches["nearest_neighbor"] == before + 1
    for key in ("init_tours", "best_tours", "best_costs", "init_costs"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@gpu
def test_search_on_predictions_and_the_oracle_launch_once(cuda):
    ds = _dataset(8, 60, seed=3)
    preds = tev.predict_regret(_gat().to(cuda), ds, device=cuda)
    before = kernels.launches["nearest_neighbor"]
    tev.search_on_predictions(preds, ds.coords, n_iters=2, perturbation_moves=3, device=cuda)
    assert kernels.launches["nearest_neighbor"] == before + 1
    Ds = coords_to_distance_matrix(ds.coords)
    tours, _ = solvers.gls_oracle(Ds, n_iters=2, device=cuda)
    assert kernels.launches["nearest_neighbor"] == before + 2
    assert all(sorted(t[:-1]) == list(range(60)) for t in tours.tolist())
