"""The plain reference against the port's CPU twins at a small size, its
control's arithmetic, and the import rules: nothing under portbench/ imports
JAX or the JAX package, and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import json

import numpy as np
import pytest
import torch

from portbench.reference import gls as ref_gls
from portbench.reference import regret_gat as ref_model
from portbench.tests import harness_root

PB = harness_root.REPO / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "gnngls_tpu"}


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_nothing_under_portbench_imports_jax_or_the_jax_package():
    files = list(PB.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        bad = imported_tops(f) & FORBIDDEN  # top-level names compared whole
        assert not bad, f"{f}: {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for f in (PB / "reference").glob("*.py"):
        assert imported_tops(f) <= {"__future__", "contextlib", "typing", "numpy", "torch"}, f


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys

    from portbench import run as harness

    import gnngls_tpu_torch  # noqa: F401  (loaded, and not JAX's package)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gnngls_tpu.evaluate", type(sys)("gnngls_tpu.evaluate"))
    assert harness.forbidden_modules() == ["gnngls_tpu"]


@pytest.fixture(scope="module")
def small_model(tmp_path_factory):
    """A seeded RegretGNN of small width, written as a checkpoint both read."""
    from gnngls_tpu_torch.models.convert import jax_numpy_from_state
    from gnngls_tpu_torch.models.regret_gat import RegretGNNConfig, init_params

    cfg = RegretGNNConfig(embed_dim=16, n_heads=2, hidden_dim=32)
    model = init_params(cfg, torch.Generator().manual_seed(7))
    with torch.no_grad():
        for i, layer in enumerate(model.layers):
            for bn in (layer.bn1, layer.bn2):
                bn.mean.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(i))
                bn.var.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(i + 9))
    path = tmp_path_factory.mktemp("ckpt") / "small.npz"
    np.savez(path, **jax_numpy_from_state(model.state_dict()))
    return model, path


def test_reference_model_matches_the_port_on_the_cpu(small_model):
    from gnngls_tpu_torch.core.scaler import MinMaxScaler
    from gnngls_tpu_torch.data.dataset import TSPDataset
    from gnngls_tpu_torch.evaluate import predict_regret

    model, path = small_model
    coords = np.random.default_rng(3).random((3, 12, 2), dtype=np.float32)
    scalers = {"features": {"data_min": [0.01], "data_max": [1.3]},
               "regret": {"data_min": [0.0], "data_max": [2.5]}}
    E = 66
    ds = TSPDataset.from_arrays(
        {"coords": coords, "regret": np.zeros((3, E), np.float32),
         "in_solution": np.zeros((3, E), bool), "opt_cost": np.ones(3)},
        scalers={k: MinMaxScaler.from_dict(v) for k, v in scalers.items()})
    want = predict_regret(model, ds, batch_size=3, device="cpu")
    w = ref_model.load_weights(path, "cpu")
    got = ref_model.predict(w, coords, scalers, n_heads=2, depth=2, prec="f32", device="cpu",
                            batch=2)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    low = ref_model.predict(w, coords, scalers, n_heads=2, depth=2, prec="tf32", device="cpu",
                            batch=3)
    assert np.abs(low - got).max() >= 1e-4 * np.abs(got).max()  # the control's arithmetic


def test_reference_model_train_mode_matches_the_port(small_model):
    from gnngls_tpu_torch.models.regret_gat import RegretGNN, RegretGNNConfig

    model, path = small_model
    port = RegretGNN(RegretGNNConfig(embed_dim=16, n_heads=2, hidden_dim=32))
    port.load_state_dict(model.state_dict())
    port.train()
    x = torch.rand((2, 45, 1), generator=torch.Generator().manual_seed(1))
    want = port(x, gat_impl="fast")[..., 0]
    ref = ref_model.Model(ref_model.load_weights(path, "cpu"), 2, 2)
    got = ref.forward(x, train=True)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    for name, buf in port.named_buffers():
        key = "bn_state::layers/" + name.split(".", 1)[1].replace(".", "/")
        assert torch.allclose(ref.stats[key], buf, atol=1e-6), name


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11, 3.0])
    assert ref_model.to_tf32(x).tolist() == [1.0, 1.0 + 2 ** -9, 3.0]


def test_reference_search_matches_the_port_bit_for_bit():
    from gnngls_tpu_torch.data.generate import coords_to_distance_matrix
    from gnngls_tpu_torch.search.construct import nearest_neighbor_batch
    from gnngls_tpu_torch.search.local_search import gls_fixed_plain

    c = np.random.default_rng(1).random((3, 25, 2), dtype=np.float32)
    D = torch.as_tensor(coords_to_distance_matrix(c))
    assert np.array_equal(ref_model.distances(c), D.numpy())
    G = D * torch.rand(D.shape, generator=torch.Generator().manual_seed(0))
    G = G + G.transpose(1, 2)
    init = nearest_neighbor_batch(G)
    assert np.array_equal(ref_gls.nearest_neighbour(G.numpy()), init.numpy())
    want = gls_fixed_plain(D, G[:, None], init, n_iters=6, perturbation_moves=4)
    tours, costs = ref_gls.guided_local_search(D, G[:, None], init, n_iters=6,
                                               perturbation_moves=4)
    assert torch.equal(tours, want.best_tours) and torch.equal(costs, want.best_costs)
    assert all(ref_gls.is_tour(t, 25) for t in tours.numpy())
    assert not ref_gls.is_tour(np.array([0, 1, 1, 0]), 3)


def test_scaled_features_match_the_port():
    from gnngls_tpu_torch.core.scaler import load_scalers
    from gnngls_tpu_torch.data.dataset import TSPDataset

    path = harness_root.REPO / "data/tsp100/scalers.json"
    coords = np.random.default_rng(5).random((2, 20, 2), dtype=np.float32)
    ds = TSPDataset.from_arrays(
        {"coords": coords, "regret": np.zeros((2, 190), np.float32),
         "in_solution": np.zeros((2, 190), bool), "opt_cost": np.ones(2)},
        scalers=load_scalers(path))
    want = ds.get_scaled_batch(np.arange(2))["features"]
    got = ref_model.scaled_features(coords, json.loads(path.read_text()))
    assert np.array_equal(got, want)


@pytest.mark.gpu
def test_a_cell_runs_on_the_card(tmp_path):
    """One short run of the main cell from the repository's root, on the card."""
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "tsp100.fixed100",
                        "--seed", "2147483659", "--seconds", "8", "--trace", "0"],
                       cwd=harness_root.REPO, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
