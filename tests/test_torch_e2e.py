"""The port's main path end to end on the CPU, against gnngls_tpu.

First JAX's own regret predictions go through the port's search on data/tsp20
(test instances 0-15, n_iters 5): the accepted moves and the best tours and
costs must be identical to gnngls_tpu's.  Then the port's whole `evaluate`
(its own model on its plain twins) is held to JAX `evaluate`: the same mean
gap within 0.02 percentage points, the difference that f32 rounding in the
model (about 1e-6) may cause through changed search decisions.
"""

import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

from gnngls_tpu import evaluate as jev
from gnngls_tpu.core.graph import edge_vector_to_matrix
from gnngls_tpu.data import dataset as jds
from gnngls_tpu.models import regret_gat as JM
from gnngls_tpu.search import batched as jbatched
from gnngls_tpu.train import checkpoint as jck
from gnngls_tpu_torch import evaluate as tev
from gnngls_tpu_torch.cli import test as tcli
from gnngls_tpu_torch.data import dataset as tds
from gnngls_tpu_torch.models.convert import load_model
from gnngls_tpu_torch.models.regret_gat import RegretGNNConfig
from gnngls_tpu_torch.search import batched as tbatched

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU: keep torch to one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
K, N_ITERS, PM = 16, 5, 20
GAP_TOL_PP = 0.02


def _subset(mod, k=K):
    root = ROOT / "data" / "tsp20"
    ds = mod.TSPDataset.from_npz(root / "instances.npz", root / "test.txt",
                                 scalers_file=root / "scalers.json")
    return dataclasses.replace(ds, coords=ds.coords[:k], features=ds.features[:k],
                               regret=ds.regret[:k], in_solution=ds.in_solution[:k],
                               opt_cost=ds.opt_cost[:k])


def _jax_model():
    cfg = JM.RegretGNNConfig()
    p_like, s_like = JM.init_params(jax.random.PRNGKey(0), cfg)
    params, bn, _, _ = jck.load_checkpoint(ROOT / "models/tsp20/checkpoint_best_val.npz",
                                           params_like=p_like, bn_state_like=s_like)
    return params, bn, cfg


def test_jax_predictions_through_port_search():
    ds = _subset(jds)
    params, bn, cfg = _jax_model()
    R = edge_vector_to_matrix(jev.predict_regret(params, bn, cfg, ds).astype(np.float32), 20)
    D = jev.coords_to_distance_matrix(ds.coords).astype(np.float32)
    inits = np.asarray(jbatched.nearest_neighbor_batch(R))
    ref = jbatched.run_fixed(D, R[:, None], inits, n_iters=N_ITERS, perturbation_moves=PM)
    mine_inits = tbatched.nearest_neighbor_batch(torch.as_tensor(R)).numpy()
    np.testing.assert_array_equal(mine_inits, inits)
    res = tbatched.run_fixed_kernel(D, R[:, None], inits, n_iters=N_ITERS,
                                    perturbation_moves=PM, device="cpu")
    np.testing.assert_array_equal(res.chunk_moves[:, -1], ref.trace_n)
    np.testing.assert_array_equal(res.best_tours, ref.best_tours)
    ref_costs = D[np.arange(K)[:, None], ref.best_tours[:, :-1], ref.best_tours[:, 1:]].sum(-1)
    np.testing.assert_array_equal(res.best_costs, ref_costs.astype(np.float64))


def test_search_on_predictions_matches_jax_search():
    """The search that the prediction-route paths run on given predictions:
    nearest neighbour on the regret matrix, then GLS with it as the only
    guide, gives JAX's tours on JAX's predictions."""
    ds = _subset(jds)
    params, bn, cfg = _jax_model()
    preds = jev.predict_regret(params, bn, cfg, ds)
    R = edge_vector_to_matrix(preds.astype(np.float32), 20)
    D = jev.coords_to_distance_matrix(ds.coords).astype(np.float32)
    ref = jbatched.run_fixed(D, R[:, None], np.asarray(jbatched.nearest_neighbor_batch(R)),
                             n_iters=N_ITERS, perturbation_moves=PM)
    res, search_s = tev.search_on_predictions(preds, ds.coords, n_iters=N_ITERS,
                                              perturbation_moves=PM, device="cpu")
    np.testing.assert_array_equal(res.best_tours, ref.best_tours)
    np.testing.assert_array_equal(res.chunk_moves[:, -1], ref.trace_n)
    assert search_s >= 0


def test_port_evaluate_matches_jax_evaluate():
    params, bn, cfg = _jax_model()
    want = jev.evaluate(_subset(jds), params=params, bn_state=bn, model_cfg=cfg,
                        guides=["regret_pred"], n_iters=N_ITERS, perturbation_moves=PM)
    model = load_model(ROOT / "models/tsp20/checkpoint_best_val.npz", RegretGNNConfig(),
                       device="cpu")
    got = tev.evaluate(_subset(tds), model=model, guides=["regret_pred"], n_iters=N_ITERS,
                       perturbation_moves=PM, device="cpu")
    assert got["engine"] == "pallas" and got["device"] == "cpu" and got["gaps"].shape == (K,)
    assert abs(got["mean_gap"] - want["mean_gap"]) <= GAP_TOL_PP
    np.testing.assert_allclose(got["init_costs"], want["init_costs"], rtol=1e-6)
    rows = tev.search_progress_records(_subset(tds), got)
    assert len(rows) == K * N_ITERS and {"instance", "time", "cost", "opt_cost"} <= set(rows[0])
    # weight-guided, no model (test.py:87-88): one guide, D
    w = tev.evaluate(_subset(tds, 4), guides=["weight", "weight"], n_iters=2, device="cpu")
    assert np.all(w["gaps"] > -1e-4)  # optimal tours up to f32 rounding of the sums


def test_cli_runs_on_cpu(tmp_path, capsys, monkeypatch):
    data = tmp_path / "tsp20"
    data.mkdir()
    for name in ("instances.npz", "scalers.json"):
        (data / name).symlink_to(ROOT / "data" / "tsp20" / name)
    (data / "test.txt").write_text("0\n1\n2\n")
    npz = str(ROOT / "models/tsp20/checkpoint_best_val.npz")
    split = str(data / "test.txt")
    tcli.main([split, npz, str(tmp_path / "runs"), "regret_pred", "--n_iters", "2",
               "--perturbation_moves", "5", "--device", "cpu", "--use_gpu"])
    printed = capsys.readouterr().out
    assert "mean gap" in printed and "note: the pallas engine" in printed
    import pandas as pd

    def frame(run):
        (pkl,) = (tmp_path / run).iterdir()
        df = pd.read_pickle(pkl)
        assert {"instance", "time", "cost", "opt_cost", "best_cost", "gap", "dt"} <= set(df.columns)
        return df

    assert len(frame("runs")) == 3 * 2
    # the reference's default: a wall-clock budget, one trace row per accepted move
    tcli.main([split, npz, str(tmp_path / "wall"), "regret_pred", "--time_limit", "0.5",
               "--perturbation_moves", "5", "--device", "cpu"])
    assert "note:" not in capsys.readouterr().out
    df = frame("wall")
    assert len(df) >= 3 and (df.groupby("instance")["dt"].max() <= 60).all()
    tcli.main([split, npz, str(tmp_path / "xla"), "weight", "--n_iters", "2",
               "--engine", "xla", "--perturbation_moves", "5", "--device", "cpu"])
    assert len(frame("xla")) > 3 * 2  # per-move rows
    # the 10 s protocol, its tsp20 target scaled down to keep the calibration short
    monkeypatch.setitem(tev.REFERENCE_10S_MOVES, 20, 60.0)
    tcli.main([split, npz, str(tmp_path / "proto"), "weight", "--protocol_10s",
               "--device", "cpu"])
    assert "10s-protocol calibrated budget: n_iters=" in capsys.readouterr().out
    # a reference .pt checkpoint with params.json beside it
    model_dir = tmp_path / "pt"
    model_dir.mkdir()
    (model_dir / "params.json").symlink_to(ROOT / "models" / "tsp20" / "params.json")
    from gnngls_tpu_torch.models import torch_import

    torch.save({"model_state_dict": torch_import.state_dict_from_params(
        load_model(npz, RegretGNNConfig(), device="cpu")), "epoch": 1}, model_dir / "best.pt")
    tcli.main([split, str(model_dir / "best.pt"), str(tmp_path / "runs_pt"), "regret_pred",
               "--n_iters", "2", "--perturbation_moves", "5", "--device", "cpu"])
    pd.testing.assert_frame_equal(frame("runs_pt")[["instance", "cost", "gap"]],
                                  frame("runs")[["instance", "cost", "gap"]])
