"""The committed JAX fixture for the tsp100 main path, and its tier-1 check.

gnngls_tpu_torch/testdata/jax_tsp100_test64_it100.json holds gnngls_tpu's
CPU `evaluate` on data/tsp100 test instances 0-63 with the shipped
checkpoint, guide regret_pred, n_iters=100, perturbation_moves=20: per
instance the initial and best costs (f32 sums of D along the tours, as
`run_fixed_pallas` re-derives them) and the accepted moves.  `chip_smoke.py`
holds the port's run on the card against it.

The slow test writes it; the tier-1 test checks instances 0-1 against the JAX
package and feeds JAX's own predictions through the port's plain search.
"""

import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from gnngls_tpu import evaluate as jev
from gnngls_tpu.core.graph import edge_vector_to_matrix
from gnngls_tpu.data import dataset as jds
from gnngls_tpu.models import regret_gat as JM
from gnngls_tpu.train import checkpoint as jck
from gnngls_tpu_torch.search import batched as tb

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU: keep torch to one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
FIXTURE = ROOT / "gnngls_tpu_torch" / "testdata" / "jax_tsp100_test64_it100.json"
N_ITERS, PM = 100, 20
COMMAND = ("JAX_PLATFORMS=cpu python -m pytest "
           "tests/test_torch_fixture.py::test_write_jax_fixture -m slow")


def _jax_subset(k):
    full = jds.TSPDataset.from_npz(ROOT / "data/tsp100/instances.npz",
                                   ROOT / "data/tsp100/test.txt",
                                   scalers_file=ROOT / "data/tsp100/scalers.json")
    return dataclasses.replace(
        full, coords=full.coords[:k], features=full.features[:k],
        regret=full.regret[:k], in_solution=full.in_solution[:k],
        opt_cost=full.opt_cost[:k])


def _jax_model():
    cfg = JM.RegretGNNConfig()
    p_like, s_like = JM.init_params(jax.random.PRNGKey(0), cfg)
    params, bn, _, _ = jck.load_checkpoint(
        ROOT / "models/tsp100/checkpoint_best_val.npz",
        params_like=p_like, bn_state_like=s_like)
    return params, bn, cfg


def _f32_cost(D, tours):
    return D[np.arange(len(tours))[:, None], tours[:, :-1], tours[:, 1:]].sum(-1)


def _jax_eval(k):
    ds = _jax_subset(k)
    params, bn, cfg = _jax_model()
    out = jev.evaluate(ds, params=params, bn_state=bn, model_cfg=cfg,
                       guides=["regret_pred"], n_iters=N_ITERS,
                       perturbation_moves=PM)
    D = jev.coords_to_distance_matrix(ds.coords).astype(np.float32)
    best = _f32_cost(D, np.asarray(out["best_tours"]))
    return ds, out, best


@pytest.mark.slow
def test_write_jax_fixture():
    ds, out, best = _jax_eval(64)
    gaps = (best.astype(np.float64) / ds.opt_cost - 1.0) * 100.0
    doc = {
        "command": COMMAND,
        "what": "gnngls_tpu.evaluate on the CPU (XLA engine): data/tsp100 test "
                "instances 0-63, models/tsp100/checkpoint_best_val.npz, guide "
                "regret_pred, n_iters=100, perturbation_moves=20; costs are f32 "
                "sums of D along the tours",
        "instances": list(range(64)),
        "init_cost": [float(c) for c in out["init_costs"]],
        "best_cost": [float(c) for c in best],
        "moves": [int(m) for m in out["result"].trace_n],
        "mean_gap": float(gaps.mean()),
    }
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    FIXTURE.write_text(json.dumps(doc, indent=0) + "\n")
    assert FIXTURE.stat().st_size < 20_000


def test_fixture_matches_jax_and_port_search():
    fx = json.loads(FIXTURE.read_text())
    assert len(fx["best_cost"]) == 64 and fx["command"] == COMMAND
    k = 2
    ds, out, best = _jax_eval(k)
    np.testing.assert_array_equal(np.float32(fx["best_cost"][:k]), best)
    np.testing.assert_array_equal(fx["moves"][:k], out["result"].trace_n)
    np.testing.assert_array_equal(np.float32(fx["init_cost"][:k]),
                                  np.float32(out["init_costs"]))

    # JAX's own predictions through the port's plain search
    params, bn, cfg = _jax_model()
    preds = jev.predict_regret(params, bn, cfg, ds)
    R = edge_vector_to_matrix(preds.astype(np.float32), ds.n_nodes)
    D = jev.coords_to_distance_matrix(ds.coords).astype(np.float32)
    inits = tb.nearest_neighbor_batch(torch.as_tensor(R)).numpy()
    res = tb.run_fixed_kernel(D, R[:, None], inits, n_iters=N_ITERS,
                              perturbation_moves=PM, device="cpu")
    np.testing.assert_array_equal(res.chunk_moves[:, -1], fx["moves"][:k])
    np.testing.assert_array_equal(np.float32(res.best_costs),
                                  np.float32(fx["best_cost"][:k]))
