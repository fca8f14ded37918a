"""The committed JAX fixture for the large-n path at n=200, and its tier-1 check.

gnngls_tpu_torch/testdata/jax_tsp200_seed3.npz holds, for the first two
instances of `np.random.default_rng(3).random((2, 200, 2))`:
  * gnngls_tpu's `predict_regret(gat_impl="pallas")` with the shipped tsp100
    checkpoint and scalers: at n=200 that takes the source-chunked partials
    (K3, gs=40, K=5), run on the CPU in interpret mode;
  * the JAX XLA engine's fixed-budget GLS guided by those predictions
    (nearest-neighbour start on them, n_iters=10, perturbation_moves=20): the
    initial and best costs (f32 sums of D along the tours) and accepted moves.
`chip_smoke.py` holds the port's run on the card against it.

The slow test writes it; the tier-1 test checks the port's plain search on
the fixture's predictions against it.  The port's forward at n=200 is held
against the fixture on the card (`chip_smoke.py`): its plain twin takes about
40 s on one CPU thread, and tests/test_torch_large_n.py already holds K3's
twin against JAX at n=120 on the same checkpoint.
"""

import pathlib

import jax
import numpy as np
import pytest
import torch

from gnngls_tpu import evaluate as jev
from gnngls_tpu.core.graph import edge_vector_to_matrix
from gnngls_tpu.core.scaler import load_scalers as jload_scalers
from gnngls_tpu.data import dataset as jds
from gnngls_tpu.models import regret_gat as JM
from gnngls_tpu.search import batched as jbatched
from gnngls_tpu.train import checkpoint as jck
from gnngls_tpu_torch.search import batched as tbatched

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "gnngls_tpu_torch" / "testdata" / "jax_tsp200_seed3.npz"
SCALERS = ROOT / "models" / "tsp100" / "scalers.json"
CHECKPOINT = ROOT / "models" / "tsp100" / "checkpoint_best_val.npz"
N, B, SEED, N_ITERS, PM = 200, 2, 3, 10, 20
COMMAND = ("JAX_PLATFORMS=cpu python -m pytest "
           "tests/test_torch_fixture_n200.py::test_write_jax_fixture_n200 -m slow")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU: keep torch to one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def arrays() -> dict:
    """The fixture's instances as a dataset dict, regret and in_solution zero."""
    coords = np.random.default_rng(SEED).random((B, N, 2)).astype(np.float32)
    E = N * (N - 1) // 2
    return {"coords": coords, "regret": np.zeros((B, E), np.float32),
            "in_solution": np.zeros((B, E), bool), "opt_cost": np.ones(B)}


def _f32_cost(D, tours):
    return D[np.arange(len(tours))[:, None], tours[:, :-1], tours[:, 1:]].sum(-1)


@pytest.mark.slow
def test_write_jax_fixture_n200():
    d = arrays()
    cfg = JM.RegretGNNConfig()
    p_like, s_like = JM.init_params(jax.random.PRNGKey(0), cfg)
    params, bn, _, _ = jck.load_checkpoint(CHECKPOINT, params_like=p_like, bn_state_like=s_like)
    ds = jds.TSPDataset.from_arrays(d, scalers=jload_scalers(SCALERS))
    pred = jev.predict_regret(params, bn, cfg, ds, batch_size=B,
                              gat_impl="pallas").astype(np.float32)
    R = edge_vector_to_matrix(pred, N)
    D = jev.coords_to_distance_matrix(d["coords"]).astype(np.float32)
    inits = np.asarray(jbatched.nearest_neighbor_batch(jax.numpy.asarray(R)))
    res = jbatched.run_fixed(D, R[:, None], inits, n_iters=N_ITERS, perturbation_moves=PM)
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        FIXTURE, command=np.array(COMMAND),
        what=np.array("gnngls_tpu on the CPU: predict_regret(gat_impl='pallas') with "
                      "models/tsp100 on default_rng(3) n=200 instances 0-1 (K3, gs=40), "
                      "then the XLA engine's GLS on those predictions, nearest-neighbour "
                      f"start, n_iters={N_ITERS}, perturbation_moves={PM}; costs are f32 "
                      "sums of D along the tours"),
        coords=d["coords"], pred=pred, n_iters=N_ITERS, perturbation_moves=PM,
        init_cost=_f32_cost(D, inits), best_cost=_f32_cost(D, np.asarray(res.best_tours)),
        moves=np.asarray(res.trace_n))
    assert FIXTURE.stat().st_size < 500_000


def test_fixture_n200_matches_port_plain_search():
    """The port's plain search on JAX's own predictions gives the fixture's
    initial costs, moves and best costs."""
    fx = np.load(FIXTURE)
    assert str(fx["command"]) == COMMAND
    d = arrays()
    np.testing.assert_array_equal(fx["coords"], d["coords"])
    assert fx["pred"].shape == (B, N * (N - 1) // 2) and (fx["pred"] >= 0).all()
    R = edge_vector_to_matrix(fx["pred"], N)
    D = jev.coords_to_distance_matrix(d["coords"]).astype(np.float32)
    inits = tbatched.nearest_neighbor_batch(torch.as_tensor(R)).numpy()
    np.testing.assert_array_equal(np.float32(_f32_cost(D, inits)), fx["init_cost"])
    res = tbatched.run_fixed_kernel(D, R[:, None], inits, n_iters=int(fx["n_iters"]),
                                    perturbation_moves=int(fx["perturbation_moves"]),
                                    device="cpu")
    np.testing.assert_array_equal(res.chunk_moves[:, -1], fx["moves"])
    np.testing.assert_array_equal(np.float32(res.best_costs), fx["best_cost"])
