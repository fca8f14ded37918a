"""The large-n slice against gnngls_tpu on the CPU: the search past n=138,
the GLS oracle, instance generation, `from_arrays`, and the shipped model at
n=120, where both packages take the source-chunked partials (K3, gs=64).

The JAX side runs K3 as its own tests do on the CPU (Pallas interpret mode)
and the GLS oracle on its XLA engine, as it runs off the TPU.  Tolerances:
5e-4 per layer tap and on the predictions (benchmarks/PARITY.md's scale, as
tests/test_torch_gat.py holds n=100); the search is held move for move, a
best tour differing only where two tours tie in cost (ROADMAP section 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnngls_tpu import evaluate as jev
from gnngls_tpu.core.graph import build_topology as jtopology
from gnngls_tpu.core.scaler import load_scalers as jload_scalers
from gnngls_tpu.data import dataset as jds
from gnngls_tpu.data import generate as jgen
from gnngls_tpu.models import regret_gat as JM
from gnngls_tpu.ops.linear import linear as jlinear
from gnngls_tpu.ops.norm import batch_norm as jbatch_norm
from gnngls_tpu.ops.pallas_gat import gat_conv_pallas
from gnngls_tpu.search import batched as jbatched
from gnngls_tpu.train import checkpoint as jck
from gnngls_tpu.utils import is_valid_tour, tour_cost
from gnngls_tpu_torch import evaluate as tev
from gnngls_tpu_torch.core.scaler import load_scalers
from gnngls_tpu_torch.data import generate as tgen
from gnngls_tpu_torch.data import solvers as tsolvers
from gnngls_tpu_torch.data.dataset import TSPDataset
from gnngls_tpu_torch.models.convert import load_model
from gnngls_tpu_torch.models.regret_gat import RegretGNNConfig
from gnngls_tpu_torch.search import batched as tbatched
from gnngls_tpu_torch.utils import tour_to_edge_vector

from test_torch_gls import assert_best_match, instances

ROOT = __import__("pathlib").Path(__file__).resolve().parent.parent
SCALERS = ROOT / "models" / "tsp100" / "scalers.json"
CHECKPOINT = ROOT / "models" / "tsp100" / "checkpoint_best_val.npz"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU: keep torch to one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_plain_search_past_138_matches_jax():
    """K1's twin at n=150 against the JAX XLA engine: moves, traces, best tours."""
    n, B, iters, pm = 150, 2, 2, 6
    Ds = instances(n, B, 150)
    inits = tbatched.nearest_neighbor_batch(torch.as_tensor(Ds)).numpy()
    np.testing.assert_array_equal(
        inits, np.asarray(jbatched.nearest_neighbor_batch(jnp.asarray(Ds))))
    res = tbatched.run_fixed_kernel(Ds, Ds[:, None], inits, n_iters=iters,
                                    perturbation_moves=pm, device="cpu")
    ref = jbatched.run_fixed(Ds, Ds[:, None], inits, n_iters=iters, perturbation_moves=pm)
    np.testing.assert_array_equal(res.chunk_moves[:, -1], ref.trace_n)
    np.testing.assert_allclose(res.trace_costs[:, -1], ref.best_costs, rtol=2e-6)
    assert_best_match(n, Ds, res.best_tours, res.search_costs, ref.best_tours,
                      ref.best_costs)


def test_tour_to_edge_vector_matches_jax():
    from gnngls_tpu.utils import tour_to_edge_vector as jtour_to_edge_vector

    rng = np.random.default_rng(0)
    for n in (5, 17, 40):
        t = np.r_[0, 1 + rng.permutation(n - 1), 0]
        np.testing.assert_array_equal(tour_to_edge_vector(n, t), jtour_to_edge_vector(n, t))


def test_resolve_solver():
    """gnngls_tpu's rule, now that the exact solvers are ported: GLS past
    n=22, Held-Karp up to it (the native oracle builds here), a named solver
    as named; an unknown one is refused where the instances are solved."""
    assert tgen.resolve_solver(30) == tgen.resolve_solver(500, "gls") == "gls"
    assert tgen.resolve_solver(20) == jgen.resolve_solver(20) == "held_karp"
    for exact in ("held_karp", "concorde"):
        assert tgen.resolve_solver(30, exact) == jgen.resolve_solver(30, exact) == exact
    assert tgen.resolve_solver(30, "lkh") == "lkh"
    with pytest.raises(ValueError, match="unknown solver"):
        tgen.solve_instances(np.zeros((1, 30, 2), np.float32), "lkh")


def test_oracle_generator_and_from_arrays_match_jax(tmp_path):
    """n=30, 3 samples, seed 3, opt_iters 3: coordinates, features and
    in_solution bit-equal, tours equal, opt_cost within 1e-6 relative."""
    n, N = 30, 3
    want = jgen.generate_instances(N, n, seed=3, solver="gls", opt_iters=3)
    got = tgen.generate_instances(N, n, seed=3, solver="gls", opt_iters=3, device="cpu")
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["coords"], want["coords"])
    np.testing.assert_array_equal(got["opt_tour"], want["opt_tour"])
    np.testing.assert_array_equal(got["in_solution"], want["in_solution"])
    np.testing.assert_allclose(got["opt_cost"], want["opt_cost"], rtol=1e-6)
    assert got["opt_tour"].dtype == np.int32 and got["opt_cost"].dtype == np.float64
    assert str(got["solver"]) == "gls" and int(got["n_nodes"]) == n
    for t in got["opt_tour"]:
        assert is_valid_tour(n, t)

    D = jgen.coords_to_distance_matrix(want["coords"])
    tours, costs = tsolvers.gls_oracle(D, n_iters=3, device="cpu")
    np.testing.assert_array_equal(tours, want["opt_tour"])
    np.testing.assert_allclose(costs, [tour_cost(D[b], tours[b]) for b in range(N)],
                               rtol=1e-6)

    path = tmp_path / "tsp30.npz"
    tgen.save_dataset(path, got)
    for d in (want, tgen.load_dataset(path)):
        d = dict(d)
        d["regret"] = np.zeros_like(np.asarray(d["in_solution"], np.float32))
        mine = TSPDataset.from_arrays(d, [2, 0], scalers=load_scalers(SCALERS))
        theirs = jds.TSPDataset.from_arrays(d, [2, 0], scalers=jload_scalers(SCALERS))
        for key in ("coords", "features", "regret", "in_solution", "opt_cost"):
            np.testing.assert_array_equal(getattr(mine, key), getattr(theirs, key))
        np.testing.assert_array_equal(mine.get_scaled_batch([0, 1])["features"],
                                      theirs.get_scaled_batch([0, 1])["features"])


def _n120_arrays(B=1, n=120):
    coords = np.random.default_rng(3).random((B, n, 2)).astype(np.float32)
    E = n * (n - 1) // 2
    return {"coords": coords, "regret": np.zeros((B, E), np.float32),
            "in_solution": np.zeros((B, E), bool), "opt_cost": np.ones(B)}


def _jax_model():
    cfg = JM.RegretGNNConfig()
    p_like, s_like = JM.init_params(jax.random.PRNGKey(0), cfg)
    params, bn, _, _ = jck.load_checkpoint(CHECKPOINT, params_like=p_like, bn_state_like=s_like)
    return params, bn, cfg


def test_predict_regret_n120_matches_jax():
    """The shipped tsp100 model at n=120, where both take K3 with gs=64."""
    d = _n120_arrays()
    params, bn, cfg = _jax_model()
    want = jev.predict_regret(params, bn, cfg,
                              jds.TSPDataset.from_arrays(d, scalers=jload_scalers(SCALERS)),
                              gat_impl="pallas")
    got = tev.predict_regret(load_model(CHECKPOINT, RegretGNNConfig(), device="cpu"),
                             TSPDataset.from_arrays(d, scalers=load_scalers(SCALERS)),
                             device="cpu")
    assert got.shape == want.shape == (1, 120 * 119 // 2)
    assert float(np.abs(got - want).max()) <= 5e-4


def test_model_taps_n120_match_jax():
    """Per-layer taps at n=120 against gat_conv_pallas's chunked route."""
    d = _n120_arrays()
    x = TSPDataset.from_arrays(d, scalers=load_scalers(SCALERS)).get_scaled_batch([0])["features"]
    params, bn, cfg = _jax_model()
    topo = jtopology(120)

    @jax.jit
    def taps_of(x):
        h = jlinear(params.embed, x)
        taps = [h]
        for lp, ls in zip(params.layers, bn.layers):
            h = h + gat_conv_pallas(lp.gat, topo, h, cfg.n_heads, interpret=True)
            h, _ = jbatch_norm(lp.bn1, ls.bn1, h, False)
            h = h + jlinear(lp.ffn2, jax.nn.relu(jlinear(lp.ffn1, h)))
            h, _ = jbatch_norm(lp.bn2, ls.bn2, h, False)
            taps.append(h)
        return taps, jlinear(params.decision, h)

    taps, y_j = taps_of(jnp.asarray(x))
    mine = []
    with torch.no_grad():
        y = load_model(CHECKPOINT, RegretGNNConfig(), device="cpu")(torch.as_tensor(x),
                                                                     taps=mine).numpy()
    assert len(mine) == len(taps) == 9
    for i, (a, b) in enumerate(zip(mine, taps)):
        err = float(np.abs(a.numpy() - np.asarray(b)).max())
        assert err <= 5e-4, f"tap {i} max abs err {err:.2e}"
    assert float(np.abs(y - np.asarray(y_j)).max()) <= 5e-4
